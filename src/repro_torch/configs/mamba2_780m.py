"""mamba2-780m [ssm]: attention-free SSD (state-space duality); O(1)-state
decode -> runs the 500k shape. [arXiv:2405.21060]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,  # attention-free
    n_kv_heads=1,
    d_ff=0,  # no MLP blocks
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=128),
    subquadratic=True,
)
