"""hymba-1.5b [hybrid]: parallel attention + Mamba heads, sliding-window
attention -> runnable at 500k decode. [arXiv:2411.13676; hf]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    window=2048,  # SWA on all layers (global layers approximated; DESIGN §5)
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, chunk=128),
    subquadratic=True,
)
