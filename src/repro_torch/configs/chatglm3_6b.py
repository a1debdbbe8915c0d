"""chatglm3-6b [dense]: partial (2D) RoPE, 2 KV heads. [arXiv:2406.12793]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,  # ChatGLM rotates half the head dim
)
