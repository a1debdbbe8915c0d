"""llama-3.2-vision-90b [vlm]: 100L decoder with cross-attention image layers
every 5th layer; vision frontend STUB (precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-90B-Vision]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    cross_attn_every=5,
    cross_context=1600,
    frontend="vision",
)
