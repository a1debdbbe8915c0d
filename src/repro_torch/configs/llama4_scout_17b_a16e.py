"""llama4-scout-17b-16e [moe]: 16 experts top-1, early fusion (text-only
backbone here). [hf:meta-llama/Llama-4-Scout-17B-16E]"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
)
