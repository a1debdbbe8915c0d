"""deepseek-v2-lite-16b [moe]: MLA (kv_lora 512) + MoE, 64 routed experts
top-6 + 2 shared, expert d_ff 1408, first layer dense. [arXiv:2405.04434]"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # expert width; dense layer uses 4x
    vocab_size=102400,
    head_dim=192,  # nope 128 + rope 64
    moe=MoEConfig(
        n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, first_dense_layers=1
    ),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
)
