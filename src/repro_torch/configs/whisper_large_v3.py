"""whisper-large-v3 [audio]: encoder-decoder, conv frontend STUB (precomputed
1500 mel-frame embeddings). 32 enc + 32 dec layers. [arXiv:2212.04356]"""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="enc_dec",
    n_layers=32,  # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    act="gelu",
    encoder=EncoderConfig(n_layers=32, context=1500),
    frontend="audio",
)
