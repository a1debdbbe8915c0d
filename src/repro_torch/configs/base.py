"""Architecture / run configuration schema (a copy of ``repro.configs.base``).

One ``ModelConfig`` per assigned architecture lives in
``src/repro_torch/configs/<id>.py``; the shape grid (train_4k / prefill_32k /
decode_32k / long_500k) is shared by all LM-family archs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int  # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts
    first_dense_layers: int = 0  # leading dense layers (deepseek-v2 style)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int  # N
    head_dim: int = 64  # P
    expand: int = 2  # d_inner = expand * d_model
    chunk: int = 256  # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    context: int  # encoder sequence length (e.g. 1500 audio frames)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | enc_dec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0  # fraction of head_dim rotated (chatglm: 0.5)
    window: Optional[int] = None  # sliding-window size (None = full)
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # vlm: one cross-attention layer every `cross_attn_every` layers
    cross_attn_every: Optional[int] = None
    cross_context: int = 0  # image/audio token count for cross-attn
    frontend: Optional[str] = None  # "audio" | "vision" stub
    # misc
    act: str = "silu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # whether this arch supports sub-quadratic 500k-token decode
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def padded_vocab(self, multiple: int = 16) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def approx_params(self) -> int:
        """Rough dense-equivalent parameter count (used for MODEL_FLOPS)."""
        from repro_torch.models.lm import LMModel  # local import to avoid cycle

        return LMModel(self).param_count()


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(config: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable?, reason) for an (arch x shape) cell -- DESIGN.md section 5."""
    if shape.name == "long_500k" and not config.subquadratic:
        return False, "full-attention arch: 500k-token decode skipped (DESIGN.md §5)"
    return True, ""
