"""LMModel: the serving interface over the ported architectures.

The port of ``repro.models.lm`` for the ``dense``, ``moe``, ``ssm`` and
``hybrid`` families: token embedding, the segments, final norm + LM head,
full-sequence ``apply``, ``prefill`` returning a cache of stacked per-layer
leaves, and a single-token ``decode_step``.  Parameters are a nested dict of tensors with
the reference's names and shapes (:meth:`LMModel.param_specs`); weights made
by the reference carry over with :func:`repro_torch.models.convert.from_reference`.

A ``moe`` model's MoE layers run the single-device dispatch path, as the
reference's serve does on a ``1x1`` mesh.  MLA attention (ROADMAP A.4b) and
the ``vlm`` and ``enc_dec`` families (A.4c) are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import ParamSpec, init_params
from repro_torch.models.sharding import param_count as _pc
from repro_torch.models.transformer import Block, Segment

#: families the port runs
FAMILIES = ("dense", "moe", "ssm", "hybrid")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class LMModel:
    cfg: ModelConfig
    tp: int = 1  # tensor-parallel size (for head padding); 1 = exact arch

    def __post_init__(self) -> None:
        cfg = self.cfg
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet (ROADMAP A.4c); "
                f"the port runs {FAMILIES}"
            )
        if cfg.mla is not None:
            raise NotImplementedError(f"{cfg.name}: MLA attention is not ported yet (ROADMAP A.4b)")
        self.dtype = _DTYPES[cfg.dtype]
        self.vocab = cfg.padded_vocab(max(self.tp, 16))
        self.segments: List[Segment] = self._build_segments()

    def _build_segments(self) -> List[Segment]:
        cfg, tp = self.cfg, self.tp
        if cfg.family == "moe":
            fd = cfg.moe.first_dense_layers
            segs = [Segment("dense0", Block.make(cfg, "dense", tp), fd)] if fd else []
            return segs + [Segment("moe", Block.make(cfg, "dense", tp, use_moe=True), cfg.n_layers - fd)]
        # the family is also the block kind; the names are the reference's
        name = {"dense": "dec", "ssm": "ssm", "hybrid": "hyb"}[cfg.family]
        return [Segment(name, Block.make(cfg, cfg.family, tp), cfg.n_layers)]

    @property
    def attention_head_dim(self):
        """Head width of the attention layers, ``None`` where there are none."""
        return None if self.cfg.family == "ssm" else self.cfg.resolved_head_dim

    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        p: Dict[str, Any] = {
            "embed": ParamSpec((self.vocab, cfg.d_model), ("vocab", "fsdp")),
            "final_norm": L.rmsnorm_params(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = ParamSpec((cfg.d_model, self.vocab), ("fsdp", "vocab"))
        for s in self.segments:
            p[f"seg_{s.name}"] = s.params()
        return p

    def init(self, gen: torch.Generator, dtype=None, device=None) -> dict:
        """Random parameters drawn from ``gen`` (which lives on ``device``):
        matrices in ``dtype`` (default: the config's), norm scales and the
        SSM's ``a_log``/``dt_bias``/``d_skip`` in float32."""
        return init_params(self.param_specs(), gen, dtype or self.dtype, device or gen.device)

    def param_count(self) -> int:
        return _pc(self.param_specs())

    # ------------------------------------------------------------------
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(self.dtype)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return x @ w.to(x.dtype)

    @staticmethod
    def _positions(S: int, device) -> torch.Tensor:
        return torch.arange(S, device=device)[None, :]

    def apply(self, params, tokens, impl: str = "dot"):
        """Full-sequence logits [B, S, vocab]."""
        positions = self._positions(tokens.shape[1], tokens.device)
        x = self._embed(params, tokens)
        for s in self.segments:
            x = s.apply(params[f"seg_{s.name}"], x, positions, impl=impl)
        return self._head(params, x)

    def prefill(self, params, tokens, impl: str = "chunked"):
        """Returns (last-position logits [B, 1, vocab], cache tree)."""
        positions = self._positions(tokens.shape[1], tokens.device)
        x = self._embed(params, tokens)
        caches = {}
        for s in self.segments:
            x, caches[f"seg_{s.name}"] = s.prefill(params[f"seg_{s.name}"], x, positions, impl=impl)
        return self._head(params, x[:, -1:]), caches

    def decode_step(self, params, token, caches, pos: int):
        """One token for every sequence. token: [B, 1] int64; pos: int.

        The attention caches are updated in place (see ``Segment.decode``).
        """
        positions = torch.full((token.shape[0], 1), pos, dtype=torch.int64, device=token.device)
        x = self._embed(params, token)
        new_caches = {}
        for s in self.segments:
            x, new_caches[f"seg_{s.name}"] = s.decode(
                params[f"seg_{s.name}"], x, positions, caches[f"seg_{s.name}"], pos
            )
        return self._head(params, x), new_caches

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        dtype = dtype or self.dtype
        return {
            f"seg_{s.name}": s.init_cache(batch, max_len, dtype, device)
            for s in self.segments
        }

    def ctx_len(self) -> int:
        """Length of a cross-attention context: 0 for every ported family."""
        return 0
