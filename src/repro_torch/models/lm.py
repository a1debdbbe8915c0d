"""LMModel: the train / serve interface over every architecture of the reference.

The port of ``repro.models.lm`` for all six families (``dense``, ``moe``,
``ssm``, ``hybrid``, ``vlm``, ``enc_dec``): token embedding, the segments,
final norm + LM head, full-sequence ``apply`` and the training ``loss``,
``prefill`` returning a cache of stacked per-layer leaves, and a
single-token ``decode_step``.  Parameters are a nested dict of tensors with
the reference's names and shapes
(:meth:`LMModel.param_specs`); weights made by the reference carry over with
:func:`repro_torch.models.convert.from_reference`.

A ``moe`` model's MoE layers run the single-device dispatch path, as the
reference's serve does on a ``1x1`` mesh; deepseek-v2-lite's attention is
MLA (:mod:`repro_torch.models.mla`).  Modality frontends are stubs, as in
the reference: ``[audio]`` / ``[vlm]`` inputs arrive as precomputed
frame/patch embeddings (``ctx_emb [B, ctx_len, d_model]``) and pass through
a linear adapter, then, for ``enc_dec``, through the encoder.  The ``vlm``
layout keeps the reference's approximation: its cross-attention layers run
as one segment after the self-attention layers (``[selfs..., crosses...]``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import ParamSpec, init_params
from repro_torch.models.sharding import param_count as _pc
from repro_torch.models.transformer import Block, Segment

#: families the port runs: every family of the reference
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "enc_dec")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class LMModel:
    cfg: ModelConfig
    tp: int = 1  # tensor-parallel size (for head padding); 1 = exact arch

    def __post_init__(self) -> None:
        cfg = self.cfg
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); the families are {FAMILIES}")
        self.dtype = _DTYPES[cfg.dtype]
        self.vocab = cfg.padded_vocab(max(self.tp, 16))
        self.segments: List[Segment] = self._build_segments()
        self.enc_segments: List[Segment] = self._build_encoder()

    def _build_segments(self) -> List[Segment]:
        cfg, tp = self.cfg, self.tp
        if cfg.family == "moe":
            fd = cfg.moe.first_dense_layers
            segs = [Segment("dense0", Block.make(cfg, "dense", tp), fd)] if fd else []
            return segs + [Segment("moe", Block.make(cfg, "dense", tp, use_moe=True), cfg.n_layers - fd)]
        if cfg.family == "vlm":
            # cross layers hoisted into their own segment after the selfs
            # (the reference's approximation of the interleaving)
            n_cross = cfg.n_layers // cfg.cross_attn_every
            return [Segment("self", Block.make(cfg, "dense", tp), cfg.n_layers - n_cross),
                    Segment("cross", Block.make(cfg, "cross", tp), n_cross)]
        # the block kind and the segment's name, the reference's
        kind, name = {"dense": ("dense", "dec"), "ssm": ("ssm", "ssm"), "hybrid": ("hybrid", "hyb"),
                      "enc_dec": ("decoder", "dec")}[cfg.family]
        return [Segment(name, Block.make(cfg, kind, tp), cfg.n_layers)]

    def _build_encoder(self) -> List[Segment]:
        cfg = self.cfg
        if cfg.family != "enc_dec" or cfg.encoder is None:
            return []
        return [Segment("enc", Block.make(cfg, "encoder", self.tp), cfg.encoder.n_layers)]

    @property
    def attention_head_pairs(self) -> frozenset:
        """(q/k width, v width) of every attention that a kernel-route
        prefill sends to B3 (self, cross, encoder, MLA); empty where there
        is none."""
        pairs = set()
        for s in self.segments + self.enc_segments:
            if s.count:
                pairs |= s.block.attention_pairs()
        return frozenset(pairs)

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
        for s in self.enc_segments:
            p[f"enc_{s.name}"] = s.params()
        if cfg.frontend or cfg.family == "enc_dec":
            p["adapter"] = ParamSpec((cfg.d_model, cfg.d_model), ("fsdp", None))
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
        # F.embedding, not indexing: its backward sums repeated tokens in a
        # fixed order (indexing's accumulates across CPU threads in any order)
        return torch.nn.functional.embedding(tokens, params["embed"]).to(self.dtype)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return x @ w.to(x.dtype)

    @staticmethod
    def _positions(S: int, device) -> torch.Tensor:
        return torch.arange(S, device=device)[None, :]

    def _context(self, params, ctx_emb, impl: str, remat: bool) -> Optional[torch.Tensor]:
        """The frontend adapter (then the encoder, for ``enc_dec``) over the
        stub embeddings ``ctx_emb [B, ctx_len, d_model]``; ``None`` without."""
        if ctx_emb is None:
            return None
        ctx = ctx_emb.to(self.dtype) @ params["adapter"].to(self.dtype)
        if self.enc_segments:
            epos = self._positions(ctx.shape[1], ctx.device)
            for s in self.enc_segments:
                ctx = s.apply(params[f"enc_{s.name}"], ctx, epos, impl=impl, remat=remat)
        return ctx

    def apply(self, params, tokens, ctx_emb=None, impl: str = "dot", remat: bool = True):
        """Full-sequence logits [B, S, vocab] (training / eval).  ``remat``
        recomputes each layer in the backward (``Segment.apply``); without
        autograd it changes nothing."""
        positions = self._positions(tokens.shape[1], tokens.device)
        x = self._embed(params, tokens)
        ctx = self._context(params, ctx_emb, impl, remat)
        for s in self.segments:
            x = s.apply(params[f"seg_{s.name}"], x, positions, impl=impl, ctx=ctx, remat=remat)
        return self._head(params, x)

    def loss(self, params, batch: dict, impl: str = "dot", remat: bool = True) -> torch.Tensor:
        """Mean next-token cross-entropy in float32. batch: tokens/labels
        [B, S] (+ ``ctx`` stub embeddings for vlm / enc_dec)."""
        logits = self.apply(params, batch["tokens"], batch.get("ctx"), impl=impl, remat=remat).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
        return (logz - gold).mean()

    def prefill(self, params, tokens, ctx_emb=None, impl: str = "chunked"):
        """Returns (last-position logits [B, 1, vocab], cache tree)."""
        positions = self._positions(tokens.shape[1], tokens.device)
        x = self._embed(params, tokens)
        ctx = self._context(params, ctx_emb, impl, remat=False)
        caches = {}
        for s in self.segments:
            x, caches[f"seg_{s.name}"] = s.prefill(params[f"seg_{s.name}"], x, positions, impl=impl, ctx=ctx)
        return self._head(params, x[:, -1:]), caches

    def decode_step(self, params, token, caches, pos: int, ctx_emb=None):
        """One token for every sequence. token: [B, 1] int64; pos: int.

        The attention and latent caches are updated in place (see
        ``Segment.decode``); cross-attention reads the K/V the prefill
        cached, so ``ctx_emb`` is not used (the reference's signature).
        """
        del ctx_emb
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
        ctx_len = self.ctx_len()
        return {
            f"seg_{s.name}": s.init_cache(batch, max_len, dtype, device, ctx_len)
            for s in self.segments
        }

    def ctx_len(self) -> int:
        """Length of the cross-attention context: the encoder's frames for
        ``enc_dec``, the image tokens for ``vlm``, else 0."""
        cfg = self.cfg
        if cfg.family == "enc_dec" and cfg.encoder:
            return cfg.encoder.context
        return cfg.cross_context or 0
