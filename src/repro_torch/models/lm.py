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

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import (
    ParamSpec,
    block_index,
    constrain,
    gather_fsdp,
    init_params,
    mesh_size,
    rules_for_mesh,
    whole_dim,
)
from repro_torch.models.sharding import param_count as _pc
from repro_torch.models.transformer import Block, Segment

#: families the port runs: every family of the reference
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "enc_dec")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def on_mesh(mesh):
    """The scope a sharded call runs in: plain tensors made inside it
    (positions, masks, zero-filled buffers, the same on every chip) count as
    replicated DTensors.  A null context with no mesh or on one device."""
    if mesh is None or mesh_size(mesh) == 1:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _rows_only(table: torch.Tensor) -> torch.Tensor:
    """The embedding table gathered on every dim but its vocab rows.

    The port's repair of the reference's embedding gather under a mesh
    (ROADMAP caveat 3).  A lookup in a vocab-sharded table leaves each chip
    the rows it owns and zeros elsewhere (a masked partial sum).  DTensor
    records the mask from the token ids as given, so if it also redistributes
    the ids or the table for the lookup, the mask no longer fits the result
    and the reduction fails.  With the table sharded on its rows alone and
    the ids batch-sharded, the lookup needs no redistribution;
    :func:`_reduce_partial` then takes the sum.
    """
    if not isinstance(table, DTensor):
        return table
    return table.redistribute(table.device_mesh, [p if p.is_shard(0) else Replicate() for p in table.placements])


def _logz_on_mesh(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim of vocab-sharded DTensor logits: each
    chip's max and sum of exponentials, reduced across chips by explicit
    redistributions, never the whole row.  Left to the ops that need them,
    the reductions took a wrong gradient on the way back in torch 2.11's
    DTensor (a ``logsumexp``'s gradient 4x on a 2 x 2 mesh)."""
    top = _reduce_partial(logits.detach().amax(dim=-1, keepdim=True))
    total = _reduce_partial(torch.exp(logits - top).sum(dim=-1, keepdim=True))
    return (top + total.log())[..., 0]


def _gold_on_mesh(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` of vocab-sharded DTensor logits: each chip picks
    the labels in its block of the vocabulary, zero elsewhere, and the sum
    over the vocab shards is left pending.  ``torch.gather`` on the DTensor
    would differentiate into a zero tensor of the logits' whole global shape
    on every chip."""
    from torch.distributed.tensor.experimental import local_map

    mesh, place = logits.device_mesh, list(logits.placements)
    vocab = [i for i, p in enumerate(place) if p.is_shard(logits.ndim - 1)]
    label_place = [Replicate() if i in vocab else p for i, p in enumerate(place)]
    out_place = [Partial() if i in vocab else p for i, p in enumerate(place)]

    def local(lg, lb):
        V = lg.shape[-1]
        idx = lb - block_index(mesh, place, logits.ndim - 1) * V
        hit = (idx >= 0) & (idx < V)
        got = torch.gather(lg, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
        return torch.where(hit, got, torch.zeros((), dtype=got.dtype, device=got.device))

    return local_map(local, out_placements=out_place, in_placements=(place, label_place),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)


def _reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every pending sum over a mesh dimension taken (an all-reduce)."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])


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
    def _c(self, x, mesh, logical):
        """Anchor an activation boundary to its canonical sharding, as the
        reference anchors GSPMD's propagation; ``x`` itself with no mesh."""
        if mesh is None:
            return x
        return constrain(x, mesh, rules_for_mesh(mesh), logical)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding, not indexing: its backward sums repeated tokens in a
        # fixed order (indexing's accumulates across CPU threads in any order)
        return _reduce_partial(torch.nn.functional.embedding(tokens, _rows_only(params["embed"]))).to(self.dtype)

    def _head(self, params, x: torch.Tensor, mesh=None) -> torch.Tensor:
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        w = gather_fsdp({name: params[name]}, {name: self.param_specs()[name]}, mesh)[name]
        w = w.T if self.cfg.tie_embeddings else w
        return L.dot(x, w.to(x.dtype))

    @staticmethod
    def _positions(S: int, device) -> torch.Tensor:
        return torch.arange(S, device=device)[None, :]

    def _context(self, params, ctx_emb, impl: str, remat: bool, mesh=None) -> Optional[torch.Tensor]:
        """The frontend adapter (then the encoder, for ``enc_dec``) over the
        stub embeddings ``ctx_emb [B, ctx_len, d_model]``; ``None`` without."""
        if ctx_emb is None:
            return None
        adapter = gather_fsdp({"adapter": params["adapter"]}, {"adapter": self.param_specs()["adapter"]}, mesh)
        ctx = L.dot(ctx_emb.to(self.dtype), adapter["adapter"].to(self.dtype))
        if self.enc_segments:
            epos = self._positions(ctx.shape[1], ctx.device)
            for s in self.enc_segments:
                ctx = s.apply(params[f"enc_{s.name}"], ctx, epos, impl=impl, remat=remat, mesh=mesh)
        return ctx

    def apply(self, params, tokens, ctx_emb=None, impl: str = "dot", remat: bool = True, mesh=None):
        """Full-sequence logits [B, S, vocab] (training / eval).  ``remat``
        recomputes each layer in the backward (``Segment.apply``); without
        autograd it changes nothing.  ``mesh``: the parameters and inputs are
        DTensors on it (:mod:`repro_torch.models.sharding`)."""
        with on_mesh(mesh):
            positions = self._positions(tokens.shape[1], tokens.device)
            x = self._c(self._embed(params, tokens), mesh, ("batch", "seq_sp", "embed"))
            ctx = self._context(params, ctx_emb, impl, remat, mesh)
            for s in self.segments:
                x = s.apply(params[f"seg_{s.name}"], x, positions, impl=impl, ctx=ctx, remat=remat, mesh=mesh)
                x = self._c(x, mesh, ("batch", "seq_sp", "embed"))
            return self._c(self._head(params, x, mesh), mesh, ("batch", None, "vocab"))

    def loss(self, params, batch: dict, impl: str = "dot", remat: bool = True, mesh=None) -> torch.Tensor:
        """Mean next-token cross-entropy in float32. batch: tokens/labels
        [B, S] (+ ``ctx`` stub embeddings for vlm / enc_dec)."""
        logits = self.apply(params, batch["tokens"], batch.get("ctx"), impl=impl, remat=remat, mesh=mesh).float()
        if mesh is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
            return (logz - gold).mean()
        with on_mesh(mesh):
            logz = _logz_on_mesh(logits)
            return (logz - _gold_on_mesh(logits, batch["labels"])).mean()

    def prefill(self, params, tokens, ctx_emb=None, impl: str = "chunked", mesh=None):
        """Returns (last-position logits [B, 1, vocab], cache tree)."""
        with on_mesh(mesh):
            positions = self._positions(tokens.shape[1], tokens.device)
            x = self._c(self._embed(params, tokens), mesh, ("batch", "seq_sp", "embed"))
            ctx = self._context(params, ctx_emb, impl, False, mesh)
            caches = {}
            for s in self.segments:
                x, caches[f"seg_{s.name}"] = s.prefill(params[f"seg_{s.name}"], x, positions, impl=impl,
                                                       ctx=ctx, mesh=mesh)
                x = self._c(x, mesh, ("batch", "seq_sp", "embed"))
            return self._head(params, x[:, -1:], mesh), caches

    def decode_step(self, params, token, caches, pos: int, ctx_emb=None, mesh=None):
        """One token for every sequence. token: [B, 1] int64; pos: int.

        The attention and latent caches are updated in place (see
        ``Segment.decode``); cross-attention reads the K/V the prefill
        cached, so ``ctx_emb`` is not used (the reference's signature).
        """
        del ctx_emb
        with on_mesh(mesh):
            positions = torch.full((token.shape[0], 1), pos, dtype=torch.int64, device=token.device)
            x = self._c(self._embed(params, token), mesh, ("batch", None, "embed"))
            new_caches = {}
            for s in self.segments:
                x, new_caches[f"seg_{s.name}"] = s.decode(
                    params[f"seg_{s.name}"], x, positions, caches[f"seg_{s.name}"], pos, mesh=mesh
                )
                x = self._c(x, mesh, ("batch", "seq_sp", "embed"))
            return self._head(params, x, mesh), new_caches

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
