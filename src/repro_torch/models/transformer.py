"""Transformer blocks and stacked segments.

The port of ``repro.models.transformer``, every block kind of the reference:

* ``dense``   -- self-attention (GQA, or MLA where the config has one) + MLP,
  or + MoE (``use_moe``)
* ``ssm``     -- Mamba-2 mixer only
* ``hybrid``  -- parallel attention + SSM heads (Hymba), then MLP
* ``cross``   -- cross-attention to a fixed context (the VLM's image layers)
  + MLP
* ``decoder`` -- self-attention + cross-attention + MLP (encoder-decoder)
* ``encoder`` -- bidirectional self-attention + MLP

A model is a sequence of **segments**; each segment is ``count`` copies of
one block with **stacked** ``[count, ...]`` parameters and cache leaves, as
in the reference.  Where the reference scans the layers with ``lax.scan``,
the port runs a Python loop over the stacked leaves, so weights carry over
one to one; a training ``apply`` recomputes each layer in the backward
(``torch.utils.checkpoint`` under ``REPRO_REMAT_POLICY``), where the
reference wraps its scan body in ``jax.checkpoint``.  Every block
implements ``apply`` (full sequence), ``prefill`` (full sequence, returns
its cache slice) and ``decode`` (one token + cache).

Departure from the reference: ``Block._mix`` hands ``impl="kernel"`` through
to the Mamba-2 mixer, so the kernel route of a prefill runs the SSD kernel B4.
The reference's ``Block._mix`` passes ``impl="chunked"`` whatever it was given
(``src/repro/models/transformer.py:285``), so its ``LMModel`` never reaches
its own Pallas SSD kernel.  The two compute the same function: the
reference's tests hold the Pallas kernel to ``ssd_chunked`` within 2e-4
(``tests/test_kernels.py``).  Every other ``impl`` runs the plain chunked SSD,
as the reference does.

Cross-attention keys and values come from the context (``ctx``: the adapted
frontend embeddings, run through the encoder for ``enc_dec``); the prefill
caches them per layer and decode reads them, never re-emitting them.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import Mamba2Mixer
from repro_torch.models.mla import MLAttention
from repro_torch.models.moe import MoELayer
from repro_torch.models.sharding import (
    ParamSpec,
    block_index,
    constrain,
    gather_fsdp,
    rules_for_mesh,
    tree_map,
    whole_dim,
)

#: block kinds (the reference's)
BLOCK_KINDS = ("dense", "ssm", "hybrid", "cross", "decoder", "encoder")


def pad_heads(n_heads: int, n_kv: int, tp: int) -> Tuple[int, int]:
    """Pad (q heads, kv heads) so q % tp == 0 and q % kv == 0."""
    hp = -(-n_heads // tp) * tp
    kv = n_kv
    while hp % kv:
        kv += 1
    return hp, kv


def kv_store_heads(kv: int, tp: int) -> int:
    """KV heads as stored in the decode cache: the true (grouping-padded)
    count; the reference shards the cache on its sequence dim instead of
    repeating heads up to the TP size."""
    del tp
    return kv


# ---------------------------------------------------------------------------
# Attention with cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CachedAttention:
    """GQA attention + ring/linear KV cache."""

    attn: L.AttentionLayer
    kv_store: int  # stored (possibly repeated) kv heads
    window: Optional[int] = None

    def params(self) -> dict:
        return self.attn.params()

    def _store(self, k: torch.Tensor) -> torch.Tensor:
        rep = self.kv_store // k.shape[-2]
        return k.repeat_interleave(rep, dim=-2) if rep > 1 else k

    def prefill(self, params, x, positions, impl):
        q, k, v = self.attn.qkv(params, x, positions)
        o = L.attend(q, k, v, impl=impl, causal=True, window=self.window)
        out = self.attn.out(params, o)
        ks, vs = self._store(k), self._store(v)
        if self.window is not None:
            W = self.window
            S = ks.shape[1]
            if S >= W:
                # ring holds the last W keys at slot = pos % W: the last W
                # rotated by (S - W) % W (slices and a cat, which DTensor shards)
                r = (S - W) % W
                ks = torch.cat([ks[:, S - r:], ks[:, S - W:S - r]], dim=1)
                vs = torch.cat([vs[:, S - r:], vs[:, S - W:S - r]], dim=1)
            else:
                # zeros after the prompt, as a cat (on a mesh, torch 2.11's
                # DTensor cannot plan the sharding of a pad)
                ks = torch.cat([ks, ks.new_zeros((ks.shape[0], W - S, *ks.shape[2:]))], dim=1)
                vs = torch.cat([vs, vs.new_zeros((vs.shape[0], W - S, *vs.shape[2:]))], dim=1)
        return out, {"k": ks, "v": vs}

    def decode(self, params, x, positions, cache, pos: int):
        """Single-token decode WITHOUT touching the cache tensors: attention
        runs over the existing entries (masked to ``< pos``) plus the current
        token's K/V as an explicit extra term; :meth:`Segment.decode` appends
        the new entries once per step after every layer has run."""
        q, k, v = self.attn.qkv(params, x, positions)  # S == 1
        k, v = self._store(k), self._store(v)
        ks, vs = (_decode_layout(cache[n], ("batch", "cache_seq", None, None)) for n in ("k", "v"))
        if self.window is not None:
            W = self.window
            slots = torch.arange(W, device=ks.device)
            # ring slots hold positions pos-W..pos-1 except the slot about to
            # be overwritten; all written slots are < pos by construction
            valid = slots != pos % W if pos >= W else slots < pos
        else:
            valid = torch.arange(ks.shape[1], device=ks.device) < pos
        o = self._decode_attend(q, k, v, ks, vs, valid)
        return self.attn.out(params, o), {"k_new": k, "v_new": v}

    def _decode_attend(self, q, k_new, v_new, ks, vs, valid):
        """Grouped-GQA single-query attention over cache + current token;
        dots in the cache dtype, softmax in float32.

        Under a mesh the one query token and the new key/value are taken
        whole on their heads, so the grouping reshape never splits a head
        group across chips; the cache keeps its sequence split, so the
        scores are split on the sequence and only the softmax's reductions
        and the output's sum cross chips (the reference's decode layout)."""
        if isinstance(q, DTensor):
            q, k_new, v_new = (whole_dim(t, 2) for t in (q, k_new, v_new))
        B, _, H, D = q.shape
        KV = ks.shape[-2]
        rep = H // KV
        q5 = q.reshape(B, 1, KV, rep, D).permute(0, 2, 3, 1, 4)  # [B,KV,rep,1,D]
        scale = 1.0 / float(D) ** 0.5
        lc = torch.einsum("bkrqd,bskd->bkrqs", q5, ks.to(q.dtype)).float() * scale
        lc = lc.masked_fill(~valid, L.NEG_INF)
        lnew = torch.einsum("bkrqd,bskd->bkrqs", q5, k_new.to(q.dtype)).float() * scale
        m = torch.maximum(lc.amax(dim=-1, keepdim=True), lnew)
        pc = torch.exp(lc - m)
        pn = torch.exp(lnew - m)
        denom = pc.sum(dim=-1, keepdim=True) + pn
        o = torch.einsum("bkrqs,bskd->bkrqd", pc.to(vs.dtype), vs) + pn.to(
            v_new.dtype
        ) * v_new.permute(0, 2, 1, 3)[:, :, None]
        o = o / denom.to(o.dtype)
        return o.permute(0, 3, 1, 2, 4).reshape(B, 1, H, D).to(q.dtype)

    def init_cache(self, batch, max_len, dtype, device):
        S = self.window if self.window is not None else max_len
        D = self.attn.head_dim
        shape = (batch, S, self.kv_store, D)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Block:
    """One transformer block; which sub-layers exist depends on the kind."""

    cfg: ModelConfig
    tp: int = 1
    self_attn: Optional[CachedAttention] = None
    mla: Optional[MLAttention] = None
    ssm: Optional[Mamba2Mixer] = None
    cross: Optional[L.AttentionLayer] = None
    mlp: Optional[L.MLP] = None
    moe: Optional[MoELayer] = None
    causal: bool = True

    @staticmethod
    def make(cfg: ModelConfig, kind: str, tp: int = 1, use_moe: bool = False) -> "Block":
        if kind not in BLOCK_KINDS:
            raise ValueError(f"unknown block kind {kind!r}; the kinds are {BLOCK_KINDS}")
        hp, kvp = pad_heads(cfg.n_heads, cfg.n_kv_heads, tp)
        d = cfg.resolved_head_dim
        attn = L.AttentionLayer(
            d_model=cfg.d_model, n_heads=hp, n_kv_heads=kvp, head_dim=d,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            rope_fraction=cfg.rope_fraction, window=cfg.window,
        )
        cached = CachedAttention(attn, kv_store_heads(kvp, tp), window=cfg.window)
        mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.act) if cfg.d_ff else None
        moe = MoELayer(cfg.d_model, cfg.moe, cfg.act) if (use_moe and cfg.moe) else None
        kw: Dict[str, Any] = dict(cfg=cfg, tp=tp, mlp=None if moe else mlp, moe=moe)
        if kind == "dense":
            if cfg.mla is not None:
                return Block(mla=MLAttention(cfg.d_model, hp, cfg.mla, cfg.rope_theta), **kw)
            return Block(self_attn=cached, **kw)
        if kind == "ssm":
            return Block(cfg=cfg, tp=tp, ssm=Mamba2Mixer(cfg.d_model, cfg.ssm))
        if kind == "hybrid":
            return Block(self_attn=cached, ssm=Mamba2Mixer(cfg.d_model, cfg.ssm), **kw)
        if kind == "encoder":
            return Block(self_attn=cached, causal=False, **kw)
        xattn = L.AttentionLayer(d_model=cfg.d_model, n_heads=hp, n_kv_heads=kvp, head_dim=d, cross=True)
        if kind == "cross":
            return Block(cross=xattn, **kw)
        return Block(self_attn=cached, cross=xattn, **kw)  # decoder: self + cross + mlp

    def params(self) -> dict:
        p: Dict[str, Any] = {}
        if self.self_attn is not None:
            p["attn"] = self.self_attn.params()
            p["attn_norm"] = L.rmsnorm_params(self.cfg.d_model)
        if self.mla is not None:
            p["attn"] = self.mla.params()
            p["attn_norm"] = L.rmsnorm_params(self.cfg.d_model)
        if self.ssm is not None:
            p["ssm"] = self.ssm.params()
            if self.self_attn is None:
                p["ssm_norm"] = L.rmsnorm_params(self.cfg.d_model)
        if self.cross is not None:
            p["cross"] = self.cross.params()
            p["cross_norm"] = L.rmsnorm_params(self.cfg.d_model)
        if self.mlp is not None:
            p["mlp"] = self.mlp.params()
            p["mlp_norm"] = L.rmsnorm_params(self.cfg.d_model)
        if self.moe is not None:
            p["moe"] = self.moe.params()
            p["mlp_norm"] = L.rmsnorm_params(self.cfg.d_model)
        return p

    def attention_pairs(self) -> set:
        """(q/k width, v width) of every attention a kernel-route prefill or
        apply of this block sends to B3."""
        pairs = set()
        for a in (self.self_attn.attn if self.self_attn else None, self.cross):
            if a is not None:
                pairs.add((a.head_dim, a.head_dim))
        if self.mla is not None:
            pairs.add((self.mla.qk_dim, self.mla.cfg.v_head_dim))
        return pairs

    def _norm(self, p, x):
        """The pre-norm of a sub-layer (under a mesh still split on the
        sequence: :func:`layers.dot` gathers it where a projection needs it)."""
        return L.rmsnorm(p, x, self.cfg.norm_eps)

    # -- mixing sub-layer (attention and/or SSM) ---------------------------
    def _mix(self, p, x, positions, impl, mode, cache=None, pos=None):
        """Returns (delta, new_cache_pieces)."""
        new_cache: Dict[str, Any] = {}
        parts = []
        if self.mla is not None:
            h = self._norm(p["attn_norm"], x)
            if mode == "decode":
                o, new_cache["mla"] = self.mla.decode(p["attn"], h, positions, cache["mla"], pos)
            else:
                # one latent for the attention and the cache (the reference
                # computes it twice, to the same values)
                c_kv, k_rope = self.mla.latent(p["attn"], h, positions)
                o = self.mla(p["attn"], h, positions, impl=impl, latent=(c_kv, k_rope))
                if mode == "prefill":
                    new_cache["mla"] = {"c_kv": c_kv, "k_rope": k_rope}
            parts.append(o)
        if self.self_attn is not None:
            h = self._norm(p["attn_norm"], x)
            if mode == "apply":
                o = self.self_attn.attn(p["attn"], h, positions, impl=impl, causal=self.causal)
            elif mode == "prefill":
                o, new_cache["attn"] = self.self_attn.prefill(p["attn"], h, positions, impl)
            else:
                o, new_cache["attn"] = self.self_attn.decode(p["attn"], h, positions, cache["attn"], pos)
            parts.append(o)
        if self.ssm is not None:
            hs = self._norm(p.get("ssm_norm", p.get("attn_norm")), x)
            if mode == "decode":
                o, new_cache["ssm"] = self.ssm.decode(p["ssm"], hs, cache["ssm"])
            else:
                # the port's departure from transformer.py:285 (module docstring)
                o = self.ssm(p["ssm"], hs, impl="kernel" if impl == "kernel" else "chunked")
                if mode == "prefill":
                    new_cache["ssm"] = self._ssm_prefill_state(p, hs)
            parts.append(o)
        delta = parts[0] if len(parts) == 1 else 0.5 * (parts[0] + parts[1])
        return delta, new_cache

    def _ssm_prefill_state(self, p, hs):
        """Final SSM state after a prefill (recomputed from the projections).

        The reference weighs step j by ``exp(la[-1] - la[j])`` with ``la`` the
        float32 cumsum over the whole prompt; at 4096 steps ``la`` reaches
        thousands, where one float32 ulp is ~5e-4, so the weights of the
        recent steps (the ones that matter) lose about three digits.  The
        port sums the same exponent from the end (``sum_{k>j} loga_k``), which
        stays small exactly where the weight is not negligible.
        """
        m = self.ssm
        xh, z, b, c, dt = m._project(p["ssm"], hs)
        xh, conv_state = m._conv(p["ssm"], xh)
        a = -torch.exp(p["ssm"]["a_log"].float())
        loga = a[None, None, :] * dt
        xdt = xh.float() * dt[..., None]
        # state = sum_j exp(sum_{k>j} loga_k) b_j xdt_j
        w = _decay_to_end(loga)  # [B,S,H]
        if isinstance(xdt, DTensor):  # whole sequences for the sum over it
            b, xdt = whole_dim(b, 1), whole_dim(xdt, 1)
        h = torch.einsum("bsn,bsh,bshp->bhnp", b.float(), w, xdt)
        return {"ssm": h, "conv": conv_state[:, -(m.cfg.conv_width - 1):]}

    def run(self, p, x, positions, *, impl, mode, cache=None, pos=None, ctx=None, mesh=None):
        """mode: apply | prefill | decode. Returns (x, new_cache)."""
        new_cache: Dict[str, Any] = {}
        if self.self_attn is not None or self.mla is not None or self.ssm is not None:
            delta, new_cache = self._mix(p, x, positions, impl, mode, cache, pos)
            x = _residual(x, delta)
        if self.cross is not None:
            h = self._norm(p["cross_norm"], x)
            if mode == "decode":
                # cross K/V are immutable after prefill: read, never re-emit
                q = L._proj(h, p["cross"]["wq"])
                o = L.attend(q, cache["cross_k"], cache["cross_v"], impl="dot", causal=False)
            else:
                q, k, v = self.cross.qkv(p["cross"], h, positions, kv_x=ctx)
                o = L.attend(q, k, v, impl=impl, causal=False)
                if mode == "prefill":
                    new_cache["cross_k"], new_cache["cross_v"] = k, v
            x = _residual(x, self.cross.out(p["cross"], o))
        if self.mlp is not None or self.moe is not None:
            h = self._norm(p["mlp_norm"], x)
            x = _residual(x, self.moe(p["moe"], h, mesh=mesh) if self.moe is not None else self.mlp(p["mlp"], h))
        return x, new_cache

    def init_cache(self, batch, max_len, dtype, device, ctx_len: int = 0):
        c: Dict[str, Any] = {}
        if self.self_attn is not None:
            c["attn"] = self.self_attn.init_cache(batch, max_len, dtype, device)
        if self.mla is not None:
            c["mla"] = self.mla.init_cache(batch, max_len, dtype, device)
        if self.ssm is not None:
            c["ssm"] = self.ssm.init_cache(batch, dtype, device)
        if self.cross is not None:
            shape = (batch, ctx_len, self.cross.n_kv_heads, self.cross.head_dim)
            c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return c


# ---------------------------------------------------------------------------
# Segments: a loop over stacked homogeneous blocks
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _unbind(tree, count: int) -> list:
    """The ``count`` per-layer trees of a stacked tree, by one ``unbind``
    per leaf: under autograd its backward is one ``stack`` per leaf, where
    indexing layer by layer would allocate and add into a zero tensor the
    size of the whole stacked leaf once per layer."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(count)]


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` remat policy: keep the outputs of matrix products
    without batch dimensions (``aten.mm``: the projections), as the
    reference's ``dots_with_no_batch_dims_saveable`` does; batched products
    (the attention scores, ``[B, H, S, S]`` each) are recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default else CheckpointPolicy.PREFER_RECOMPUTE


def _stack(trees):
    first = trees[0]
    return {
        k: _stack([t[k] for t in trees]) if isinstance(v, dict) else torch.stack([t[k] for t in trees])
        for k, v in first.items()
    }


def _decode_layout(t: torch.Tensor, logical) -> torch.Tensor:
    """A decode cache leaf (one layer's) in the reference's decode layout,
    ``cache_shardings``' (batch rows, the sequence split); ``t`` itself off
    a mesh or where it is already so placed."""
    if not isinstance(t, DTensor):
        return t
    return constrain(t, t.device_mesh, rules_for_mesh(t.device_mesh), logical)


def _decay_to_end(loga: torch.Tensor) -> torch.Tensor:
    """``exp(sum_{k > j} loga[:, k])`` for every step ``j`` (``loga [B, S, H]``),
    summed from the end; under a mesh each chip takes its own rows and heads
    with the sequence whole (``local_map``): DTensor has no sharding rule for
    ``flip`` in every release."""
    def plain(t):
        after = torch.flip(torch.cumsum(torch.flip(t[:, 1:], [1]), dim=1), [1])
        return torch.exp(torch.nn.functional.pad(after, (0, 0, 0, 1)))

    if not isinstance(loga, DTensor):
        return plain(loga)
    from torch.distributed.tensor.experimental import local_map

    loga = whole_dim(loga, 1)
    return local_map(plain, out_placements=list(loga.placements), in_placements=(loga.placements,),
                     device_mesh=loga.device_mesh)(loga)


def _residual(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``x + delta``.  Under a mesh the sub-layer's output (a pending sum over
    the tensor-parallel chips) is first redistributed to the residual
    stream's placement (a reduce-scatter onto its sequence split) by a
    redistribution of its own, whose backward hands the gradient back
    gathered on the sequence: left to the add, DTensor would hand it back
    split on the sequence, and the output projection's backward could not
    flatten it."""
    if isinstance(delta, DTensor):
        delta = delta.redistribute(x.device_mesh, x.placements)
    return x + delta


def _write_slot(old: torch.Tensor, new: torch.Tensor, slot: int, mesh) -> None:
    """``old[:, :, slot] = new[:, :, 0]`` in place (``old [count, B, S, ...]``,
    ``new [count, B, 1, ...]``).

    Under a mesh, ``new`` is first constrained to ``("layers", "batch")``
    (the reference's ``_append``), and each chip writes the slot into its own
    shard of ``old``: the chip whose block of the (``cache_seq``-sharded)
    sequence holds ``slot`` writes it, the others nothing.
    """
    if not isinstance(old, DTensor):
        old[:, :, slot] = new[:, :, 0].to(old.dtype)
        return

    new = constrain(new, mesh, rules_for_mesh(mesh), ("layers", "batch") + (None,) * (new.ndim - 2))
    want = [Replicate() if p.is_shard(2) else p for p in old.placements]
    new_l, old_l = new.redistribute(mesh, want).to_local(), old.to_local()
    block = block_index(mesh, old.placements, 2)
    S = old_l.shape[2]
    if block * S <= slot < (block + 1) * S:
        old_l[:, :, slot - block * S] = new_l[:, :, 0].to(old_l.dtype)


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    block: Block
    count: int

    def params(self) -> dict:
        """Stacked ParamSpec tree: every leaf gains a leading 'layers' dim."""

        def stack(ps: ParamSpec) -> ParamSpec:
            return dataclasses.replace(ps, shape=(self.count, *ps.shape), logical=("layers", *ps.logical))

        return tree_map(stack, self.block.params())

    @staticmethod
    def _checkpoint(body):
        """Remat policy knob (read at each call): REPRO_REMAT_POLICY in
        {"full" (default: save only the layer's input), "dots" (save the
        outputs of unbatched matrix products, trading memory for recompute
        FLOPs), "none" (no remat)}, the reference's.  Each layer runs under
        ``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``
        on the reference's scan body."""
        policy = os.environ.get("REPRO_REMAT_POLICY", "full")
        if policy == "none":
            return body
        kw = {}
        if policy == "dots":
            kw["context_fn"] = functools.partial(
                torch.utils.checkpoint.create_selective_checkpoint_contexts, _save_dots
            )
        return functools.partial(torch.utils.checkpoint.checkpoint, body, use_reentrant=False, **kw)

    @staticmethod
    def _anchor(x, mesh):
        """Each layer's input at the canonical activation sharding, as the
        reference anchors its scan carry; ``x`` itself with no mesh."""
        if mesh is None:
            return x
        return constrain(x, mesh, rules_for_mesh(mesh), ("batch", "seq_sp", "embed"))

    def apply(self, params, x, positions, *, impl, ctx=None, remat: bool = True, mesh=None):
        """Every layer over the full sequence.  ``remat`` recomputes each
        layer in the backward (:meth:`_checkpoint`); it is a no-op when
        autograd is off, as in serving."""

        specs = self.block.params()

        def body(layer_p, carry):
            carry = Segment._anchor(carry, mesh)
            layer_p = gather_fsdp(layer_p, specs, mesh)
            return self.block.run(layer_p, carry, positions, impl=impl, mode="apply", ctx=ctx, mesh=mesh)[0]

        if remat and torch.is_grad_enabled():
            body = Segment._checkpoint(body)
        for layer_p in _unbind(params, self.count):
            x = body(layer_p, x)
        return x

    def prefill(self, params, x, positions, *, impl, ctx=None, mesh=None):
        if self.count == 0:  # e.g. a vlm cut below one cross layer: empty stacked leaves
            return x, self.init_cache(x.shape[0], x.shape[1], x.dtype, x.device,
                                      0 if ctx is None else ctx.shape[1])
        caches, specs = [], self.block.params()
        for i in range(self.count):
            x, cache = self.block.run(gather_fsdp(_layer(params, i), specs, mesh), Segment._anchor(x, mesh),
                                      positions, impl=impl, mode="prefill", ctx=ctx, mesh=mesh)
            caches.append(cache)
        return x, _stack(caches)  # cache leaves stacked [count, ...]

    def decode(self, params, x, positions, caches, pos: int, mesh=None):
        """One decode step for all layers of this segment.

        Blocks never return updated cache tensors, only the new entries; they
        are written into the stacked caches **in place** after the loop (one
        copy per tensor), and the SSM state is replaced.  The caller's cache
        tensors therefore hold the new step on return.  Cross-attention
        caches are only read.
        """
        if self.count == 0:
            return x, caches
        updates, specs = [], self.block.params()
        for i in range(self.count):
            x, upd = self.block.run(
                gather_fsdp(_layer(params, i), specs, mesh), Segment._anchor(x, mesh), positions,
                impl="dot", mode="decode",
                cache=_layer(caches, i), pos=pos, mesh=mesh,
            )
            updates.append(upd)
        updates = _stack(updates)
        new_caches = dict(caches)
        # old: [count, B, S, ...]; new: [count, B, 1, ...]
        if "attn" in updates:
            W = self.block.self_attn.window
            slot = pos % W if W is not None else pos
            for name in ("k", "v"):
                _write_slot(caches["attn"][name], updates["attn"][f"{name}_new"], slot, mesh)
        if "mla" in updates:
            for name in ("c_kv", "k_rope"):
                _write_slot(caches["mla"][name], updates["mla"][f"{name}_new"], pos, mesh)
        if "ssm" in updates:
            new_caches["ssm"] = updates["ssm"]  # full replacement (O(1) state)
        return x, new_caches

    def init_cache(self, batch, max_len, dtype, device, ctx_len: int = 0):
        one = self.block.init_cache(batch, max_len, dtype, device, ctx_len)
        return tree_map(lambda a: torch.zeros((self.count, *a.shape), dtype=a.dtype, device=device), one)
