"""Shared transformer layers: norms, RoPE, GQA attention, MLP.

The port of ``repro.models.layers``.  Layers are frozen dataclasses whose
``params()`` declares a tree of :class:`~repro_torch.models.sharding.ParamSpec`
with the reference's names, and whose calls are plain functions over
(params dict, inputs).

Attention implementations (``impl``):

* ``dot``     -- materialized scores (short sequences, decode tests)
* ``chunked`` -- online softmax over key blocks in plain torch ops
* ``kernel``  -- the CUDA flash kernel B3
  (:func:`repro_torch.kernels.flash_attention.flash_attention`; its plain
  version on a CPU tensor).  The port's name for the reference's
  ``"pallas"``.
* ``fused``   -- the reference's dry-run stand-in for the flash kernel
  (:func:`attend_fused_stub`): shape-correct and cheap, with no matrix
  product; :mod:`repro_torch.launch.dryrun` adds the kernel's FLOPs and
  bytes analytically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.kernels.flash_attention import attention_ref as attend_dot  # materialized scores
from repro_torch.models.sharding import (
    PartitionSpec,
    ParamSpec,
    block_index,
    placements,
    rules_for_mesh,
    spec_for,
    whole_dim,
)

#: attention implementations the port runs
ATTENTION_IMPLS = ("dot", "chunked", "kernel", "fused")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_params(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones", keep_f32=True)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 1e4,
    fraction: float = 1.0,
) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, D]; positions: [..., S].

    ``fraction < 1`` rotates only the leading ``fraction * D`` dims
    (ChatGLM's 2D/partial RoPE).  Angles in float32.
    """
    D = x.shape[-1]
    rot = int(D * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., :, None, None].float() * freqs  # [..., S, 1, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention cores (batched; q: [B, Sq, H, D], k/v: [B, Sk, Hkv, D])
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    rep = h // k.shape[-2]
    return k.repeat_interleave(rep, dim=-2) if rep > 1 else k


def _mask(Sq: int, Sk: int, kpos: torch.Tensor, causal: bool, window: Optional[int], device):
    """[Sq, len(kpos)] visibility of keys at ``kpos`` from queries at ``i + Sk - Sq``."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    mask = torch.ones((Sq, kpos.shape[-1]), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attend_chunked(q, k, v, causal: bool = True, window: Optional[int] = None,
                   scale: Optional[float] = None, block: int = 1024) -> torch.Tensor:
    """Online-softmax (flash) attention over key blocks, plain torch ops.

    Memory is O(Sq * block) per head instead of O(Sq * Sk).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    Dv = v.shape[-1]
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    nblk = -(-Sk // block)
    qf = q.float()
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for b_idx in range(nblk):
        lo, hi = b_idx * block, min((b_idx + 1) * block, Sk)
        kblk, vblk = k[:, lo:hi].float(), v[:, lo:hi].float()
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kblk) * scale
        logits = logits.masked_fill(~_mask(Sq, Sk, kpos, causal, window, q.device), NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attend_fused_stub(q, k, v) -> torch.Tensor:
    """Shape- and dependency-correct stand-in for the flash kernel.

    Used only by the dry-run's fused-attention variant
    (``REPRO_ATTN_IMPL=fused``): the trace carries this cheap stand-in,
    which the op counter does not see as a matrix product, and the dry-run
    adds the kernel's FLOPs and HBM bytes analytically
    (:func:`repro_torch.launch.dryrun.attention_kernel_terms`).  On the
    card, ``impl="kernel"`` runs the real kernel B3.
    """
    H = q.shape[-2]
    Dv = v.shape[-1]  # MLA: value head dim < qk head dim
    km = _repeat_kv(k.mean(dim=1, keepdim=True), H)
    vm = _repeat_kv(v.mean(dim=1, keepdim=True), H)
    return q[..., :Dv] * km[..., :Dv] + vm


def attend(q, k, v, *, impl: str = "dot", causal: bool = True, window=None, scale=None) -> torch.Tensor:
    if isinstance(q, DTensor):
        return _attend_on_mesh(q, k, v, impl=impl, causal=causal, window=window, scale=scale)
    if impl == "dot":
        return attend_dot(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "chunked":
        return attend_chunked(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "fused":
        return attend_fused_stub(q, k, v)
    raise ValueError(f"unknown attention impl {impl!r}; the port runs {ATTENTION_IMPLS}")


def _attend_on_mesh(q, k, v, **kw) -> torch.Tensor:
    """:func:`attend` on DTensors: each chip attends over its own batch rows
    and heads (``local_map``), as GSPMD partitions the reference's attention.

    q is split as ``("batch", None, "heads", None)`` and k/v as ``("batch",
    None, "kv_heads", None)``, each where it divides.  Where the query heads
    are split and the key/value heads are not (fewer of them than chips), each
    chip picks the key/value head of each of its query heads.
    """
    mesh = q.device_mesh
    rules = rules_for_mesh(mesh)
    q_spec = spec_for(mesh, rules, ("batch", None, "heads", None), q.shape)
    kv_spec = spec_for(mesh, rules, ("batch", None, "kv_heads", None), k.shape)
    if q_spec[2] is None or kv_spec[2] != q_spec[2]:
        kv_spec = PartitionSpec(*kv_spec[:2], None, None)
    H, KV = q.shape[2], k.shape[2]
    q_place, kv_place = placements(mesh, q_spec), placements(mesh, kv_spec)

    def local(ql, kl, vl):
        if kv_spec[2] is None and q_spec[2] is not None:
            Hl = ql.shape[2]
            idx = (block_index(mesh, q_place, 2) * Hl + torch.arange(Hl, device=ql.device)) // (H // KV)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        # a shard may be a strided view of its whole; the kernel B3 takes
        # contiguous q/k/v only
        return attend(ql.contiguous(), kl.contiguous(), vl.contiguous(), **kw)

    return local_map(local, out_placements=list(q_place), in_placements=(q_place, kv_place, kv_place),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D weight ``w``; ``x @ w`` itself off a mesh.

    Under a mesh the residual stream arrives split on its sequence (dim 1,
    ``seq_sp``).  Where the weight's columns are split on a mesh dim that
    splits the sequence (a tensor-parallel projection), ``x`` is gathered on
    its sequence first, as Megatron's sequence parallelism does.  Where they
    are whole there (the weight replicated on it: key/value heads or SSM
    heads that do not divide the axis, the router, the small SSM
    projections), each chip projects its own rows of the sequence
    (``local_map``) and the output stays split, so no chip repeats another's
    product.  DTensor's own product of a tensor split on two leading dims
    cannot flatten them in every release.
    """
    if not isinstance(x, DTensor) or x.ndim != 3 or not any(p.is_shard(1) for p in x.placements):
        return x @ w
    if any(not w.placements[i].is_replicate() for i, p in enumerate(x.placements) if p.is_shard()):
        return whole_dim(x, 1) @ w
    out = [p if p.is_shard() else Shard(2) if q.is_shard(1) else Replicate()
           for p, q in zip(x.placements, w.placements)]
    return local_map(torch.matmul, out_placements=out, in_placements=(x.placements, w.placements),
                     device_mesh=x.device_mesh)(x, w)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsm,m...->bs...", x, w)`` as one matrix product."""
    M = w.shape[0]
    y = dot(x, w.reshape(M, -1))
    if len(w.shape) > 2 and isinstance(y, DTensor):
        y = _split_as_weight(y, w)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def _split_as_weight(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The flattened ``[..., H*D]`` product of :func:`_proj` under a mesh,
    its last dim split only on the mesh dims that split the weight's heads.

    DTensor may split the product's columns on any mesh dim (a free local
    slice), but the reshape into ``[..., H, D]`` needs each shard to hold
    whole heads, which is what ``spec_for``'s divisibility rule guarantees for
    the weight.
    """
    last = y.ndim - 1
    want = [Replicate() if p.is_shard(last) and not q.is_shard(1) else p
            for p, q in zip(y.placements, w.placements)]
    return y if want == list(y.placements) else y.redistribute(y.device_mesh, want)


@dataclasses.dataclass(frozen=True)
class AttentionLayer:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    window: Optional[int] = None
    cross: bool = False  # cross-attention (kv from encoder/image context)

    def params(self) -> dict:
        H, KV, D, M = self.n_heads, self.n_kv_heads, self.head_dim, self.d_model
        p = {
            "wq": ParamSpec((M, H, D), ("fsdp", "heads", None)),
            "wk": ParamSpec((M, KV, D), ("fsdp", "kv_heads", None)),
            "wv": ParamSpec((M, KV, D), ("fsdp", "kv_heads", None)),
            "wo": ParamSpec((H, D, M), ("heads", None, "fsdp")),
        }
        if self.qk_norm:
            p["q_norm"] = rmsnorm_params(D)
            p["k_norm"] = rmsnorm_params(D)
        return p

    def qkv(self, params, x, positions, kv_x=None):
        """x: [B, S, M] -> q [B,S,H,D], k/v [B,Skv,KV,D] (rotated, normed);
        k/v are projected from ``kv_x`` (default: x).  Cross-attention
        rotates neither q nor k."""
        kv_x = x if kv_x is None else kv_x
        q = _proj(x, params["wq"])
        k = _proj(kv_x, params["wk"])
        v = _proj(kv_x, params["wv"])
        if self.qk_norm:
            q = rmsnorm(params["q_norm"], q)
            k = rmsnorm(params["k_norm"], k)
        if not self.cross:
            q = rope(q, positions, self.rope_theta, self.rope_fraction)
            kpos = positions[..., -k.shape[1]:] if k.shape[1] != q.shape[1] else positions
            k = rope(k, kpos, self.rope_theta, self.rope_fraction)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def out(self, params, attn_out):
        wo = params["wo"]
        B, S = attn_out.shape[:2]
        return dot(attn_out.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]))

    def __call__(self, params, x, positions, impl="dot", kv_x=None, causal: Optional[bool] = None):
        q, k, v = self.qkv(params, x, positions, kv_x=kv_x)
        causal = (not self.cross) if causal is None else causal
        o = attend(q, k, v, impl=impl, causal=causal, window=self.window)
        return self.out(params, o)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLP:
    d_model: int
    d_ff: int
    act: str = "silu"  # silu (-> SwiGLU) | gelu

    def params(self) -> dict:
        p = {
            "w_in": ParamSpec((self.d_model, self.d_ff), ("fsdp", "mlp")),
            "w_out": ParamSpec((self.d_ff, self.d_model), ("mlp", "fsdp")),
        }
        if self.act == "silu":
            p["w_gate"] = ParamSpec((self.d_model, self.d_ff), ("fsdp", "mlp"))
        return p

    def __call__(self, params, x):
        h = dot(x, params["w_in"])
        if self.act == "silu":
            h = F.silu(dot(x, params["w_gate"])) * h
        else:
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(h, approximate="tanh")
        return dot(h, params["w_out"])
