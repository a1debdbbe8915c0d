"""Multi-head Latent Attention (DeepSeek-V2) with absorbed decode.

The port of ``repro.models.mla``.  Keys/values are compressed into a
per-token latent ``c_kv`` of rank ``kv_lora_rank`` plus a shared rotary key
``k_rope``; the decode path uses the weight-absorption identity so the KV
cache stores only ``[B, S, kv_lora_rank + rope_head_dim]``:

    q^T k   = (q_nope^T W_uk) c_kv + q_rope^T k_rope
    out_h   = (probs_h @ c_kv) W_uv[h]

The prefill expands the latent into per-head keys ``nope + rope`` wide and
values ``v_head_dim`` wide and hands them to :func:`layers.attend`; with
``impl="kernel"`` that is B3 at the pair (192, 128) for deepseek-v2-lite.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import MLAConfig
from repro_torch.models.layers import _proj, attend, dot, rmsnorm, rmsnorm_params, rope
from repro_torch.models.sharding import ParamSpec, constrain, rules_for_mesh, whole_dim


@dataclasses.dataclass(frozen=True)
class MLAttention:
    d_model: int
    n_heads: int
    cfg: MLAConfig
    rope_theta: float = 1e4

    @property
    def qk_dim(self) -> int:
        return self.cfg.nope_head_dim + self.cfg.rope_head_dim

    def params(self) -> dict:
        c, M, H = self.cfg, self.d_model, self.n_heads
        return {
            "wq": ParamSpec((M, H, self.qk_dim), ("fsdp", "heads", None)),
            "w_kv_a": ParamSpec((M, c.kv_lora_rank + c.rope_head_dim), ("fsdp", None)),
            "kv_norm": rmsnorm_params(c.kv_lora_rank),
            "w_uk": ParamSpec((c.kv_lora_rank, H, c.nope_head_dim), (None, "heads", None)),
            "w_uv": ParamSpec((c.kv_lora_rank, H, c.v_head_dim), (None, "heads", None)),
            "wo": ParamSpec((H, c.v_head_dim, M), ("heads", None, "fsdp")),
        }

    # ------------------------------------------------------------------
    def latent(self, params, x, positions) -> Tuple[torch.Tensor, torch.Tensor]:
        """x -> (c_kv [B,S,lora], k_rope [B,S,rope_dim]) -- the cache entry."""
        r = self.cfg.kv_lora_rank
        kv_a = dot(x, params["w_kv_a"])
        c_kv = rmsnorm(params["kv_norm"], kv_a[..., :r])
        k_rope = rope(kv_a[..., r:][:, :, None, :], positions, self.rope_theta)[:, :, 0, :]
        return c_kv, k_rope

    def queries(self, params, x, positions):
        n = self.cfg.nope_head_dim
        q = _proj(x, params["wq"])
        return q[..., :n], rope(q[..., n:], positions, self.rope_theta)

    def expand(self, params, c_kv, k_rope):
        """The latent expanded into per-head keys ``[B,S,H,nope+rope]`` and
        values ``[B,S,H,v]`` (the prefill's attention inputs)."""
        k_nope = _proj(c_kv, params["w_uk"])
        v = _proj(c_kv, params["w_uv"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], k_rope.shape[-1])], dim=-1)
        return k, v.contiguous()

    def out(self, params, o):
        wo = params["wo"]
        B, S = o.shape[:2]
        return dot(o.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]))

    # ------------------------------------------------------------------
    def __call__(self, params, x, positions, impl="dot", latent=None):
        """Train/prefill path: expand the latent into per-head K/V.
        ``latent`` (``(c_kv, k_rope)`` of :meth:`latent`) is computed here
        when not given."""
        q_nope, q_rope = self.queries(params, x, positions)
        c_kv, k_rope = latent if latent is not None else self.latent(params, x, positions)
        k, v = self.expand(params, c_kv, k_rope)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = attend(q, k, v, impl=impl, causal=True, scale=1.0 / math.sqrt(self.qk_dim))
        return self.out(params, o)

    # ------------------------------------------------------------------
    def decode(self, params, x, positions, cache, pos: int):
        """Absorbed single-token decode.

        cache: dict(c_kv [B, Smax, lora], k_rope [B, Smax, rope]); ``pos`` is
        the current write index.  Attention runs over the existing entries
        (masked to ``< pos``) plus the current latent as an explicit extra
        term; :meth:`Segment.decode` appends the new entries after the layer
        loop.  ``q_lat`` in x's dtype, scores and probabilities in float32,
        as in the reference.  Returns (out, update dict).
        """
        q_nope, q_rope = self.queries(params, x, positions)  # [B,1,H,*]
        if isinstance(q_nope, DTensor):
            # whole heads for the one query token; the latent cache keeps its
            # sequence split (the layout of CachedAttention._decode_attend)
            q_nope, q_rope = whole_dim(q_nope, 2), whole_dim(q_rope, 2)
        c_new, kr_new = self.latent(params, x, positions)  # [B,1,lora],[B,1,rope]
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        if isinstance(c_kv, DTensor):  # the reference's decode layout: batch rows, the sequence split
            rules = rules_for_mesh(c_kv.device_mesh)
            c_kv, k_rope = (constrain(t, t.device_mesh, rules, ("batch", "cache_seq", None)) for t in (c_kv, k_rope))
        c_kv, k_rope = c_kv.float(), k_rope.float()
        c_new32, kr_new32 = c_new.float(), kr_new.float()
        # absorb: q' = q_nope @ W_uk -> latent space
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, params["w_uk"].to(x.dtype)).float()
        q_rope = q_rope.float()
        scale = 1.0 / math.sqrt(self.qk_dim)
        sc = (torch.einsum("bqhr,bsr->bhqs", q_lat, c_kv) + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope)) * scale
        spos = torch.arange(c_kv.shape[1], device=x.device)
        sc = sc.masked_fill(spos >= pos, -1e30)
        sn = (torch.einsum("bqhr,bsr->bhqs", q_lat, c_new32)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, kr_new32)) * scale
        probs = torch.softmax(torch.cat([sc, sn], dim=-1), dim=-1)
        ctx = (torch.einsum("bhqs,bsr->bqhr", probs[..., :-1], c_kv)
               + torch.einsum("bhqs,bsr->bqhr", probs[..., -1:], c_new32))
        o = torch.einsum("bqhr,rhd->bqhd", ctx.to(x.dtype), params["w_uv"].to(x.dtype))
        return self.out(params, o), {"c_kv_new": c_new, "k_rope_new": kr_new}

    def init_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        c = self.cfg
        return {
            "c_kv": torch.zeros((batch, max_len, c.kv_lora_rank), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, c.rope_head_dim), dtype=dtype, device=device),
        }
