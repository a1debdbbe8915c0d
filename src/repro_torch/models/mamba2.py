"""Mamba-2 SSD (state-space duality) mixer.

The port of ``repro.models.mamba2``.  Prefill runs the chunked SSD
algorithm: quadratic attention-like math *within* chunks of length Q and a
linear recurrence *across* chunks.  ``impl="kernel"`` runs it in the CUDA
kernel B4 (:func:`repro_torch.kernels.ssd_scan.ssd_chunked`, its plain
version on a CPU tensor); every other ``impl`` runs the plain
:func:`repro_torch.models.ssd.ssd_chunked`.  Decode keeps a constant-size
state ``[B, H, N, P]``.

Simplifications vs. the Mamba-2 paper (as in the reference): single B/C
group, depthwise conv applied to x only, a per-head scalar D skip.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ssd_chunked as ssd_kernel
from repro_torch.models.layers import _proj, dot, rmsnorm, rmsnorm_params
from repro_torch.models.sharding import ParamSpec, PartitionSpec, placements, rules_for_mesh, spec_for
from repro_torch.models.ssd import ssd_chunked as ssd_plain


def _ssd_on_mesh(ssd_fn):
    """``ssd_fn`` on DTensors: each chip scans its own batch rows and heads
    (``local_map``); the scan never crosses either."""
    from torch.distributed.tensor.experimental import local_map

    def run(xdt, loga, b, c, chunk):
        mesh = xdt.device_mesh
        x_spec = spec_for(mesh, rules_for_mesh(mesh), ("batch", None, "ssm_heads", None), xdt.shape)
        px = placements(mesh, x_spec)
        pl = placements(mesh, PartitionSpec(*x_spec[:3]))
        pb = placements(mesh, PartitionSpec(x_spec[0], None, None))
        # a shard may be a strided view of its whole; the kernel B4 takes
        # contiguous inputs only
        scan = lambda *shards: ssd_fn(*(t.contiguous() for t in shards), chunk)
        return local_map(scan, out_placements=list(px),
                         in_placements=(px, pl, pb, pb), device_mesh=mesh, redistribute_inputs=True)(xdt, loga, b, c)

    return run


@dataclasses.dataclass(frozen=True)
class Mamba2Mixer:
    d_model: int
    cfg: SSMConfig

    @property
    def d_inner(self) -> int:
        return self.cfg.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.cfg.head_dim

    def params(self) -> dict:
        M, H, P, N = self.d_model, self.n_heads, self.cfg.head_dim, self.cfg.state_dim
        return {
            "w_x": ParamSpec((M, H, P), ("fsdp", "ssm_heads", None)),
            "w_z": ParamSpec((M, H, P), ("fsdp", "ssm_heads", None)),
            "w_b": ParamSpec((M, N), ("fsdp", None)),
            "w_c": ParamSpec((M, N), ("fsdp", None)),
            "w_dt": ParamSpec((M, H), ("fsdp", "ssm_heads")),
            "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros", keep_f32=True),
            "a_log": ParamSpec((H,), ("ssm_heads",), init="ones", keep_f32=True),
            "d_skip": ParamSpec((H,), ("ssm_heads",), init="ones", keep_f32=True),
            "conv_w": ParamSpec(
                (self.cfg.conv_width, H, P), (None, "ssm_heads", None), scale=0.5
            ),
            "norm": rmsnorm_params(H * P),
            "w_out": ParamSpec((H, P, M), ("ssm_heads", None, "fsdp")),
        }

    # ------------------------------------------------------------------
    def _project(self, params, x):
        """x [B,S,M] -> (xh [B,S,H,P], z, b [B,S,N], c [B,S,N], dt [B,S,H] f32)."""
        xh = _proj(x, params["w_x"])
        z = _proj(x, params["w_z"])
        b = dot(x, params["w_b"])
        c = dot(x, params["w_c"])
        dt = F.softplus(dot(x, params["w_dt"]).float() + params["dt_bias"].float())
        return xh, z, b, c, dt

    def _conv(self, params, xh, conv_state=None):
        """Depthwise causal conv over sequence. xh: [B,S,H,P]."""
        W = self.cfg.conv_width
        if conv_state is None:
            pad = torch.zeros((xh.shape[0], W - 1, *xh.shape[2:]), dtype=xh.dtype, device=xh.device)
        else:
            pad = conv_state
        xp = torch.cat([pad, xh], dim=1)
        S = xh.shape[1]
        out = torch.zeros_like(xh)
        for i in range(W):
            out = out + xp[:, i : i + S] * params["conv_w"][i]
        new_state = xp[:, -(W - 1):] if W > 1 else pad
        return F.silu(out), new_state

    def _gate_out(self, params, y, z):
        B, S, H, P = y.shape
        y = y * F.silu(z)
        y = rmsnorm(params["norm"], y.reshape(B, S, H * P))
        return dot(y, params["w_out"].reshape(H * P, -1))

    # ------------------------------------------------------------------
    def __call__(self, params, x, impl: str = "chunked"):
        """Full-sequence forward (prefill)."""
        xh, z, b, c, dt = self._project(params, x)
        xh, _ = self._conv(params, xh)
        a = -torch.exp(params["a_log"].float())  # [H], negative
        loga = (a[None, None, :] * dt).contiguous()  # [B,S,H]  log decay
        xdt = (xh.float() * dt[..., None]).contiguous()
        ssd_fn = ssd_kernel if impl == "kernel" else ssd_plain
        if isinstance(xdt, DTensor):
            ssd_fn = _ssd_on_mesh(ssd_fn)
        y = ssd_fn(xdt, loga, b.float().contiguous(), c.float().contiguous(), self.cfg.chunk)
        y = y + xh.float() * params["d_skip"].float()[None, None, :, None]
        return self._gate_out(params, y.to(x.dtype), z)

    # ------------------------------------------------------------------
    def decode(self, params, x, cache) -> Tuple[torch.Tensor, dict]:
        """Single-token step. cache: {ssm [B,H,N,P] f32, conv [B,W-1,H,P]}."""
        xh, z, b, c, dt = self._project(params, x)  # S == 1
        xh, conv_state = self._conv(params, xh, cache["conv"])
        a = -torch.exp(params["a_log"].float())
        decay = torch.exp(a[None, :] * dt[:, 0])  # [B,H]
        xdt = xh[:, 0].float() * dt[:, 0, :, None]  # [B,H,P]
        h = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", b[:, 0].float(), xdt
        )
        y = torch.einsum("bn,bhnp->bhp", c[:, 0].float(), h)
        y = y + xh[:, 0].float() * params["d_skip"].float()[None, :, None]
        out = self._gate_out(params, y[:, None].to(x.dtype), z)
        return out, {"ssm": h, "conv": conv_state}

    def init_cache(self, batch: int, dtype, device) -> dict:
        H, P, N, W = self.n_heads, self.cfg.head_dim, self.cfg.state_dim, self.cfg.conv_width
        return {
            "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, max(W - 1, 1), H, P), dtype=dtype, device=device),
        }
