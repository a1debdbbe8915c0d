"""Chunked SSD algorithm (Mamba-2) in plain PyTorch ops.

The port of ``repro.models.ssd``: a loop over chunks keeps the quadratic
intra-chunk tensors bounded to one chunk at a time, while the cross-chunk
state ``h [B, H, N, P]`` carries the recurrence.  It is the ``"chunked"``
route of :class:`repro_torch.models.mamba2.Mamba2Mixer` and the CPU route of
the CUDA kernel :func:`repro_torch.kernels.ssd_scan.ssd_chunked`.
"""

from __future__ import annotations

import torch


def ssd_chunked(
    xdt: torch.Tensor,  # [B, S, H, P] dt-scaled inputs (float32)
    loga: torch.Tensor,  # [B, S, H]   log decay per step (<= 0)
    b: torch.Tensor,  # [B, S, N]
    c: torch.Tensor,  # [B, S, N]
    chunk: int = 128,
) -> torch.Tensor:
    """Returns y [B, S, H, P] with h_t = exp(loga_t) h_{t-1} + b_t (x) xdt_t,
    y_t = c_t . h_t  (all per head)."""
    B, S, H, P = xdt.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xdt = torch.nn.functional.pad(xdt, (0, 0, 0, 0, 0, pad))
        loga = torch.nn.functional.pad(loga, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    nc = (S + pad) // Q
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))

    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=xdt.device)
    ys = []
    for i in range(nc):
        sl = slice(i * Q, (i + 1) * Q)
        xq, lq, bq, cq = xdt[:, sl], loga[:, sl], b[:, sl], c[:, sl]
        # inclusive log-decay prefix [B,Q,H], in float64: |la| reaches
        # Q |loga|, where a float32 ulp would cost the decay factors their
        # last digits (the reference sums in float32)
        la = torch.cumsum(lq.double(), dim=1)
        # intra-chunk (attention-like, masked).  The mask is applied to the
        # *exponent*: masked (j > i) entries have positive log-decay sums
        # that overflow exp.
        scores = torch.einsum("bin,bjn->bij", cq, bq)
        diff = (la[:, :, None, :] - la[:, None, :, :]).float()  # [B,Q,Q,H]
        diff = diff.masked_fill(~mask[None, :, :, None], float("-inf"))
        decay = torch.exp(diff)
        y = torch.einsum("bij,bijh,bjhp->bihp", scores, decay, xq)
        # inter-chunk: state entering the chunk, decayed through position i
        y = y + torch.einsum("bin,bhnp->bihp", cq, h) * torch.exp(la.float())[..., None]
        # state at chunk end
        la_end = la[:, -1]  # [B,H]
        w = torch.exp((la_end[:, None, :] - la).float())  # [B,Q,H] decay from j to end
        s_end = torch.einsum("bjn,bjh,bjhp->bhnp", bq, w, xq)
        h = h * torch.exp(la_end.float())[:, :, None, None] + s_end
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S]
