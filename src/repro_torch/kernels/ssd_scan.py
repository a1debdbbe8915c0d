"""Mamba-2 chunked SSD scan: a hand-written CUDA kernel and its plain versions.

:func:`ssd_chunked` computes, per (batch, head), the recurrence
``h_t = exp(loga_t) h_{t-1} + b_t (x) xdt_t``, ``y_t = c_t . h_t`` by
chunks of ``chunk`` steps, for ``xdt [B, S, H, P]``, ``loga [B, S, H]`` and
``b``/``c [B, S, N]`` (shared by every head), all float32.  It replaces the
Pallas kernel ``ssd_scan_kernel`` of ``src/repro/kernels/ssd_scan.py``; the
CUDA source is ``csrc/ssd_scan.cu``, which also says what bounds it on an
H100.  One call makes four CUDA launches, the chunk-parallel decomposition
of the Mamba-2 paper: the shared ``c . b`` scores per chunk, each chunk's own
end state, the sequential state passing over chunks, and each chunk's
output.

A tensor on the CPU goes to the plain chunked version
(:func:`repro_torch.models.ssd.ssd_chunked`, the port of
``repro.models.ssd.ssd_chunked``); a CUDA tensor goes to the kernel, or the
call raises.  :func:`ssd_scan_ref` is the sequential oracle (the batched form
of ``repro.kernels.ref.ssd_scan``) both are held against.  The wrapper counts
its calls that launched the kernels in ``ssd_chunked.launches``.

The output does not depend on the chunk size, so where a chunk's tiles would
not fit in a CTA's shared memory the kernels run a halved chunk
(:func:`kernel_chunk`; the layout is the CUDA source's alone).  The scratch
of one call (the scores ``[B, nc, Q, Q]``, the chunk states
``[B, nc, H, N, P]`` and their decays ``[B, nc, H]``, float32, ``nc`` the
number of chunks) comes from ``torch.empty`` here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.models.ssd import ssd_chunked as ssd_chunked_plain


def ssd_scan_ref(x: torch.Tensor, loga: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Sequential oracle: one step at a time over ``S``, state ``[B, N, H, P]`` in float32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    x, a, b, c = x.float(), torch.exp(loga.float()), b.float(), c.float()
    h = torch.zeros((B, N, H, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = a[:, t, None, :, None] * h + b[:, t, :, None, None] * x[:, t, None]
        ys.append(torch.einsum("bn,bnhp->bhp", c[:, t], h))
    return torch.stack(ys, dim=1)


def _check(xdt, loga, b, c) -> None:
    if xdt.ndim != 4 or loga.ndim != 3 or b.ndim != 3 or c.shape != b.shape:
        raise ValueError(
            "ssd_chunked: want xdt [B, S, H, P], loga [B, S, H], b/c [B, S, N], got "
            f"{tuple(xdt.shape)} / {tuple(loga.shape)} / {tuple(b.shape)} / {tuple(c.shape)}"
        )
    B, S, H, _ = xdt.shape
    if tuple(loga.shape) != (B, S, H) or tuple(b.shape[:2]) != (B, S) or b.shape[2] == 0:
        raise ValueError(
            f"ssd_chunked: loga {tuple(loga.shape)} / b {tuple(b.shape)} do not match xdt {tuple(xdt.shape)}"
        )
    tensors = (xdt, loga, b, c)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd_chunked: inputs must be float32, got {[str(t.dtype) for t in tensors]}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ssd_chunked: inputs lie on several devices: {sorted(map(str, devices))}")
    if xdt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_chunked: unsupported device {xdt.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_chunked: inputs must be contiguous")


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kbuild.load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd_chunked.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.repro_ssd_chunked.restype = i
        lib.repro_ssd_kernel_chunk.argtypes = [i, i, i, i, i]
        lib.repro_ssd_kernel_chunk.restype = i
        _LIB = lib
    return _LIB


def kernel_chunk(chunk: int, S: int, P: int, N: int, device: torch.device) -> int:
    """The chunk the kernels run on the CUDA ``device``: ``min(chunk, S)``,
    halved until each kernel's tiles fit a CTA's shared memory."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    Q = _library().repro_ssd_kernel_chunk(index, chunk, S, P, N)
    if Q < 0:
        raise RuntimeError(f"ssd_chunked: could not read the device's shared memory (cudaError_t {-Q})")
    if Q == 0:
        raise ValueError(f"ssd_chunked: state [N={N}, P={P}] does not fit a CTA's shared memory")
    return Q


def ssd_chunked(
    xdt: torch.Tensor,
    loga: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    chunk: int = 128,
) -> torch.Tensor:
    """Mamba-2 SSD over chunks -> ``y [B, S, H, P]`` float32."""
    _check(xdt, loga, b, c)
    if xdt.device.type == "cpu":
        return ssd_chunked_plain(xdt, loga, b, c, chunk)
    B, S, H, P = xdt.shape
    N = b.shape[2]
    y = torch.empty_like(xdt)
    if y.numel() == 0:
        return y
    Q = kernel_chunk(chunk, S, P, N, xdt.device)
    nc = -(-S // Q)
    scores = torch.empty((B, nc, Q, Q), dtype=torch.float32, device=xdt.device)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=xdt.device)
    decay = torch.empty((B, nc, H), dtype=torch.float32, device=xdt.device)
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = _library().repro_ssd_chunked(
        xdt.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        scores.data_ptr(), states.data_ptr(), decay.data_ptr(), B, S, H, P, N, Q, stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_chunked: kernel launch failed with cudaError_t {err}")
    ssd_chunked.launches += 1
    return y


ssd_chunked.launches = 0
