"""Blocked-ELL SpMV / SpMM: hand-written CUDA kernels and their plain versions.

:func:`spmv_ell` computes ``w[g, i] = sum_k data[g, i, k] * x[g, cols[g, i, k]]``
for every stacked rank ``g`` in one launch; :func:`spmm_ell` is its
multi-vector form ``W[g, i, c] = sum_k data[g, i, k] * X[g, cols[g, i, k], c]``.
They replace the Pallas kernels ``spmv_ell`` and ``spmm_ell`` of
``src/repro/kernels/spmv_ell.py`` (bodies ``_spmv_ell_kernel`` /
``_spmv_ell_masked_kernel`` and ``_spmm_ell_kernel`` /
``_spmm_ell_masked_kernel``).  The CUDA source is ``csrc/spmv_ell.cu``.

Both are bound by bytes on an H100: the least time is
``(data + cols + x + out bytes) / 3.35 TB/s``.  The kernels read each row's
own ``K`` slots (no padding of ``K`` to 128 lanes as on the TPU) and sum
them in order in an fp32 FMA chain; bf16 inputs are widened and the result
rounded to bf16 once.

``tile_mask`` (``[g, ntiles]`` int32, one entry per row tile of
:data:`TILE_R` rows for SpMV and :data:`TILE_R_MM` rows for SpMM) selects
the tiles that compute; a tile with mask 0 delivers zeros.  An active tile
runs exactly the code of the unmasked kernel, and SpMM at ``C = 1`` runs
exactly the SpMV arithmetic, so the overlapped distributed SpMV equals the
barrier one bitwise and a one-column SpMM equals the SpMV bitwise.

A tensor on the CPU goes to the plain PyTorch version (:func:`spmv_ell_ref`
and friends); a CUDA tensor goes to the kernel, or the call raises.  Column
ids are trusted to lie in ``[0, N)``, as :func:`partition_csr` builds them.
Each wrapper counts its kernel launches in its ``launches`` attribute.  A
call made while its stream is being captured into a CUDA graph launches
nothing: it counts in ``captured`` instead, and the graph's owner counts the
launches of its replays (:mod:`repro_torch.solve.fused`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild

TILE_R = 256  # rows per SpMV tile (mask granularity); kTileR in the source
TILE_R_MM = 64  # rows per SpMM tile; kTileRMM in the source

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def num_row_tiles(rows: int, tile_rows: int) -> int:
    """Number of row tiles (= ``tile_mask`` width) for ``rows`` ELL rows."""
    return -(-rows // tile_rows)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def spmv_ell_ref(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w[g, i] = sum_k data[g,i,k] * x[g, cols[g,i,k]]``, summed over ``k``
    in order in float32 and returned in ``data``'s dtype."""
    g, R, K = data.shape
    gathered = torch.gather(x.float(), 1, cols.reshape(g, R * K).long()).reshape(g, R, K)
    d = data.float()
    acc = torch.zeros((g, R), dtype=torch.float32, device=data.device)
    for k in range(K):
        acc = acc + d[:, :, k] * gathered[:, :, k]
    return acc.to(data.dtype)


def spmm_ell_ref(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W[g, i, c] = sum_k data[g,i,k] * x[g, cols[g,i,k], c]`` for
    ``x: [g, N, C]``; the same per-element arithmetic as :func:`spmv_ell_ref`,
    so a one-column ``x`` reproduces it bitwise."""
    g, R, K = data.shape
    rank = torch.arange(g, device=data.device)[:, None, None]
    gathered = x.float()[rank, cols.long()]  # [g, R, K, C]
    d = data.float()
    acc = torch.zeros((g, R, x.shape[2]), dtype=torch.float32, device=data.device)
    for k in range(K):
        acc = acc + d[:, :, k, None] * gathered[:, :, k, :]
    return acc.to(data.dtype)


def spmv_ell_masked_ref(
    data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, row_mask: torch.Tensor
) -> torch.Tensor:
    """Masked SpMV: rows where ``row_mask`` (``[g, R]`` bool) is False
    deliver exactly 0 (the kernel's skipped tiles, expanded to rows)."""
    w = spmv_ell_ref(data, cols, x)
    return torch.where(row_mask, w, torch.zeros_like(w))


def spmm_ell_masked_ref(
    data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, row_mask: torch.Tensor
) -> torch.Tensor:
    """Masked SpMM; see :func:`spmv_ell_masked_ref`."""
    w = spmm_ell_ref(data, cols, x)
    return torch.where(row_mask[:, :, None], w, torch.zeros_like(w))


def rows_of_tiles(tile_mask: torch.Tensor, tile_rows: int, rows: int) -> torch.Tensor:
    """``[g, ntiles]`` tile mask -> ``[g, rows]`` bool row mask."""
    return tile_mask.ne(0).repeat_interleave(tile_rows, dim=1)[:, :rows]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, data, cols, x, tile_mask, x_ndim, tile_rows) -> None:
    if data.ndim != 3 or cols.shape != data.shape:
        raise ValueError(
            f"{name}: data/cols must be [g, R, K] of one shape, got "
            f"{tuple(data.shape)} / {tuple(cols.shape)}"
        )
    if x.ndim != x_ndim or x.shape[0] != data.shape[0]:
        want = "[g, N]" if x_ndim == 2 else "[g, N, C]"
        raise ValueError(f"{name}: x must be {want} with g={data.shape[0]}, got {tuple(x.shape)}")
    if data.dtype not in _DTYPE_CODES or x.dtype != data.dtype:
        raise TypeError(
            f"{name}: data and x must both be float32 or bfloat16, got "
            f"{data.dtype} / {x.dtype}"
        )
    if cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be int32, got {cols.dtype}")
    tensors = [data, cols, x]
    if tile_mask is not None:
        g, R = data.shape[:2]
        want = (g, num_row_tiles(R, tile_rows))
        if tuple(tile_mask.shape) != want or tile_mask.dtype != torch.int32:
            raise ValueError(
                f"{name}: tile_mask must be int32 {want}, got "
                f"{tile_mask.dtype} {tuple(tile_mask.shape)}"
            )
        tensors.append(tile_mask)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on several devices: {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    device = data.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kbuild.load("spmv_ell")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_spmv_ell.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
        lib.repro_spmm_ell.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
        lib.repro_spmv_ell.restype = lib.repro_spmm_ell.restype = i
        if (lib.repro_spmv_ell_tile_rows(), lib.repro_spmm_ell_tile_rows()) != (TILE_R, TILE_R_MM):
            raise RuntimeError("spmv_ell: tile sizes of the built library do not match")
        _LIB = lib
    return _LIB


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")


def _count(wrapper) -> None:
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def spmv_ell(
    data: torch.Tensor,
    cols: torch.Tensor,
    x: torch.Tensor,
    tile_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``w = A @ x`` per rank: data/cols ``[g, R, K]``, x ``[g, N]`` -> ``[g, R]``."""
    _check("spmv_ell", data, cols, x, tile_mask, 2, TILE_R)
    g, R, K = data.shape
    if data.device.type == "cpu":
        if tile_mask is None:
            return spmv_ell_ref(data, cols, x)
        return spmv_ell_masked_ref(data, cols, x, rows_of_tiles(tile_mask, TILE_R, R))
    out = torch.empty((g, R), dtype=data.dtype, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _library().repro_spmv_ell(
        _DTYPE_CODES[data.dtype], _ptr(data), _ptr(cols), _ptr(x), _ptr(tile_mask),
        _ptr(out), g, R, K, x.shape[1], stream,
    )
    _raise_on(err, "spmv_ell")
    _count(spmv_ell)
    return out


def spmm_ell(
    data: torch.Tensor,
    cols: torch.Tensor,
    x: torch.Tensor,
    tile_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``W = A @ X`` per rank: data/cols ``[g, R, K]``, X ``[g, N, C]`` -> ``[g, R, C]``."""
    _check("spmm_ell", data, cols, x, tile_mask, 3, TILE_R_MM)
    g, R, K = data.shape
    if data.device.type == "cpu":
        if tile_mask is None:
            return spmm_ell_ref(data, cols, x)
        return spmm_ell_masked_ref(data, cols, x, rows_of_tiles(tile_mask, TILE_R_MM, R))
    out = torch.empty((g, R, x.shape[2]), dtype=data.dtype, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _library().repro_spmm_ell(
        _DTYPE_CODES[data.dtype], _ptr(data), _ptr(cols), _ptr(x), _ptr(tile_mask),
        _ptr(out), g, R, K, x.shape[1], x.shape[2], stream,
    )
    _raise_on(err, "spmm_ell")
    _count(spmm_ell)
    return out


spmv_ell.launches = spmv_ell.captured = 0
spmm_ell.launches = spmm_ell.captured = 0
