"""The work the benchmark's problems need, counted from its own CSR, and the
card's published peaks.

Every byte count is of the problem, not of a layout: a stored nonzero is
its float32 value and its int32 column id, a vector is read once and
written once, whatever a kernel reads again or pads.  A roofline share
divides the least time these counts allow by a time measured on the card.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

F32 = 4
#: published peaks of one card (NVIDIA's data sheet, dense rates), keyed
#: by a part of the name ``torch.cuda.get_device_name()`` gives
PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def peaks_of(device_name: str) -> Dict[str, float]:
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    raise KeyError(f"no published peaks for {device_name!r}")


def bound_s(nbytes: float, flops: float, peaks: Dict[str, float]) -> float:
    """The least seconds the card could take: bytes over the HBM rate or
    operations over the float32 rate, whichever is larger."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["f32_flops_per_s"])


def problem_counts(A, nranks: int) -> Dict[str, int]:
    """``n``, ``nnz`` and ``halo``: the off-rank values the ranks need, each
    distinct ``(rank, column)`` once, for rows split evenly over ``nranks``."""
    L = A.n // nranks
    rows = np.repeat(np.arange(A.n, dtype=np.int64) // L, np.diff(A.indptr))
    cols = np.asarray(A.indices, dtype=np.int64)
    off = rows != cols // L
    halo = np.unique(rows[off] * A.n + cols[off]).size
    return {"n": int(A.n), "nnz": int(A.nnz), "halo": int(halo)}


def spmv_bytes(c: Dict[str, int], width: int = 1) -> int:
    """One product ``A @ X`` with ``X`` of ``width`` columns: every stored
    nonzero (value and column id) once, ``X`` and the halo read once, the
    output written once."""
    return 2 * F32 * c["nnz"] + F32 * width * (2 * c["n"] + c["halo"])


def spmv_flops(c: Dict[str, int], width: int = 1) -> int:
    return 2 * c["nnz"] * width


#: vector passes of one textbook CG iteration besides its product: p.q
#: reads 2, x += a p 3, r -= a q 3, r.r 1, p = r + b p 3
CG_VECTOR_PASSES = 12
#: float32 operations per row besides the product: two dots, three axpys
CG_VECTOR_FLOPS = 10


def kernel_share(run, kernel: str, launches_per_product: int, widths=None):
    """Percent of its roofline that ``kernel`` reached in the profiled
    stretch: the least time of the stretch's products ``A @ X`` (bytes and
    operations of the problem) over the kernel's device time.  ``widths``
    lists each product's width, one launch group per product; without
    it, each ``launches_per_product`` launches are one product of width 1.
    ``None`` when the stretch holds no launch of the kernel, or not the
    launches ``widths`` asks for."""
    if run.profile is None:
        return None
    launches, seconds = run.profile.kernel(kernel)
    if not launches or seconds <= 0:
        return None
    if widths is None:
        widths = [1] * (launches // launches_per_product)
    if launches != launches_per_product * len(widths):
        return None
    bound = sum(bound_s(spmv_bytes(run.counts, w), spmv_flops(run.counts, w), run.peaks) for w in widths)
    return 100.0 * bound / seconds


def cg_iteration_bytes(c: Dict[str, int]) -> int:
    return spmv_bytes(c) + CG_VECTOR_PASSES * F32 * c["n"]


def cg_iteration_flops(c: Dict[str, int]) -> int:
    return spmv_flops(c) + CG_VECTOR_FLOPS * c["n"]
