"""CSR products and textbook CG in plain PyTorch, computed in blocks of rows.

Everything runs in the dtype it is given: float64 for the reference, a
lower precision (bfloat16) for the control that stands in for a program
computing below the configuration's float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

#: nonzeros per block of rows: bounds the ``[nnz, k]`` products held at once
BLOCK_NNZ = 1 << 22


@dataclasses.dataclass
class DeviceCSR:
    """The benchmark's CSR on ``device``: row pointers on the host (block
    bounds), column ids and values on the device, values in ``dtype``."""

    n: int
    indptr: np.ndarray
    indices: torch.Tensor
    data: torch.Tensor

    @staticmethod
    def of(A, device, dtype=torch.float64) -> "DeviceCSR":
        return DeviceCSR(
            n=int(A.n),
            indptr=np.asarray(A.indptr, dtype=np.int64),
            indices=torch.as_tensor(np.asarray(A.indices), device=device).long(),
            data=torch.as_tensor(np.asarray(A.data), device=device).to(dtype),
        )

    def blocks(self, block_nnz: int = BLOCK_NNZ):
        """``(r0, r1)`` row ranges of about ``block_nnz`` nonzeros each."""
        r0 = 0
        while r0 < self.n:
            target = self.indptr[r0] + block_nnz
            r1 = int(np.searchsorted(self.indptr, target, side="right")) - 1
            r1 = min(max(r1, r0 + 1), self.n)
            yield r0, r1
            r0 = r1


def csr_matmul(A: DeviceCSR, X: torch.Tensor, absolute: bool = False,
               block_nnz: int = BLOCK_NNZ) -> torch.Tensor:
    """``A @ X`` (or ``|A| @ |X|``) for ``X: [n]`` or ``[n, k]``, in ``X``'s
    dtype, one block of rows at a time."""
    vec = X.ndim == 1
    Xm = X[:, None] if vec else X
    data = A.data.to(X.dtype)
    if absolute:
        data, Xm = data.abs(), Xm.abs()
    out = torch.zeros((A.n, Xm.shape[1]), dtype=X.dtype, device=X.device)
    for r0, r1 in A.blocks(block_nnz):
        p0, p1 = int(A.indptr[r0]), int(A.indptr[r1])
        counts = torch.as_tensor(np.diff(A.indptr[r0:r1 + 1]), device=X.device)
        rows = torch.repeat_interleave(torch.arange(r1 - r0, device=X.device), counts)
        out[r0:r1].index_add_(0, rows, data[p0:p1, None] * Xm[A.indices[p0:p1]])
    return out[:, 0] if vec else out


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: int  # the first iteration whose relative residual met ``tol``
    converged: bool
    residuals: Tuple[float, ...]


def cg(A: DeviceCSR, b: torch.Tensor, tol: float, maxiter: int,
       run_to: Optional[float] = None) -> CGResult:
    """Textbook CG from ``x0 = 0`` in ``b``'s dtype.  It stops once the
    relative recursive residual ``||r_k|| / ||b||`` is at most ``run_to``
    (default ``tol``) or after ``maxiter`` iterations; ``iterations`` is the
    first ``k`` whose residual met ``tol``, and ``x`` the last iterate."""
    stop = tol if run_to is None else run_to
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    bnorm = float(torch.sqrt(rs))
    hist = [1.0]
    met = 0 if hist[0] <= tol else None
    it = 0
    while hist[-1] > stop and it < maxiter:
        q = csr_matmul(A, p)
        alpha = rs / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        rs_new = torch.dot(r, r)
        it += 1
        hist.append(float(torch.sqrt(rs_new)) / bnorm)
        if met is None and hist[-1] <= tol:
            met = it
        p = r + (rs_new / rs) * p
        rs = rs_new
    converged = met is not None
    return CGResult(x=x, iterations=met if converged else it, converged=converged,
                    residuals=tuple(hist))
