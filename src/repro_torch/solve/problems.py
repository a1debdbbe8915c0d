"""Well-posed linear systems on the generators' communication structure.

The synthetic matrices in :mod:`repro_torch.sparse.matrices` reproduce the
*communication regimes* of the paper's SuiteSparse suite, but their values
are i.i.d. normal -- fine for one SpMV, hopeless for an iterative solve (CG
needs symmetric positive definite, BiCGStab at least needs a spectrum away
from zero).  These transforms keep (a superset of) the sparsity -- and hence
the exchange pattern character -- while making the values solvable:

* :func:`spd_system` -- graph-Laplacian-style symmetrization: SPD and
  diagonally dominant; the CG workload.
* :func:`shifted_system` -- diagonal shift to strict row dominance, original
  (generally nonsymmetric) off-diagonals kept; the BiCGStab workload.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sparse.matrices import CSRMatrix, _from_coo


def _to_coo(A: CSRMatrix):
    rows = np.repeat(np.arange(A.n), np.diff(A.indptr))
    return rows, A.indices.astype(np.int64), A.data.astype(np.float64)


def spd_system(A: CSRMatrix, shift: float = 1.0) -> CSRMatrix:
    """Symmetric positive-definite matrix on ``A``'s symmetrized sparsity.

    Off-diagonal ``(i, j)`` becomes ``-(|a_ij| + |a_ji|) / 2`` (negative,
    symmetric); the diagonal becomes ``shift + sum_j |offdiag_ij|`` -- a
    weighted graph Laplacian plus ``shift * I``, hence strictly diagonally
    dominant with positive diagonal => SPD.  The sparsity is the symmetric
    closure of ``A``'s, so the induced exchange pattern keeps the regime's
    structure (banded, stencil, random) with at most the mirrored entries
    added.
    """
    if shift <= 0:
        raise ValueError(f"shift must be > 0, got {shift}")
    rows, cols, vals = _to_coo(A)
    # symmetrize |A| via (|A| + |A|^T) / 2 on the union sparsity
    r2 = np.concatenate([rows, cols])
    c2 = np.concatenate([cols, rows])
    v2 = np.concatenate([np.abs(vals), np.abs(vals)]) * 0.5
    off = r2 != c2
    W = _from_coo(A.n, r2[off], c2[off], v2[off], duplicates="sum")
    wrows = np.repeat(np.arange(W.n), np.diff(W.indptr))
    degree = np.zeros(A.n, dtype=np.float64)
    np.add.at(degree, wrows, W.data.astype(np.float64))
    rows3 = np.concatenate([wrows, np.arange(A.n)])
    cols3 = np.concatenate([W.indices.astype(np.int64), np.arange(A.n)])
    vals3 = np.concatenate([-W.data.astype(np.float64), shift + degree])
    return _from_coo(A.n, rows3, cols3, vals3, duplicates="sum")


def shifted_system(A: CSRMatrix, margin: float = 0.5) -> CSRMatrix:
    """Strictly row-diagonally-dominant (generally nonsymmetric) system.

    Keeps every off-diagonal of ``A`` and sets the diagonal to
    ``margin + sum_j |a_ij|`` (row-wise), which bounds every eigenvalue away
    from zero (Gershgorin) without touching the communication structure.
    """
    if margin <= 0:
        raise ValueError(f"margin must be > 0, got {margin}")
    rows, cols, vals = _to_coo(A)
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    rowsum = np.zeros(A.n, dtype=np.float64)
    np.add.at(rowsum, rows, np.abs(vals))
    diag = np.arange(A.n)
    return _from_coo(
        A.n,
        np.concatenate([rows, diag]),
        np.concatenate([cols, diag]),
        np.concatenate([vals, margin + rowsum]),
        duplicates="sum",
    )
