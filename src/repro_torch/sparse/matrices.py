"""Synthetic sparse matrices with SuiteSparse-like communication structure.

The paper benchmarks against large SuiteSparse matrices (audikw_1, thermal2,
Serena, ldoor, bone010, Geo_1438).  This container has no network access, so
we generate synthetic matrices that induce the same three *communication
regimes* the paper exercises:

* ``audikw_like``  -- banded FEM matrix with dense top rows / left columns
  ("high numbers of on-node and inter-node communication", paper §4.5).
* ``thermal_like`` -- 2D 5-point stencil: narrow band, many small neighbour
  messages (thermal2's "high inter-node message volume" regime).
* ``random_block`` -- uniformly random coupling: every rank talks to every
  rank (worst-case message count).

Matrices are CSR (``indptr``, ``indices``, ``data``) in plain numpy; no scipy
dependency.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    n: int
    indptr: np.ndarray  # [n+1] int64
    indices: np.ndarray  # [nnz] int32, column ids, sorted per row
    data: np.ndarray  # [nnz] float32

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def validate(self) -> "CSRMatrix":
        """Enforce the documented invariants; raises ``ValueError`` on a
        malformed matrix, returns ``self`` otherwise.

        Checked: ``indptr`` is ``[n+1]`` starting at 0 and non-decreasing,
        ``indices``/``data`` lengths match ``indptr[-1]``, column ids are in
        ``[0, n)``, and -- the invariant downstream code leans on
        (:func:`repro_torch.sparse.partition.partition_csr` canonical orders,
        bisection over rows) -- indices are strictly increasing within each
        row (sorted, no duplicates).  Generators call this under
        ``__debug__``; run ``python -O`` to skip the O(nnz) check.
        """
        indptr, indices, data = self.indptr, self.indices, self.data
        if indptr.shape != (self.n + 1,):
            raise ValueError(f"indptr shape {indptr.shape} != ({self.n + 1},)")
        if indptr[0] != 0 or (np.diff(indptr) < 0).any():
            raise ValueError("indptr must start at 0 and be non-decreasing")
        if indices.shape != (int(indptr[-1]),) or data.shape != indices.shape:
            raise ValueError(
                f"indices/data length {indices.shape}/{data.shape} "
                f"!= nnz {int(indptr[-1])}"
            )
        if indices.size and (indices.min() < 0 or indices.max() >= self.n):
            raise ValueError("column ids out of range [0, n)")
        # strictly increasing per row: every adjacent pair must increase
        # unless it straddles a row boundary
        d = np.diff(indices.astype(np.int64))
        within_row = np.ones(d.shape, dtype=bool)
        boundary = indptr[1:-1]
        boundary = boundary[(boundary > 0) & (boundary < indices.size)]
        within_row[boundary - 1] = False
        if (d[within_row] <= 0).any():
            bad = int(np.flatnonzero(within_row & (d <= 0))[0])
            row = int(np.searchsorted(indptr, bad, side="right")) - 1
            raise ValueError(
                f"indices not strictly sorted within row {row} "
                f"(positions {bad}, {bad + 1}: {indices[bad]}, {indices[bad + 1]})"
            )
        return self

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.data[s:e]

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n), dtype=np.float32)
        for i in range(self.n):
            cols, vals = self.row(i)
            out[i, cols] = vals
        return out

    def spmv(self, v: np.ndarray) -> np.ndarray:
        """Reference sequential SpMV."""
        out = np.zeros(self.n, dtype=np.result_type(self.data, v))
        for i in range(self.n):
            cols, vals = self.row(i)
            out[i] = (vals * v[cols]).sum()
        return out

    def spmm(self, V: np.ndarray) -> np.ndarray:
        """Reference sequential SpMM for a ``[n, k]`` right-hand side."""
        out = np.zeros((self.n, V.shape[1]), dtype=np.result_type(self.data, V))
        for i in range(self.n):
            cols, vals = self.row(i)
            out[i] = vals @ V[cols]
        return out


def _from_coo(
    n: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    duplicates: str = "first",
) -> CSRMatrix:
    """COO triplets -> CSR (rows lexsorted, per-row columns sorted).

    ``duplicates`` resolves repeated ``(row, col)`` entries: ``"first"``
    keeps the earliest occurrence in the input order (the generators'
    historical behavior), ``"sum"`` accumulates them (what matrix algebra
    like :func:`repro_torch.solve.problems.spd_system` needs).  Empty input is
    valid and yields an all-empty-rows matrix.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows * n + cols
    keep = np.ones(key.shape, dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    if duplicates == "sum":
        group = np.cumsum(keep) - 1
        summed = np.zeros(int(keep.sum()), dtype=np.float64)
        np.add.at(summed, group, vals.astype(np.float64))
        vals = summed
    elif duplicates == "first":
        vals = vals[keep]
    else:
        raise ValueError(f"duplicates must be 'first' or 'sum', got {duplicates!r}")
    rows, cols = rows[keep], cols[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    out = CSRMatrix(
        n=n,
        indptr=indptr,
        indices=cols.astype(np.int32),
        data=vals.astype(np.float32),
    )
    if __debug__:
        out.validate()
    return out


def banded(n: int, bandwidth: int, rng: np.random.Generator, fill: float = 0.6) -> CSRMatrix:
    """Random banded matrix: |i-j| <= bandwidth with density ``fill``."""
    rows_l, cols_l = [], []
    for i in range(n):
        lo, hi = max(0, i - bandwidth), min(n, i + bandwidth + 1)
        js = np.arange(lo, hi)
        mask = rng.random(js.size) < fill
        mask[js == i] = True  # keep the diagonal
        js = js[mask]
        rows_l.append(np.full(js.size, i))
        cols_l.append(js)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = rng.normal(size=rows.size)
    return _from_coo(n, rows, cols, vals)


def audikw_like(
    n: int, rng: np.random.Generator, bandwidth: int | None = None, dense_frac: float = 0.05
) -> CSRMatrix:
    """Banded + dense top rows and left columns (audikw_1's pattern, Fig 4.1)."""
    bandwidth = bandwidth or max(2, n // 32)
    base = banded(n, bandwidth, rng)
    k = max(1, int(n * dense_frac))
    extra_rows, extra_cols = [], []
    # dense top rows
    for i in range(k):
        js = np.where(rng.random(n) < 0.5)[0]
        extra_rows.append(np.full(js.size, i))
        extra_cols.append(js)
        # symmetric: dense left columns
        extra_rows.append(js)
        extra_cols.append(np.full(js.size, i))
    rows = np.concatenate(
        [np.repeat(np.arange(n), np.diff(base.indptr))] + extra_rows
    )
    cols = np.concatenate([base.indices] + extra_cols)
    vals = np.concatenate([base.data, rng.normal(size=rows.size - base.nnz)])
    return _from_coo(n, rows, cols, vals.astype(np.float32))


def thermal_like(n: int, rng: np.random.Generator) -> CSRMatrix:
    """2D 5-point stencil on a sqrt(n) x sqrt(n) grid (thermal2 regime)."""
    side = int(np.floor(np.sqrt(n)))
    n = side * side
    idx = np.arange(n)
    x, y = idx % side, idx // side
    rows_l, cols_l = [idx], [idx]
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nx, ny = x + dx, y + dy
        ok = (0 <= nx) & (nx < side) & (0 <= ny) & (ny < side)
        rows_l.append(idx[ok])
        cols_l.append((ny * side + nx)[ok])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = rng.normal(size=rows.size)
    return _from_coo(n, rows, cols, vals)


def random_block(n: int, density: float, rng: np.random.Generator) -> CSRMatrix:
    """Uniform random sparsity (all-to-all communication regime)."""
    nnz = max(n, int(n * n * density))
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    diag = np.arange(n)
    rows = np.concatenate([rows, diag])
    cols = np.concatenate([cols, diag])
    vals = rng.normal(size=rows.size)
    return _from_coo(n, rows, cols, vals)


GENERATORS: Dict[str, Callable[..., CSRMatrix]] = {
    "audikw_like": audikw_like,
    "thermal_like": thermal_like,
    "random_block": lambda n, rng: random_block(n, 16.0 / n, rng),
}
