"""``stencil2d_spd``: a stencil on a ``side x side`` grid with N(0, 1)
values, put through a copy of ``repro_torch.solve.problems.spd_system``'s
transform: off-diagonal ``-(|a_ij| + |a_ji|) / 2``, diagonal ``shift +
sum_j |off_ij|``.  The stencil is the node and its neighbours at the
configuration's ``offsets`` (``[dx, dy]`` pairs, each with its mirror);
without ``offsets`` it is the 5-point stencil, and the matrix is a copy of
``repro_torch.sparse.matrices.thermal_like`` through that transform.  The
two diagonal neighbours ``[1, 1]`` and ``[-1, -1]`` added to the 5-point
stencil give the P1 (linear triangle) element's 7-point stencil.  Sizes:
``side``, ``shift``, ``offsets``."""

from __future__ import annotations

import numpy as np

from portbench.inputs import CSR, host_rng


def _from_coo(n: int, rows, cols, vals, duplicates: str) -> CSR:
    """COO triplets -> CSR, rows lexsorted and columns sorted per row;
    repeated ``(row, col)`` entries keep the first (``"first"``) or are
    summed (``"sum"``)."""
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
    else:
        vals = vals[keep]
    rows, cols = rows[keep], cols[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return CSR(n=n, indptr=np.cumsum(indptr), indices=cols.astype(np.int32),
               data=vals.astype(np.float32))


#: the 5-point stencil's neighbours, in ``thermal_like``'s order
FIVE_POINT = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _stencil2d(side: int, offsets, rng: np.random.Generator) -> CSR:
    """The node and its neighbours at ``offsets`` on a ``side x side`` grid
    with N(0, 1) values."""
    n = side * side
    idx = np.arange(n)
    x, y = idx % side, idx // side
    rows_l, cols_l = [idx], [idx]
    for dx, dy in offsets:
        nx, ny = x + dx, y + dy
        ok = (0 <= nx) & (nx < side) & (0 <= ny) & (ny < side)
        rows_l.append(idx[ok])
        cols_l.append((ny * side + nx)[ok])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    return _from_coo(n, rows, cols, rng.normal(size=rows.size), duplicates="first")


def _spd(A: CSR, shift: float) -> CSR:
    """Weighted graph Laplacian of ``(|A| + |A|^T) / 2`` plus ``shift * I``."""
    rows = np.repeat(np.arange(A.n), np.diff(A.indptr))
    cols, vals = A.indices.astype(np.int64), A.data.astype(np.float64)
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


def offsets_of(cfg: dict) -> tuple:
    offsets = tuple(tuple(int(d) for d in o) for o in cfg.get("offsets", FIVE_POINT))
    if sorted(offsets) != sorted((-dx, -dy) for dx, dy in offsets) or (0, 0) in offsets:
        raise ValueError(f"offsets must come with their mirrors and leave out [0, 0]: {offsets}")
    return offsets


def make(cfg: dict, seed: int) -> CSR:
    return _spd(_stencil2d(int(cfg["side"]), offsets_of(cfg), host_rng(seed, 0)), float(cfg["shift"]))


def nnz(side: int, offsets=FIVE_POINT) -> int:
    """Stored nonzeros of :func:`stencil2d_spd`: one per node, and one per
    node whose neighbour at each offset lies on the grid."""
    return side * side + sum((side - abs(dx)) * (side - abs(dy)) for dx, dy in offsets)
