"""Row-wise partitioning of a sparse matrix for distributed SpMV (paper §2.4.1).

``A``, ``v``, ``w`` are partitioned row-wise across ``g`` ranks with
contiguous rows per rank.  Each rank's rows split into the **on-rank block**
(columns it owns) and the **off-rank block** (columns owned elsewhere); the
off-rank column set induces the irregular point-to-point pattern
(:class:`repro_torch.comm.exchange.ExchangePattern`) the paper studies.

Local storage is blocked-ELL (rows x max_nnz_per_row), the layout consumed by
:mod:`repro_torch.kernels.spmv_ell`: column ids of the off-rank block are
rewritten to positions in the canonical halo buffer produced by the exchange.

:func:`partition_csr` is a vectorised rewrite of the reference's per-nonzero
loop; it produces bitwise the same arrays and pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm.exchange import ExchangePattern, Need
from repro_torch.comm.topology import PodTopology
from repro_torch.sparse.matrices import CSRMatrix


@dataclasses.dataclass(frozen=True)
class EllBlock:
    """Padded ELL block: ``w[i] += sum_k data[i,k] * x[cols[i,k]]``.

    Padding entries have ``data == 0`` and ``cols == 0``.
    """

    data: np.ndarray  # [rows, K] float32
    cols: np.ndarray  # [rows, K] int32


@dataclasses.dataclass(frozen=True)
class SpmvPartition:
    """Everything each rank needs, stacked over ranks (leading dim nranks)."""

    topo: PodTopology
    rows_per_rank: int
    pattern: ExchangePattern
    # stacked blocked-ELL storage, one slice per rank:
    diag: EllBlock  # cols index into the rank's own v slice [0, L)
    off: EllBlock  # cols index into the canonical halo buffer [0, H)
    halo_width: int
    #: structural off-rank nonzeros per row ``[nranks * L]`` -- the
    #: interior/boundary classifier for split-phase compute (a row with 0
    #: has a pure-padding off-ELL row, including explicitly stored zeros)
    off_row_nnz: np.ndarray
    #: ``None``: the arrays above hold every rank's rows; a rank's number:
    #: they hold that rank's ``L`` rows alone (:func:`rank_partition`)
    held: Optional[int] = None

    @property
    def n(self) -> int:
        return self.topo.nranks * self.rows_per_rank


@dataclasses.dataclass(frozen=True)
class RankSlice:
    """One rank's share of an :class:`SpmvPartition`, for a process that
    holds that rank alone: its ELL blocks as ``[1, L, K]`` and its rows'
    structural off-rank counts ``[1, L]``.  The pattern stays the whole
    partition's, since every rank plans the whole exchange."""

    rank: int
    diag: EllBlock
    off: EllBlock
    off_row_nnz: np.ndarray


def rank_slice(part: SpmvPartition, rank: int) -> RankSlice:
    """World rank ``rank``'s rows of ``part`` (see :class:`RankSlice`)."""
    if not 0 <= rank < part.topo.nranks:
        raise ValueError(f"rank {rank} is not in {part.topo}")
    if part.held not in (None, rank):
        raise ValueError(f"the partition holds rank {part.held}'s rows alone, not rank {rank}'s")
    L = part.rows_per_rank
    first = 0 if part.held is not None else rank * L
    rows = slice(first, first + L)

    def block(b: EllBlock) -> EllBlock:
        return EllBlock(data=b.data[rows][None], cols=b.cols[rows][None])

    return RankSlice(rank=rank, diag=block(part.diag), off=block(part.off),
                     off_row_nnz=part.off_row_nnz[rows][None])


def rank_partition(part: SpmvPartition, rank: int) -> SpmvPartition:
    """``part`` as a process that holds rank ``rank`` alone needs it: the
    topology, pattern and widths whole, the ELL blocks and off-rank counts
    of its own rows only (``held=rank``).  :func:`rank_slice` of it is
    bitwise that of ``part``; it serves ``DistributedSpMV(group=)`` of that
    rank, and no stacked operator."""
    s = rank_slice(part, rank)

    def block(b: EllBlock) -> EllBlock:
        return EllBlock(data=np.ascontiguousarray(b.data[0]), cols=np.ascontiguousarray(b.cols[0]))

    return dataclasses.replace(part, diag=block(s.diag), off=block(s.off),
                               off_row_nnz=np.ascontiguousarray(s.off_row_nnz[0]), held=rank)


def _slot_in_row(sel: np.ndarray, rows: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """For the entries picked by ``sel`` (in CSR order): their slot within
    their row's picked entries, and the picked count per row."""
    counts = np.bincount(rows[sel], minlength=n)
    csum = np.cumsum(sel)
    before = np.concatenate([[0], np.cumsum(counts)])[rows]
    return (csum - 1 - before)[sel], counts


def partition_csr(matrix: CSRMatrix, topo: PodTopology) -> SpmvPartition:
    """Partition ``matrix`` row-wise over ``topo.nranks`` ranks."""
    g = topo.nranks
    if matrix.n % g:
        raise ValueError(f"matrix dim {matrix.n} not divisible by {g} ranks")
    n = matrix.n
    L = n // g
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(matrix.indptr))
    cols = matrix.indices.astype(np.int64)
    rank = rows // L
    owner = cols // L
    on = owner == rank
    off = ~on

    # 1. per-rank column dependencies -> exchange pattern; a need's token
    # code (dst, src, elem) sorts exactly like the canonical recv layout
    code = (rank[off] * g + owner[off]) * L + (cols[off] - owner[off] * L)
    uniq = np.unique(code)
    pair = uniq // L
    elem = uniq - pair * L
    starts = np.flatnonzero(np.diff(pair, prepend=-1))
    ends = np.append(starts[1:], len(uniq))
    needs = tuple(
        Need(
            dst=int(pair[s] // g),
            src=int(pair[s] % g),
            idx=tuple(elem[s:e].tolist()),
        )
        for s, e in zip(starts, ends)
    )
    pattern = ExchangePattern(topo=topo, local_size=L, needs=needs)
    H = max(pattern.max_recv_size(), 1)

    # 2. canonical halo position of every off-rank entry: its index among
    # the sorted (dst, src, elem) codes, minus where its dst's run begins
    dst_first = np.searchsorted(pair // g, np.arange(g))
    halo_pos = np.searchsorted(uniq, code) - dst_first[rank[off]]

    # 3. per-rank ELL blocks with rewritten column ids
    di, on_count = _slot_in_row(on, rows, n)
    oi, off_count = _slot_in_row(off, rows, n)
    kd = max(1, int(on_count.max(initial=0)))
    ko = max(1, int(off_count.max(initial=0)))

    diag_data = np.zeros((n, kd), dtype=np.float32)
    diag_cols = np.zeros((n, kd), dtype=np.int32)
    off_data = np.zeros((n, ko), dtype=np.float32)
    off_cols = np.zeros((n, ko), dtype=np.int32)
    diag_data[rows[on], di] = matrix.data[on]
    diag_cols[rows[on], di] = cols[on] - rank[on] * L
    off_data[rows[off], oi] = matrix.data[off]
    off_cols[rows[off], oi] = halo_pos

    return SpmvPartition(
        topo=topo,
        rows_per_rank=L,
        pattern=pattern,
        diag=EllBlock(data=diag_data, cols=diag_cols),
        off=EllBlock(data=off_data, cols=off_cols),
        halo_width=H,
        off_row_nnz=off_count.astype(np.int64),
    )


def partition_from_arrays(
    topo_shape: Tuple[int, int],
    rows_per_rank: int,
    needs: Sequence[Tuple[int, int, Sequence[int]]],
    diag: Tuple[np.ndarray, np.ndarray],
    off: Tuple[np.ndarray, np.ndarray],
    halo_width: int,
    off_row_nnz: np.ndarray,
) -> SpmvPartition:
    """Rebuild a :class:`SpmvPartition` from plain arrays and tuples.

    Carries a partition made elsewhere (for example by the JAX reference
    package) into the port without importing it: ``topo_shape`` is
    ``(npods, ppn)``, ``needs`` lists ``(dst, src, idx)`` triples, and
    ``diag`` / ``off`` are ``(data, cols)`` pairs of ``[nranks * L, K]``
    arrays.
    """
    npods, ppn = topo_shape
    topo = PodTopology(npods=int(npods), ppn=int(ppn))
    pattern = ExchangePattern(
        topo=topo,
        local_size=int(rows_per_rank),
        needs=tuple(
            Need(dst=int(d), src=int(s), idx=tuple(int(i) for i in idx))
            for d, s, idx in needs
        ),
    )

    def block(pair) -> EllBlock:
        data, cols = pair
        return EllBlock(
            data=np.ascontiguousarray(data, dtype=np.float32),
            cols=np.ascontiguousarray(cols, dtype=np.int32),
        )

    return SpmvPartition(
        topo=topo,
        rows_per_rank=int(rows_per_rank),
        pattern=pattern,
        diag=block(diag),
        off=block(off),
        halo_width=int(halo_width),
        off_row_nnz=np.asarray(off_row_nnz, dtype=np.int64),
    )
