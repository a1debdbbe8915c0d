"""Distributed SpMV/SpMM with pluggable node-aware communication (paper §2.4, §5).

``A`` is row-partitioned over ``nranks`` ranks, all held as one stacked
tensor on one device; each step is

    halo = exchange(v)                      # irregular p2p, chosen strategy
    w    = A_diag @ v_local + A_off @ halo  # local blocked-ELL SpMV

The exchange is an :class:`repro_torch.comm.strategies.IrregularExchange`
planned by the selected strategy; ``strategy="auto"`` asks the model-driven
advisor (paper §4.6) to pick on the paper's GPU machine, ``lassen``.  The
local compute is the hand-written blocked-ELL kernels of
:mod:`repro_torch.kernels.spmv_ell` on CUDA, and their plain versions on the
CPU.  Each block is one launch over all ranks.

``group=`` (an :class:`~repro_torch.comm.topology.ExchangeGroup`) holds one
rank per process instead: this rank's ``[1, L, K]`` blocks on its device
(:func:`repro_torch.sparse.partition.rank_slice`), ``v [1, L] -> w [1, L]``,
the exchange's hops gloo collectives, B1/B2 launched at ``g = 1``.  Every
row is computed by the same code as in the stacked operator, so ``w`` is
bitwise its row of the stacked product.

Multi-vector products (``V: [nranks, L, k]``) move all ``k`` columns in one
exchange under the single cached plan and run one SpMM per block
(:meth:`DistributedSpMV.matmat`).

``overlap=True`` replaces the barrier step with the split-phase pipeline:

    handle = exchange.start(v)   # inter-pod phase on a side stream
    w_diag = A_diag @ v_local    # every row tile, while it is in flight
    halo   = handle.finish()
    w_off  = A_off @ halo        # boundary row tiles only
    w      = w_diag + w_off

The boundary row set -- rows whose off-rank ELL row holds a stored entry
(structural ``off_row_nnz``) -- comes from
:func:`repro_torch.core.split_plan.split_rows` at the kernel's own row-tile
size.  Barrier and overlap both compute ``K(diag) + K(off)`` with the same
kernel, and a masked tile is exactly an unmasked tile's code, so the two
agree bitwise for every strategy (interior tiles' off rows are pure padding:
``0 * x[0]`` sums to +0 exactly as a skipped tile's zero does, for finite
inputs).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.comm import strategies as comm_strategies
from repro_torch.comm.strategies import IrregularExchange
from repro_torch.comm.topology import PodTopology
from repro_torch.core.advisor import EXECUTABLE_STRATEGY, advise
from repro_torch.core.device import DeviceLike, as_device_tensor, device_for_rank, resolve_device
from repro_torch.core.split_plan import RowPhaseSplit, split_rows
from repro_torch.kernels.spmv_ell import TILE_R, TILE_R_MM, spmm_ell, spmv_ell
from repro_torch.sparse.matrices import CSRMatrix
from repro_torch.sparse.partition import SpmvPartition, partition_csr, rank_slice

#: the machine the advisor ranks strategies on: the paper's GPU machine,
#: until H100 link and copy parameters are measured
ADVISOR_MACHINE = "lassen"

# ---------------------------------------------------------------------------
# Local-compute program cache
# ---------------------------------------------------------------------------

#: local-compute programs keyed by ``(pattern fingerprint, width, flavor,
#: device)``: one entry per (fingerprint, k), accounted under
#: ``compute_hits`` / ``compute_misses`` of
#: :func:`repro_torch.comm.cache_stats`
_COMPUTE_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
COMPUTE_CACHE_MAX = 64
comm_strategies.register_cache(_COMPUTE_CACHE)


def _barrier_compute(v, halo, dd, dc, od, oc):
    return spmv_ell(dd, dc, v) + spmv_ell(od, oc, halo)


def _barrier_compute_mm(V, halo, dd, dc, od, oc):
    return spmm_ell(dd, dc, V) + spmm_ell(od, oc, halo)


def _compute_program(fingerprint: str, device: torch.device, width: Optional[int], phase: bool):
    """The local-compute callable for one (pattern, width, flavor, device).

    ``width=None`` is the vector program, ``width=k`` the SpMM one;
    ``phase`` selects the tile-masked one-block kernel of the overlapped
    pipeline instead of the barrier's ``diag + off`` program.
    """
    key = (fingerprint, width, "phase" if phase else "barrier", str(device))

    def build():
        if phase:
            return spmv_ell if width is None else spmm_ell
        return _barrier_compute if width is None else _barrier_compute_mm

    return comm_strategies.compute_cached(_COMPUTE_CACHE, key, COMPUTE_CACHE_MAX, build)


@dataclasses.dataclass
class DistributedSpMV:
    """A distributed SpMV/SpMM for one matrix, topology and strategy.

    ``device`` is where the stacked ranks live; ``None`` means the CUDA
    device (a machine without one raises), ``"cpu"`` runs the plain
    versions of the kernels.  ``payload_width`` is the multi-vector column
    count ``k`` fed to the advisor when ``strategy="auto"``.

    ``overlap=True`` switches ``__call__`` / :meth:`matmat` to the
    split-phase pipeline (see the module docstring); the result equals the
    barrier path's bitwise.

    ``wire`` selects the exchange's inter-pod codec
    (:data:`repro_torch.comm.wire.WIRE_CODECS`): halo values arriving from
    other pods carry the codec's pinned error bound while on-pod halo values
    stay full precision; ``"none"`` is the exact movement.  ``wire="auto"``
    lets the advisor rank ``+wire:<codec>`` variants and picks the codec
    jointly with the strategy (``strategy="auto"``) or the fastest codec for
    a fixed strategy.  ``verify``, ``faults`` and ``health`` go to the
    exchange (:class:`repro_torch.comm.strategies.IrregularExchange`): wire
    checks, seeded fault injection, and the recovery ladder's health
    tracker, which the operator shares as ``self.health`` (the solvers read
    its recoveries into their status).

    ``group`` (an :class:`~repro_torch.comm.topology.ExchangeGroup`) makes
    the operator one rank of a process group: ``[1, L(, k)]`` operands on
    ``device`` (left out, ``cuda:(rank % device_count)``), the solvers'
    reductions the on-pod-then-inter-pod tree over the group
    (:class:`~repro_torch.solve.reductions.GroupReductions`).  ``auto``
    picks the same strategy on every rank, and the exchange checks that
    the ranks' plans, checks, fault plans and ladder settings agree; the
    ranks agree on every checked call's violations, so ``verify``,
    ``faults`` and ``health`` take the same recovery on every rank.

    Example::

        import numpy as np
        from repro_torch.comm import PodTopology
        from repro_torch.sparse import build, thermal_like

        A = thermal_like(256, np.random.default_rng(0))
        topo = PodTopology(npods=2, ppn=4)
        sp = build(A, topo, strategy="auto", payload_width=8, overlap=True, device="cpu")
        V = np.ones((A.n, 8), np.float32)
        W = sp.matmat(V.reshape(topo.nranks, -1, 8))  # ONE exchange, overlapped
    """

    partition: SpmvPartition
    strategy: str = "auto"
    message_cap_bytes: int = 16384
    device: DeviceLike = None
    fuse_program: bool = True
    payload_width: int = 1
    overlap: bool = False
    wire: str = "none"
    verify: bool = False
    faults: Optional[object] = None
    health: Optional[object] = None
    group: Optional[object] = None

    def __post_init__(self) -> None:
        if self.group is None and self.partition.held is not None:
            raise ValueError(f"the partition holds rank {self.partition.held}'s rows alone: it needs group=")
        if self.group is not None and self.device is None:
            self.device = device_for_rank(self.group.rank)
        self.device = resolve_device(self.device)
        if self.strategy == "auto" or self.wire == "auto":
            self.advice = advise(
                self.partition.pattern.to_comm_pattern(),
                machine=ADVISOR_MACHINE,
                payload_width=self.payload_width,
                # "auto" ranks every codec; a fixed codec constrains the
                # candidate set; "none" keeps the paper's ranking
                wire="auto" if self.wire == "auto" else (
                    None if self.wire == "none" else self.wire
                ),
            )
            best = self.advice.best
            if self.strategy != "auto":
                # wire="auto" with a pinned strategy: the fastest codec among
                # this strategy's own variants
                best = next(
                    (r for r in self.advice.ranked
                     if EXECUTABLE_STRATEGY[r.strategy] == self.strategy),
                    None,
                )
                if best is None:
                    raise ValueError(
                        f"unknown strategy {self.strategy!r}; known: "
                        f"{sorted(set(EXECUTABLE_STRATEGY.values()))}"
                    )
            self.strategy = EXECUTABLE_STRATEGY[best.strategy]
            if self.wire == "auto":
                self.wire = best.wire
        else:
            self.advice = None
        self.exchange = IrregularExchange(
            self.partition.pattern,
            self.strategy,
            device=self.device,
            message_cap_bytes=self.message_cap_bytes,
            fuse_program=self.fuse_program,
            wire=self.wire,
            verify=self.verify,
            faults=self.faults,
            health=self.health,
            group=self.group,
        )
        # the exchange owns (and may have created) the shared tracker
        self.health = self.exchange.health
        g, L = self.ranks_held, self.rows_per_rank

        def dev(a: np.ndarray) -> torch.Tensor:
            return as_device_tensor(a.reshape(g, L, -1), self.device)

        part = self.partition if self.group is None else rank_slice(self.partition, self.group.rank)
        self._off_row_nnz = part.off_row_nnz
        self._blocks = (
            dev(part.diag.data), dev(part.diag.cols), dev(part.off.data), dev(part.off.cols)
        )
        self._fingerprint = self.partition.pattern.fingerprint()
        self._compute = _compute_program(self._fingerprint, self.device, None, False)
        #: per-instance memo over the module LRU, keyed by (k, phase)
        self._mm_programs: dict = {}
        self._row_splits: dict = {}
        if self.overlap:
            self._phase_fn = _compute_program(self._fingerprint, self.device, None, True)
            self._bnd_v = self._boundary_mask(self.row_split)
            self._bnd_mm = self._boundary_mask(self.row_split_mm)

    def _row_split(self, tile_rows: int) -> RowPhaseSplit:
        """Interior/boundary row split (the overlap enabler), lazily built.

        Structural: a row is boundary iff its off-rank ELL row holds a stored
        entry (``off_row_nnz > 0``), so the split never depends on values.
        """
        split = self._row_splits.get(tile_rows)
        if split is None:
            halo_dep = self._off_row_nnz.reshape(self.ranks_held, self.rows_per_rank) > 0
            split = self._row_splits[tile_rows] = split_rows(halo_dep, tile_rows)
        return split

    @property
    def row_split(self) -> RowPhaseSplit:
        """Row split at the SpMV kernel's tile size."""
        return self._row_split(TILE_R)

    @property
    def row_split_mm(self) -> RowPhaseSplit:
        """Row split at the SpMM kernel's tile size."""
        return self._row_split(TILE_R_MM)

    def _boundary_mask(self, split: RowPhaseSplit) -> torch.Tensor:
        """``[g, ntiles]`` int32 tile mask of the off pass (boundary tiles)."""
        return as_device_tensor(split.boundary_tiles.astype(np.int32), self.device)

    # ------------------------------------------------------------------
    def __call__(self, v) -> torch.Tensor:
        """``v [nranks, L] -> w [nranks, L]`` (``[1, L]`` under a group); a
        trailing feature dim (``[nranks, L, k]``) dispatches to
        :meth:`matmat`."""
        v = as_device_tensor(v, self.device)
        if v.ndim == 3:
            return self.matmat(v)
        dd, dc, od, oc = self._blocks
        with tracing.span("repro_torch.spmv.matvec"):
            if not self.overlap:
                halo = self.exchange(v)
                with tracing.span("repro_torch.spmv.compute"):
                    return self._compute(v, halo, dd, dc, od, oc)
            handle = self.exchange.start(v)
            # the whole halo-independent diag block runs while the inter-pod
            # phase is in flight; only boundary tiles' off block waits on it
            with tracing.span("repro_torch.spmv.compute"):
                w_diag = self._phase_fn(dd, dc, v)
            halo = handle.finish()
            with tracing.span("repro_torch.spmv.compute"):
                return w_diag + self._phase_fn(od, oc, halo, self._bnd_v)

    def matmat(self, V) -> torch.Tensor:
        """``V [nranks, L, k] -> W [nranks, L, k]`` under ONE exchange.

        All ``k`` columns ride the single cached plan and the local compute
        is one SpMM launch per block.  With ``overlap=True`` the exchange is
        split-phase and the diag-block SpMM runs during the inter-pod phase.
        """
        V = as_device_tensor(V, self.device)
        if V.ndim != 3:
            raise ValueError(f"matmat expects [nranks, L, k], got {tuple(V.shape)}")
        k = int(V.shape[2])
        fn = self._mm_programs.get((k, self.overlap))
        if fn is None:
            fn = self._mm_programs[(k, self.overlap)] = _compute_program(
                self._fingerprint, self.device, k, self.overlap
            )
        dd, dc, od, oc = self._blocks
        with tracing.span("repro_torch.spmv.matmat"):
            if not self.overlap:
                halo = self.exchange(V)
                with tracing.span("repro_torch.spmv.compute"):
                    return fn(V, halo, dd, dc, od, oc)
            handle = self.exchange.start(V)
            with tracing.span("repro_torch.spmv.compute"):
                w_diag = fn(dd, dc, V)
            halo = handle.finish()
            with tracing.span("repro_torch.spmv.compute"):
                return w_diag + fn(od, oc, halo, self._bnd_mm)

    def matmat_looped(self, V) -> torch.Tensor:
        """Per-column baseline: ``k`` exchanges + ``k`` local SpMVs."""
        V = as_device_tensor(V, self.device)
        if V.ndim != 3:
            raise ValueError(f"matmat_looped expects [nranks, L, k], got {tuple(V.shape)}")
        cols = [self(V[:, :, c]) for c in range(V.shape[2])]
        return torch.stack(cols, dim=-1)

    def halo(self, v) -> torch.Tensor:
        """Exchange-only entry point (``[nranks, L, *feat]`` payloads)."""
        return self.exchange(v)

    # ------------------------------------------------------------------
    @property
    def topo(self) -> PodTopology:
        return self.partition.topo

    @property
    def rows_per_rank(self) -> int:
        return self.partition.rows_per_rank

    @property
    def ranks_held(self) -> int:
        """The leading dim of this operator's operands: every rank, or 1
        under a process group."""
        return self.topo.nranks if self.group is None else 1

    @property
    def wire_bytes(self) -> Tuple[int, int]:
        return self.exchange.wire_bytes


def build(matrix: CSRMatrix, topo: PodTopology, strategy: str = "auto", **kw) -> DistributedSpMV:
    return DistributedSpMV(partition_csr(matrix, topo), strategy=strategy, **kw)


def reference(matrix: CSRMatrix, v_flat: np.ndarray) -> np.ndarray:
    """Sequential oracle on the unpartitioned matrix."""
    return matrix.spmv(v_flat)


def reference_mm(matrix: CSRMatrix, V_flat: np.ndarray) -> np.ndarray:
    """Sequential multi-vector oracle on the unpartitioned matrix."""
    return matrix.spmm(V_flat)
