"""The SpMV operators of the solvers: a numpy executor and a capturable matvec.

:class:`NumpySpMV` runs the SAME planned stage programs as the torch
executor -- the plan comes from the module plan cache
(:func:`repro_torch.comm.strategies.planned`), the exchange runs through
:func:`repro_torch.comm.exchange.execute_numpy` (the bit-exact numpy oracle
of :class:`~repro_torch.comm.strategies.IrregularExchange`), and the local
compute is the blocked-ELL contraction in plain numpy.  Because every
strategy delivers the identical canonical halo buffer, a Krylov solve on
this operator produces *bitwise-identical* residual histories across
strategies and across barrier-vs-split-phase execution.

``overlap=True`` exercises the split-phase decomposition: the pattern is
factored through the module ``_SPLIT_CACHE``
(:func:`repro_torch.comm.strategies._split_phase_cached`, visible as
``split_hits``/``split_misses`` in :func:`repro_torch.comm.cache_stats`),
the on-pod and inter-pod sub-plans execute separately, and
:func:`repro_torch.comm.exchange.merge_split_phase` reassembles the halo --
bit-identical to the barrier buffer (nothing runs concurrently here; the
decomposition is what is being exercised).

:func:`traceable_operator` lowers either operator flavor (a
:class:`~repro_torch.sparse.spmv.DistributedSpMV` or a :class:`NumpySpMV`)
to a :class:`TraceableOperator`: a matvec ``v [g, L] -> (w [g, L], viols)``
on one device that can be captured into a CUDA graph.  Everything it needs
-- plan indices, fault masks, merge maps, tile masks, the side stream of the
split-phase path -- is made when it is built, so a call reads nothing back
from the device, sleeps nowhere, copies nothing from the host and creates
no stream, library or cache entry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import faults as faults_mod
from repro_torch.comm import strategies as comm_strategies
from repro_torch.comm import wire as wire_mod
from repro_torch.comm.exchange import execute_numpy, merge_split_phase
from repro_torch.comm.hops import run_hops
from repro_torch.comm.topology import PodTopology
from repro_torch.core.device import DeviceLike, as_device_tensor, resolve_device
from repro_torch.core.split_plan import split_rows
from repro_torch.kernels.spmv_ell import TILE_R, spmv_ell
from repro_torch.sparse.partition import SpmvPartition


def _ell_matvec(data: np.ndarray, cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Blocked-ELL contraction over stacked ranks.

    ``data``/``cols``: ``[g, L, K]``; ``x``: ``[g, W]`` (per-rank source
    vector or halo buffer).  Padding slots have ``data == 0, cols == 0`` and
    contribute exact zeros.
    """
    g = x.shape[0]
    gathered = x[np.arange(g)[:, None, None], cols]  # [g, L, K]
    return (data * gathered).sum(axis=2)


@dataclasses.dataclass
class NumpySpMV:
    """One matrix + topology + strategy, executed without torch.

    Mirrors :class:`repro_torch.sparse.spmv.DistributedSpMV`'s call contract
    for vectors (``v [nranks, L] -> w [nranks, L]``) and shares its plan
    cache, so a solve on either operator re-plans nothing and the
    one-plan-per-solve property is measurable via
    ``repro_torch.comm.cache_stats()``.
    """

    partition: SpmvPartition
    strategy: str = "standard"
    message_cap_bytes: int = 16384
    overlap: bool = False
    #: inter-pod wire codec (repro_torch.comm.wire); "none" keeps the bitwise
    #: residual-history property across strategies, lossy codecs trade the
    #: pinned per-element halo error bound for 2-4x fewer inter-pod bytes
    wire: str = "none"
    #: opt-in wire integrity verification; a failed check engages the
    #: retry -> codec-demotion -> strategy-re-advise ladder
    #: (:func:`repro_torch.comm.faults.run_ladder`)
    verify: bool = False
    #: seeded deterministic fault injection (repro_torch.comm.faults.FaultPlan)
    faults: Optional[faults_mod.FaultPlan] = None
    #: shared health tracker; created on demand when verify/faults are set
    health: Optional[faults_mod.HealthTracker] = None
    max_retries: int = 1
    fallback: bool = True

    def __post_init__(self) -> None:
        if self.strategy not in comm_strategies.STRATEGY_NAMES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; "
                f"known: {comm_strategies.STRATEGY_NAMES}"
            )
        wire_mod.check_codec(self.wire)
        pattern = self.partition.pattern
        if self.overlap:
            sp, _ = comm_strategies._split_phase_cached(pattern)
            self._split = sp
            self._remote_plan = comm_strategies.planned(
                sp.remote, self.strategy, message_cap_bytes=self.message_cap_bytes
            )
            self._local_plan = comm_strategies.planned(sp.local, "local")
            self._plan = None
        else:
            self._split = None
            self._plan = comm_strategies.planned(
                pattern, self.strategy, message_cap_bytes=self.message_cap_bytes
            )
        g, L = self.topo.nranks, self.partition.rows_per_rank
        self._diag_d = self.partition.diag.data.reshape(g, L, -1)
        self._diag_c = self.partition.diag.cols.reshape(g, L, -1)
        self._off_d = self.partition.off.data.reshape(g, L, -1)
        self._off_c = self.partition.off.cols.reshape(g, L, -1)
        if self.health is None and (self.verify or self.faults is not None):
            self.health = faults_mod.HealthTracker()
        self._fault_calls = 0
        #: RecoveryPath.key of the most recent recovered exchange, or None
        self.last_recovery: Optional[str] = None

    @property
    def topo(self) -> PodTopology:
        return self.partition.topo

    @property
    def rows_per_rank(self) -> int:
        return self.partition.rows_per_rank

    # ------------------------------------------------------------------
    def halo(self, v: np.ndarray) -> np.ndarray:
        """Exchange only: ``[nranks, L] -> [nranks, H]`` canonical buffer.

        With ``verify`` or ``faults`` set, the exchange runs inside the
        recovery ladder; faults and checks ride the inter-pod (sub-)plan
        only, so on-pod data is never touched.
        """
        v = np.asarray(v)
        if self.faults is None and not self.verify:
            if self.overlap:
                # the wire codec rides the inter-pod sub-plan only
                remote = execute_numpy(self._remote_plan, v, wire=self.wire)
                local = execute_numpy(self._local_plan, v)
                return merge_split_phase(self._split, local, remote)
            return execute_numpy(self._plan, v, wire=self.wire)
        return self._guarded_halo(v)

    def _exchange(self, v: np.ndarray, strategy: str, wire: str,
                  fault_call: int) -> np.ndarray:
        """One physical halo attempt under (strategy, wire) -- the ladder's
        probe; plans come from the module cache, so variants replan once."""
        if self.overlap:
            remote_plan = comm_strategies.planned(
                self._split.remote, strategy,
                message_cap_bytes=self.message_cap_bytes,
            )
            remote = execute_numpy(
                remote_plan, v, wire=wire, faults=self.faults,
                fault_call=fault_call, verify=self.verify,
            )
            local = execute_numpy(self._local_plan, v)
            return merge_split_phase(self._split, local, remote)
        plan = comm_strategies.planned(
            self.partition.pattern, strategy,
            message_cap_bytes=self.message_cap_bytes,
        )
        return execute_numpy(
            plan, v, wire=wire, faults=self.faults,
            fault_call=fault_call, verify=self.verify,
        )

    def _guarded_halo(self, v: np.ndarray) -> np.ndarray:
        def attempt(strategy: str, wire: str) -> np.ndarray:
            idx = self._fault_calls
            self._fault_calls += 1
            return self._exchange(v, strategy, wire, idx)

        out, path = faults_mod.run_ladder(
            attempt,
            strategy=self.strategy,
            wire=self.wire,
            health=self.health,
            max_retries=self.max_retries,
            fallback=self.fallback,
            choose_alternative=faults_mod.advise_alternative(
                self.partition.pattern
            ),
        )
        if path is not None:
            self.last_recovery = path.key
        return out

    def __call__(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v)
        g, L = self.topo.nranks, self.partition.rows_per_rank
        if v.shape != (g, L):
            raise ValueError(f"expected [{g}, {L}], got {tuple(v.shape)}")
        halo = self.halo(v)
        return _ell_matvec(self._diag_d, self._diag_c, v) + _ell_matvec(
            self._off_d, self._off_c, halo
        )

    @property
    def wire_bytes(self):
        """(intra-pod, inter-pod) wire bytes of one exchange, codec-scaled."""
        if self.overlap:
            ri, rj = wire_mod.scaled_wire_bytes(self._remote_plan, self.wire)
            li, _ = wire_mod.scaled_wire_bytes(self._local_plan, "none")
            return (ri + li, rj)
        return wire_mod.scaled_wire_bytes(self._plan, self.wire)


def build_numpy(matrix, topo: PodTopology, strategy: str = "standard", **kw) -> NumpySpMV:
    """Partition ``matrix`` and wrap it in a :class:`NumpySpMV`."""
    from repro_torch.sparse.partition import partition_csr

    return NumpySpMV(partition_csr(matrix, topo), strategy=strategy, **kw)


# ---------------------------------------------------------------------------
# Capturable operator (whole-solve support)
# ---------------------------------------------------------------------------


def _program_on(pattern, strategy: str, message_cap_bytes: int, fuse_program: bool,
                device: torch.device, group=None):
    """The exec-cache program of ``pattern`` planned under ``strategy``: of
    the stacked ranks, or of this rank of ``group`` (the on-pod phase's
    messages tagged apart, as :class:`~repro_torch.comm.strategies.IrregularExchange`
    tags them)."""
    key = comm_strategies._plan_key(pattern, strategy, message_cap_bytes, 4, fuse_program)
    sp = comm_strategies.planned(pattern, strategy, message_cap_bytes, 4, fuse_program)
    if group is None:
        return comm_strategies._program(sp, key, device)
    return comm_strategies._rank_program(sp, key, device, group, tag=int(strategy == "local"))


@dataclasses.dataclass(eq=False)
class TraceableOperator:
    """A distributed SpMV as one capturable call on one device.

    :meth:`matvec` runs the exchange program(s), the split-phase merge under
    ``overlap``, and the blocked-ELL kernel B1 (tile-masked under
    ``overlap``: every tile of the diag block, the boundary tiles of the off
    block).  ``checked`` is the program whose inter-pod hops carry the wire,
    the checks and the faults (the unsplit program, or the inter-pod
    sub-program under ``overlap``).  Over a process group (``group``) the
    operands are this rank's ``[1, L]``, the programs its
    :class:`~repro_torch.comm.strategies._RankProgram` programs, and a split
    phase runs its two sub-exchanges one after the other (their hops are
    staged through the host, so nothing overlaps).

    Build with :func:`traceable_operator`.
    """

    topo: PodTopology
    local_size: int
    device: torch.device
    overlap: bool
    wire: str
    verify: bool
    #: the program carrying the wire (barrier: the whole exchange)
    checked: object
    #: the on-pod sub-program and the merge (``overlap`` only)
    local: Optional[object]
    merge: Optional[object]
    #: blocked-ELL data/cols, diag then off, ``[g, L, K]``
    blocks: Tuple[torch.Tensor, ...]
    #: ``[g, ntiles]`` int32 tile masks of the overlap path's two passes
    all_tiles: Optional[torch.Tensor]
    bnd_tiles: Optional[torch.Tensor]
    #: compiled fault injections of ``checked`` (None: no faults)
    injections: Optional[dict] = None
    #: ``[n]`` bool: call index -> faults on (a ``FaultPlan.active_calls``
    #: schedule; None: the faults, if any, hit every call)
    active: Optional[torch.Tensor] = None
    side_stream: Optional[object] = None
    #: the :class:`~repro_torch.comm.topology.ExchangeGroup` of an operator
    #: over a process group (None: stacked ranks)
    group: Optional[object] = None

    def __post_init__(self) -> None:
        self._no_viols = torch.zeros(0, dtype=torch.float64, device=self.device)

    @property
    def ranks_held(self) -> int:
        """The leading dim of the operands: every rank, or 1 under a group."""
        return self.topo.nranks if self.group is None else 1

    @property
    def nviol(self) -> int:
        """Length of :meth:`matvec`'s violation vector (0: nothing checked)."""
        return len(self.checked.hops) if self.verify else 0

    @property
    def strategy(self) -> str:
        return self.checked.sp.strategy

    def _run(self, prog, v: torch.Tensor, *args):
        """Hop generator of one program on ``v``: a rank program's
        :meth:`~repro_torch.comm.strategies._RankProgram.segments`, or a
        stacked program's run, which yields no hop."""
        if self.group is None:
            return prog.run(v, *args)
        return (yield from prog.segments(v, *args))

    def _exchange(self, v: torch.Tensor, call_idx: torch.Tensor):
        prog = self.checked
        if self.injections is None:
            out, viols = yield from self._run(prog, v, self.wire, self.verify)
        elif self.active is None:
            out, viols = yield from self._run(prog, v, self.wire, self.verify, self.injections)
        else:
            # a call-gated fault schedule: both the faulted and the clean
            # exchange run, and the call index picks one on the device
            out_f, vf = yield from self._run(prog, v, self.wire, self.verify, self.injections)
            out_c, vc = yield from self._run(prog, v, self.wire, self.verify)
            use = self.active.index_select(0, call_idx.clamp(max=self.active.numel() - 1).view(1))
            out = torch.where(use.view((1,) * out_f.ndim), out_f, out_c)
            viols = None if vf is None else torch.where(use, vf, vc)
        return out, (self._no_viols if viols is None else viols)

    def matvec(self, v: torch.Tensor, call_idx: torch.Tensor):
        """``v [g, L] -> (w [g, L], viols [nviol] float64)``.

        ``call_idx`` (a 0-d int64 tensor on the device) is the matvec's call
        index, which a call-gated fault schedule reads; ``viols`` holds each
        checked hop's worst violation (``> 0`` failed).  Over a process
        group ``g = 1`` and the hops run here (:meth:`matvec_steps`).
        """
        return run_hops(self.matvec_steps(v, call_idx))

    def matvec_steps(self, v: torch.Tensor, call_idx: torch.Tensor):
        """:meth:`matvec` as a hop generator (:mod:`repro_torch.comm.hops`):
        it yields the hops of a process group's exchange (none for stacked
        ranks) and returns ``(w, viols)``."""
        dd, dc, od, oc = self.blocks
        if not self.overlap:
            halo, viols = yield from self._exchange(v, call_idx)
            return spmv_ell(dd, dc, v) + spmv_ell(od, oc, halo), viols
        if self.group is not None:
            remote, viols = yield from self._exchange(v, call_idx)
            local, _ = yield from self._run(self.local, v, "none")
            w = spmv_ell(dd, dc, v, self.all_tiles)
            halo = self.merge(local, remote, self.group.rank)
            return w + spmv_ell(od, oc, halo, self.bnd_tiles), viols
        # split phase: the inter-pod sub-exchange on the side stream while
        # the on-pod one and the whole diag pass run on this one; the side
        # stream waits for this one first, so it reads only finished data
        # and reuses only memory whose readers were queued before it
        side = self.side_stream
        if side is not None:
            current = torch.cuda.current_stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                remote, viols = run_hops(self._exchange(v, call_idx))
        else:
            remote, viols = run_hops(self._exchange(v, call_idx))
        local, _ = self.local.run(v)
        w = spmv_ell(dd, dc, v, self.all_tiles)
        if side is not None:
            current.wait_stream(side)
        halo = self.merge(local, remote)
        return w + spmv_ell(od, oc, halo, self.bnd_tiles), viols

    def raise_viols(self, viols: np.ndarray) -> None:
        """Raise :class:`~repro_torch.comm.faults.ExchangeIntegrityError` for
        the first failed column of a violation vector -- the fields the host
        executor raises for that hop."""
        viols = np.asarray(viols, dtype=np.float64).reshape(-1)
        bad = viols > 0.0
        if not bad.any():
            return
        j = int(np.argmax(bad))
        op_index, stage_kind, round_index = self.checked.hops[j]
        raise faults_mod.ExchangeIntegrityError(
            strategy=self.strategy,
            codec=self.wire,
            stage_kind=stage_kind,
            op_index=op_index,
            round_index=round_index,
            violation=float(viols[j]),
        )


def traceable_operator(op, device: DeviceLike = None) -> TraceableOperator:
    """Lower either SpMV operator flavor to a :class:`TraceableOperator`.

    A :class:`~repro_torch.sparse.spmv.DistributedSpMV` keeps its device,
    blocks and plans (``device`` must be left out or name the same device).
    A :class:`NumpySpMV` is lowered onto ``device``: left out, the CUDA
    device, and a machine without one raises.  Plans come from the module
    caches, so lowering an operator that already ran re-plans nothing.  An
    operator over a process group (``DistributedSpMV(group=)``) keeps its
    rank's blocks and lowers its rank programs.
    """
    part = op.partition
    topo, L = part.topo, part.rows_per_rank
    group = getattr(op, "group", None)
    g = topo.nranks if group is None else 1
    own = getattr(op, "device", None)
    if isinstance(own, torch.device):
        if device is not None and resolve_device(device) != own:
            raise ValueError(f"the operator lives on {own}, not on {resolve_device(device)}")
        device = own
        blocks = op._blocks
        fuse_program = op.fuse_program
    else:
        device = resolve_device(device)
        blocks = tuple(
            as_device_tensor(a, device)
            for a in (op._diag_d, op._diag_c, op._off_d, op._off_c)
        )
        fuse_program = True
    cap = op.message_cap_bytes
    faults = op.faults
    common = dict(topo=topo, local_size=L, device=device, wire=op.wire, verify=op.verify,
                  blocks=blocks, group=group)
    if not op.overlap:
        checked = _program_on(part.pattern, op.strategy, cap, fuse_program, device, group)
        extra = dict(overlap=False, checked=checked, local=None, merge=None,
                     all_tiles=None, bnd_tiles=None)
    else:
        sp, merge = comm_strategies._split_phase_cached(part.pattern)
        merge._on(device)  # the merge maps go to the device now, not mid-capture
        checked = _program_on(sp.remote, op.strategy, cap, fuse_program, device, group)
        row_nnz = part.off_row_nnz if group is None else op._off_row_nnz
        split = split_rows(row_nnz.reshape(g, L) > 0, TILE_R)
        bnd = split.boundary_tiles.astype(np.int32)
        extra = dict(
            overlap=True, checked=checked,
            local=_program_on(sp.local, "local", cap, fuse_program, device, group),
            merge=merge,
            all_tiles=torch.ones(bnd.shape, dtype=torch.int32, device=device),
            bnd_tiles=as_device_tensor(bnd, device),
            side_stream=(torch.cuda.Stream(device) if device.type == "cuda" and group is None
                         else None),
        )
    if faults is not None:
        injections, _delay = checked.faults_on_device(op.wire, faults)
        extra["injections"] = injections
        if faults.active_calls is not None:
            calls = [c for c in faults.active_calls if c >= 0]
            table = np.zeros(max(calls, default=-1) + 2, dtype=bool)
            table[calls] = True
            extra["active"] = as_device_tensor(table, device)
    return TraceableOperator(**common, **extra)
