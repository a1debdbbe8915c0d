"""Whole-solve Krylov on the device: CG / BiCGStab as replayed CUDA graphs.

The host loops of :mod:`repro_torch.solve.krylov` launch every op of an
iteration from Python and read two or more scalars back per iteration, so at
the case study's size the host, not the device, sets the pace.  This module
is the port's counterpart of the reference's one ``lax.while_loop`` per
solve: the solver's state lives in static device buffers, an iteration is a
sequence of device ops with its control flow as data, and the loop is a
CUDA graph of :data:`U` iterations replayed until the device says the solve
has ended.

* Every branch of the host loop is a ``torch.where`` select; a history entry
  is an ``index_copy_`` at the device index ``k``; ``tol``, ``max_it``,
  ``eps`` and ``bnorm`` are 0-d device buffers, not constants of the graph.
* The scalars are the host loop's float64 values from the same hierarchical
  dot (:func:`repro_torch.solve.reductions.traceable_dot`), combined in the
  same order with the same vector ops, so a fused residual history equals
  the host loop's bitwise (float32 vectors).  The reference carries float32
  scalars in its loop instead (ROADMAP §C).
* The init section (``r = b - A x0``: always one matvec, as the reference
  does) and a block of :data:`U` iterations are captured once per cache
  entry, after a warm-up that runs each of them eagerly on a side stream
  (it builds and loads the kernels and fills the plan caches before any
  capture).  The driver replays block ``j + 1`` before it waits on block
  ``j``'s done flag, which comes back through pinned memory by a
  non-blocking copy and an event: the device never waits on the host.
  Iterations after the end are masked no-ops, as in the reference's
  where-selected body.
* A restart from the best iterate, a resume from a checkpoint and a
  re-dispatch after a ladder rung replay the same graphs with new buffer
  contents.  ``checkpoint_every=N`` refreshes a checkpoint held in static
  buffers every ``N`` clean iterations by a masked copy inside the block.
* A ``FaultPlan.active_calls`` schedule runs the faulted and the clean
  exchange in every matvec and picks one by the matvec's call index on the
  device (:class:`repro_torch.solve.operator.TraceableOperator`).  A slow
  hop's ``delay_s`` is not modelled here: the reference's traced program
  cannot sleep either, so only the host path pays it.

Over a process group (``DistributedSpMV(group=)``, one rank per process)
the init and the block are hop generators (:mod:`repro_torch.comm.hops`):
each halo exchange and each node-aware dot stops the device program at a
collective, whose payload stages through host memory over gloo.  On CUDA
each stretch of device work between two hops is a graph of its own,
captured in order into one shared pool, and a dispatch replays them in
order with the staged hops between the replays: the host still reads one
done flag per block and decides nothing per iteration.  The dots sum in the
group tree's order (:func:`repro_torch.solve.reductions.fused_dot`), so
every rank holds the same scalars, takes the same stop decision and
matches the grouped host loop bitwise; the checked hops' violations are
agreed by one all-reduce MAX per block (per iteration when checkpoints are
armed), so every rank keeps the same checkpoints and raises the same error.

On the CPU the same init and block functions run eagerly (the plain
version the tests use).  On CUDA capture is the path: a failed capture or
replay raises.  The private ``capture=False`` of :func:`_fused_solve` runs
the eager body on the card, to compare against.

Each solve counts its reads of device state in the module attribute
:data:`host_reads` (reset at the start of a solve); for ``n`` iterations
without a resume it is at most ``ceil(n / U) + HOST_READ_SLACK``.  The
kernel wrappers count no launch while a graph is captured, so
:data:`graph_launches` counts the launches of the graphs' replays, and
:data:`program_runs` the runs of the init and of a block.  The fused scalars
equal the host loop's bitwise: on the CPU the roots are taken on the host
(:func:`_root`), as torch's CPU ``sqrt`` is not always correctly rounded.
Under a profiler session a solve records the spans ``repro_torch.solve.*``
(the whole solve, its rhs norm, entry, init, blocks and unpack) and the
counter ``solve.host_reads`` (:mod:`repro_torch.tracing`).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.comm import strategies as comm_strategies
from repro_torch.comm.faults import (
    ExchangeIntegrityError,
    HealthTracker,
    advise_alternative,
    run_ladder,
)
from repro_torch.comm.hops import Hop, run_hops
from repro_torch.core.device import DeviceLike, as_device_tensor, resolve_device
from repro_torch.kernels.spmv_ell import spmv_ell
from repro_torch.solve.krylov import (
    STALL_WINDOW,
    SolveResult,
    _finish_status,
    _recovery_baseline,
)
from repro_torch.solve.operator import traceable_operator
from repro_torch.solve.reductions import fused_dot
from repro_torch.sparse.spmv import DistributedSpMV

#: iterations per captured block, chosen on the H100 by the block sweep of
#: ``chip_smoke.py``'s phase ``fused`` (PERF.md): the main path's solves end
#: within tens of iterations, where a block's masked tail (up to 2U - 1
#: iterations) costs more than a replay and a flag read, which hide behind
#: the device's work; 2 is as fast as 1 there and faster over long solves;
#: read when a cache entry is built
U = 2
#: host reads beside one per block: the rhs norm, the final read of each
#: dispatch, and a restart's second dispatch with its partial block
HOST_READ_SLACK = 4

#: reads of device state by the current (or last) solve
host_reads = 0
#: kernel launches made by graph replays, per kernel wrapper
graph_launches: Dict[str, int] = {"spmv_ell": 0}
#: runs of the init and of a block (replays on CUDA, eager runs on the CPU)
program_runs: Dict[str, int] = {"init": 0, "block": 0}
#: seconds the last capture took, its eager warm-up included (CUDA only)
last_capture_s = 0.0
_WRAPPERS = {"spmv_ell": spmv_ell}

# status codes carried on the device, mapped back to the host solvers'
# status strings on exit
_CONV = 0
_MAXITER = 1
_INDEF = 2
_NONFIN = 3
_STAG = 4
_RHO = 5
_OMEGA = 6
_DENOM = 7
_TT = 8

_STATUS_STR = {
    _CONV: "converged",
    _MAXITER: "maxiter",
    _INDEF: "breakdown:indefinite",
    _NONFIN: "breakdown:nonfinite",
    _STAG: "stagnation",
    _RHO: "breakdown:rho",
    _OMEGA: "breakdown:omega",
    _DENOM: "breakdown:denom",
    _TT: "breakdown:tt",
}

#: statuses that trigger the one restart from the best iterate (CG restarts
#: only on nonfinite/stagnation -- indefiniteness ends the solve -- while
#: BiCGStab restarts on every breakdown)
_RESTART = {
    "cg": frozenset({_NONFIN, _STAG}),
    "bicgstab": frozenset({_NONFIN, _STAG, _RHO, _OMEGA, _DENOM, _TT}),
}

#: the solver state a checkpoint holds, per solver
_VECS = {"cg": ("x", "r", "p", "best_x"), "bicgstab": ("x", "r", "p", "v", "rhat", "best_x")}
_SCALARS = {"cg": ("rs", "best"), "bicgstab": ("rho", "alpha", "omega", "relprev", "best", "rhat_nrm")}
_COUNTERS = ("it", "k", "best_it", "mvc")


def _root(sq: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(sq, 0))`` of a 0-d float64 tensor, correctly rounded as the
    host loops' ``math.sqrt`` is: CUDA's ``sqrt`` is, while torch's CPU
    kernel is off by one ulp for about one input in a hundred, so on the CPU
    (eager, no graph) the host takes the root."""
    if sq.device.type == "cpu":
        return sq.new_tensor(math.sqrt(max(float(sq), 0.0)))
    return torch.sqrt(torch.clamp_min(sq, 0.0))


def _count_read() -> None:
    global host_reads
    host_reads += 1
    tracing.count("solve.host_reads")


def _read(t: torch.Tensor) -> np.ndarray:
    _count_read()
    return t.cpu().numpy()


class _Out(NamedTuple):
    """One dispatch's result: device tensors and host values."""

    x: torch.Tensor
    best_x: torch.Tensor
    hist: List[float]
    it: int
    status: int
    mvc: int
    viols: np.ndarray
    ck_valid: bool
    ck_it: int
    ck_k: int
    ck_mvc: int


class _Checkpoint(NamedTuple):
    """A harvested checkpoint: device copies of the state and its counters."""

    state: Dict[str, torch.Tensor]
    it: int
    k: int
    mvc: int


def _next_hop(steps, started: bool) -> Optional[Hop]:
    """Run a hop generator to its next hop that moves something on this
    rank (an empty one needs no stage: the capture goes on past it), or to
    its end (``None``)."""
    try:
        hop = steps.send(None) if started else next(steps)
        while hop.empty:
            hop = steps.send(None)
        return hop
    except StopIteration:
        return None


class _FusedSolve:
    """One cache entry: an operator's static buffers, its init and block
    functions and, on CUDA, their captured graphs.

    It holds the operator, so the device blocks and plans the graphs read
    stay alive (and two operators never share an entry).  The init, a step
    and a block are hop generators; ``dot`` is :func:`fused_dot`'s.
    """

    def __init__(self, op, top, solver: str, maxiter: int, dtype: torch.dtype, dot,
                 checkpoint_every: Optional[int], capture: bool):
        self.op = op
        self.top = top
        self.solver = solver
        self.ce = checkpoint_every
        self.block = U
        self.dot = dot
        self.hist_len = maxiter + 2
        dev = top.device
        g, L = top.ranks_held, top.local_size

        def scalar(dt):
            return torch.zeros((), dtype=dt, device=dev)

        S = self.s = {}
        for n in ("b", "x0") + _VECS[solver]:
            S[n] = torch.zeros((g, L), dtype=dtype, device=dev)
        for n in ("tol", "bnorm", "eps") + _SCALARS[solver]:
            S[n] = scalar(torch.float64)
        for n in ("max_it", "status") + _COUNTERS:
            S[n] = scalar(torch.int64)
        S["done"], S["flag"] = scalar(torch.bool), scalar(torch.bool)
        # replays of a grouped program's stretches, counted on the device:
        # one op in each, so no stretch is an empty graph
        S["beats"] = scalar(torch.int64)
        S["viols"] = torch.zeros(max(top.nviol, 1), dtype=torch.float64, device=dev)
        S["hist"] = torch.zeros(self.hist_len, dtype=torch.float64, device=dev)
        S["eps"].fill_(float(torch.finfo(dtype).eps))
        self.zero_idx = scalar(torch.int64)
        self.ck_names = _VECS[solver] + _SCALARS[solver] + _COUNTERS + ("hist",)
        if self.ce is not None:
            for n in self.ck_names:
                S["ck_" + n] = torch.zeros_like(S[n])
            S["ck_valid"] = scalar(torch.bool)
        self._step = self._cg_step if solver == "cg" else self._bicgstab_step
        self.graphs: Optional[dict] = None
        if dev.type == "cuda":
            self.pinned = torch.zeros(2, dtype=torch.bool, pin_memory=True)
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
            if capture:
                self._capture()
        else:
            self.posted: List[torch.Tensor] = [S["flag"], S["flag"]]

    # -- the device program -------------------------------------------
    def _init(self):
        """``r = b - A x0`` and the state of iteration 0 (the reference's
        init section; its matvec has call index 0)."""
        S, dot = self.s, self.dot
        Ax, vv = yield from self.top.matvec_steps(S["x0"], self.zero_idx)
        r = S["b"] - Ax
        rs = yield from dot(r, r)
        rel0 = _root(rs) / S["bnorm"]
        S["hist"].fill_(float("nan"))
        S["hist"][:1].copy_(rel0.view(1))
        S["viols"].zero_()
        if vv.numel():
            torch.maximum(S["viols"], vv, out=S["viols"])
        yield from self._agree()
        torch.le(rel0, S["tol"], out=S["done"])
        S["status"].copy_(torch.where(S["done"], _CONV, _MAXITER))
        for n in ("x", "best_x"):
            S[n].copy_(S["x0"])
        S["r"].copy_(r)
        S["best"].copy_(rel0)
        S["best_it"].zero_()
        S["it"].zero_()
        S["k"].fill_(1)
        S["mvc"].fill_(1)
        if self.solver == "cg":
            S["p"].copy_(r)
            S["rs"].copy_(rs)
        else:
            S["p"].zero_()
            S["v"].zero_()
            for n in ("rho", "alpha", "omega"):
                S[n].fill_(1.0)
            S["relprev"].copy_(rel0)
            S["rhat"].copy_(r)
            S["rhat_nrm"].copy_(rel0 * S["bnorm"])
        if self.ce is not None:
            clean = S["viols"].max() <= 0.0
            for n in self.ck_names:
                S["ck_" + n].copy_(S[n])
            S["ck_valid"].copy_(clean)
        self._flag()

    def _flag(self) -> None:
        S = self.s
        torch.logical_or(S["done"], S["it"] >= S["max_it"], out=S["flag"])

    def _write_hist(self, wrote: torch.Tensor, value: torch.Tensor) -> None:
        S = self.s
        kk = S["k"].clamp(max=self.hist_len - 1).view(1)
        h = S["hist"]
        h.index_copy_(0, kk, torch.where(wrote, value, h.index_select(0, kk)))
        S["k"].add_(wrote)

    def _add_viols(self, live: torch.Tensor, vv: torch.Tensor) -> None:
        if vv.numel():
            v = self.s["viols"]
            torch.where(live, torch.maximum(v, vv), v, out=v)

    def _agree(self):
        """Over a process group with checked hops: every rank's violations
        so far reduced to the world's MAX by one all-reduce (a NaN read as
        inf, as :func:`~repro_torch.comm.strategies._agree_on_violations`
        reads it), so the ranks keep the same checkpoints and raise the same
        error.  Stacked ranks hold every hop already."""
        if self.top.group is None or not self.top.nviol:
            return
        v = self.s["viols"]
        v.masked_fill_(torch.isnan(v), float("inf"))
        yield Hop("all_reduce", (v,), (v,), op="max")

    def _cg_step(self):
        """One CG iteration, the host loop's ops in its order, its branches
        as selects (masked when the solve has ended)."""
        S, dot = self.s, self.dot
        x, r, p, rs = S["x"], S["r"], S["p"], S["rs"]
        live = ~S["done"] & (S["it"] < S["max_it"])
        Ap, vv = yield from self.top.matvec_steps(p, S["mvc"])
        pAp = yield from dot(p, Ap)
        indef = pAp <= 0.0
        alpha = rs / torch.where(indef, 1.0, pAp)
        x1 = x + alpha * p
        r1 = r - alpha * Ap
        rs_new = yield from dot(r1, r1)
        relres = _root(rs_new) / S["bnorm"]
        step = live & ~indef
        it1 = S["it"] + step
        conv = step & (relres <= S["tol"])
        going = step & ~conv
        improved = going & (relres < S["best"])
        best_it1 = torch.where(improved, it1, S["best_it"])
        nonfin = going & ~torch.isfinite(relres)
        stall = going & ~nonfin & (it1 - best_it1 >= STALL_WINDOW)
        ended = (live & indef) | conv | nonfin | stall
        status = torch.where(indef, _INDEF, torch.where(conv, _CONV, torch.where(nonfin, _NONFIN, _STAG)))
        torch.where(ended, status, S["status"], out=S["status"])
        self._write_hist(step, relres)
        cont = step & ~ended
        torch.where(cont, r1 + (rs_new / rs) * p, p, out=p)
        torch.where(cont, rs_new, rs, out=rs)
        torch.where(step, x1, x, out=x)
        torch.where(step, r1, r, out=r)
        torch.where(improved, relres, S["best"], out=S["best"])
        torch.where(improved, x1, S["best_x"], out=S["best_x"])
        S["best_it"].copy_(best_it1)
        S["it"].copy_(it1)
        S["mvc"].add_(live)
        self._add_viols(live, vv)
        S["done"].logical_or_(ended)

    def _bicgstab_step(self):
        """One BiCGStab iteration (two matvecs), as :meth:`_cg_step` is CG's."""
        S, dot = self.s, self.dot
        x, r, p, v, rhat = S["x"], S["r"], S["p"], S["v"], S["rhat"]
        eps, bnorm, tol = S["eps"], S["bnorm"], S["tol"]
        rho, alpha, omega = S["rho"], S["alpha"], S["omega"]

        def nz(a):
            return torch.where(a == 0, 1.0, a)

        live = ~S["done"] & (S["it"] < S["max_it"])
        rho_new = yield from dot(rhat, r)
        r_nrm = S["relprev"] * bnorm
        bad_rho = live & (rho_new.abs() <= eps * S["rhat_nrm"] * r_nrm)
        bad_omega = live & ~bad_rho & (omega.abs() <= eps * alpha.abs())
        ok1 = live & ~bad_rho & ~bad_omega
        beta = (rho_new / nz(rho)) * (alpha / nz(omega))
        p1 = torch.where(ok1, r + beta * (p - omega * v), p)
        v1, vva = yield from self.top.matvec_steps(p1, S["mvc"])
        denom = yield from dot(rhat, v1)
        bad_denom = ok1 & (denom.abs() <= eps * rho_new.abs())
        ok2 = ok1 & ~bad_denom
        alpha1 = torch.where(ok2, rho_new / nz(denom), alpha)
        s = torch.where(ok2, r - alpha1 * v1, r)
        it1 = S["it"] + ok2
        ss = yield from dot(s, s)
        snorm = _root(ss)
        rel_s = snorm / bnorm
        s_conv = ok2 & (rel_s <= tol)
        t, vvb = yield from self.top.matvec_steps(s, S["mvc"] + ok1)
        tt = yield from dot(t, t)
        bad_tt = ok2 & ~s_conv & (tt <= (eps * snorm) ** 2)
        ok3 = ok2 & ~s_conv & ~bad_tt
        ts = yield from dot(t, s)
        omega1 = torch.where(ok3, ts / nz(tt), omega)
        x_sc = x + alpha1 * p1
        x1 = x_sc + omega1 * s
        r1 = s - omega1 * t
        rr = yield from dot(r1, r1)
        relres = _root(rr) / bnorm
        conv = ok3 & (relres <= tol)
        going = ok3 & ~conv
        improved = going & (relres < S["best"])
        best_it1 = torch.where(improved, it1, S["best_it"])
        nonfin = going & ~torch.isfinite(relres)
        stall = going & ~nonfin & (it1 - best_it1 >= STALL_WINDOW)
        ended = bad_rho | bad_omega | bad_denom | s_conv | bad_tt | conv | nonfin | stall
        status = torch.where(
            bad_rho, _RHO, torch.where(
                bad_omega, _OMEGA, torch.where(
                    bad_denom, _DENOM, torch.where(
                        s_conv, _CONV, torch.where(
                            bad_tt, _TT, torch.where(
                                conv, _CONV, torch.where(nonfin, _NONFIN, _STAG)))))))
        torch.where(ended, status, S["status"], out=S["status"])
        # a history entry lands where the host appends one: the half-step
        # convergence exit and the full step
        wrote = s_conv | ok3
        hist_val = torch.where(s_conv, rel_s, relres)
        self._write_hist(wrote, hist_val)
        torch.where(wrote, hist_val, S["relprev"], out=S["relprev"])
        torch.where(s_conv, x_sc, torch.where(ok3, x1, x), out=x)
        torch.where(ok3, r1, r, out=r)
        p.copy_(p1)
        torch.where(ok1, v1, v, out=v)
        torch.where(ok3, rho_new, rho, out=rho)
        alpha.copy_(alpha1)
        omega.copy_(omega1)
        torch.where(improved, relres, S["best"], out=S["best"])
        torch.where(improved, x1, S["best_x"], out=S["best_x"])
        S["best_it"].copy_(best_it1)
        S["it"].copy_(it1)
        # the host's matvec count on each path
        S["mvc"].add_(ok1.long() + (ok2 & ~s_conv).long())
        self._add_viols(live, torch.maximum(vva, vvb))
        S["done"].logical_or_(ended)

    def _block(self):
        """:attr:`block` iterations, each followed by the masked checkpoint;
        over a group the violations are agreed after each checkpointed
        iteration, else once at the block's end."""
        S = self.s
        for _ in range(self.block):
            prev_it = S["it"].clone() if self.ce is not None else None
            yield from self._step()
            if self.ce is not None:
                yield from self._agree()
                take = (~S["done"] & (S["it"] % self.ce == 0) & (S["it"] > prev_it)
                        & (S["viols"].max() <= 0.0))
                for n in self.ck_names:
                    torch.where(take, S[n], S["ck_" + n], out=S["ck_" + n])
                S["ck_valid"].logical_or_(take)
        if self.ce is None:
            yield from self._agree()
        self._flag()

    # -- capture and replay --------------------------------------------
    def _capture(self) -> None:
        """Warm up eagerly on a side stream (over a group its hops run: every
        rank builds the entry at once), then capture init and block: one
        graph each, or over a group one graph per stretch between two hops,
        all in one pool."""
        global last_capture_s
        dev = self.top.device
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            run_hops(self._init())
            run_hops(self._step())
        current.wait_stream(side)
        # an entry held by its operator (over a group) and that operator
        # are a reference cycle: were the collector to free an earlier one
        # inside a capture, its graphs' teardown would void the capture.
        # So collect now, and not until the capture has ended.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graphs, pool = {}, None
            for name, fn in (("init", self._init), ("block", self._block)):
                segments, steps, started = [], fn(), False
                while True:
                    before = {k: w.captured for k, w in _WRAPPERS.items()}
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool):
                        if self.top.group is not None:
                            self.s["beats"].add_(1)
                        hop = _next_hop(steps, started)
                    started = True
                    pool = graph.pool()
                    segments.append((graph, {k: w.captured - before[k] for k, w in _WRAPPERS.items()}, hop))
                    if hop is None:
                        break
                graphs[name] = segments
        finally:
            if collecting:
                gc.enable()
        self.graphs = graphs
        torch.cuda.synchronize(dev)
        last_capture_s = time.perf_counter() - t0

    def _run(self, name: str) -> None:
        """The init or one block: eagerly, or its graphs replayed in their
        capture order with each staged hop after its stretch."""
        program_runs[name] += 1
        if self.graphs is None:
            run_hops(self._init() if name == "init" else self._block())
            return
        for graph, launches, hop in self.graphs[name]:
            graph.replay()
            for k, n in launches.items():
                graph_launches[k] += n
            if hop is not None:
                hop.run()

    def _post_flag(self, slot: int) -> None:
        if self.top.device.type == "cuda":
            self.pinned[slot].copy_(self.s["flag"], non_blocking=True)
            self.events[slot].record()
        else:
            self.posted[slot] = self.s["flag"].clone()

    def _read_flag(self, slot: int) -> bool:
        _count_read()
        if self.top.device.type == "cuda":
            self.events[slot].synchronize()
            return bool(self.pinned[slot])
        return bool(self.posted[slot])

    def _blocks(self, max_it: int) -> None:
        """Replay blocks until the device's flag says the dispatch ended.

        Block ``j + 1`` is queued before block ``j``'s flag is read; after
        ``ceil(max_it / block)`` blocks the flag is set by construction (each
        live iteration advances ``it`` or ends the solve), so the last one
        is not read.
        """
        nblocks = -(-max_it // self.block)
        with tracing.span("repro_torch.solve.blocks"):
            for j in range(nblocks):
                self._run("block")
                self._post_flag(j % 2)
                if j and self._read_flag((j - 1) % 2):
                    break

    # -- dispatches ----------------------------------------------------
    def _load(self, b: torch.Tensor, bnorm: torch.Tensor, tol: float, max_it: int) -> None:
        S = self.s
        S["b"].copy_(b)
        S["bnorm"].copy_(bnorm)
        S["tol"].fill_(tol)
        S["max_it"].fill_(max_it)

    def dispatch(self, b, bnorm, x0: torch.Tensor, tol: float, max_it: int) -> _Out:
        """One solve from ``x0``: the init section, then blocks."""
        self._load(b, bnorm, tol, max_it)
        self.s["x0"].copy_(x0)
        with tracing.span("repro_torch.solve.init"):
            self._run("init")
        self._blocks(max_it)
        return self._unpack()

    def resume(self, b, bnorm, ck: _Checkpoint, tol: float, max_it: int) -> _Out:
        """Continue from a checkpoint: no init matvec; history, iteration and
        matvec counters go on where the checkpoint left them."""
        S = self.s
        self._load(b, bnorm, tol, max_it)
        for n, t in ck.state.items():
            S[n].copy_(t)
            S["ck_" + n].copy_(t)
        S["ck_valid"].fill_(True)
        S["done"].fill_(False)
        S["status"].fill_(_MAXITER)
        S["viols"].zero_()
        self._flag()
        self._blocks(max_it)
        return self._unpack()

    def _unpack(self) -> _Out:
        S = self.s
        with tracing.span("repro_torch.solve.unpack"):
            parts = [S["hist"], torch.stack([S[n].double() for n in ("it", "k", "status", "mvc")]),
                     S["viols"]]
            if self.ce is not None:
                parts.append(torch.stack(
                    [S[n].double() for n in ("ck_valid", "ck_it", "ck_k", "ck_mvc")]))
            host = _read(torch.cat(parts))
            hist, rest = host[: self.hist_len], host[self.hist_len:]
            it, k, status, mvc = (int(v) for v in rest[:4])
            nviol = S["viols"].numel()
            ck = rest[4 + nviol:] if self.ce is not None else (0, -1, 0, 0)
            return _Out(
                x=S["x"].clone(), best_x=S["best_x"].clone(), hist=[float(h) for h in hist[:k]],
                it=it, status=status, mvc=mvc, viols=rest[4: 4 + nviol], ck_valid=bool(ck[0]),
                ck_it=int(ck[1]), ck_k=int(ck[2]), ck_mvc=int(ck[3]),
            )

    def harvest(self, prev: Optional[_Checkpoint], out: _Out) -> Optional[_Checkpoint]:
        """Keep the newest valid checkpoint across dispatches (a failed
        resume may still have advanced past the one it started from)."""
        if not out.ck_valid or (prev is not None and prev.it >= out.ck_it):
            return prev
        state = {n: self.s["ck_" + n].clone() for n in self.ck_names}
        return _Checkpoint(state, out.ck_it, out.ck_k, out.ck_mvc)


# ---------------------------------------------------------------------------
# Host wrapper: cache, dispatch, restart policy, SolveResult assembly
# ---------------------------------------------------------------------------


def _entry(op, solver: str, maxiter: int, dtype: torch.dtype, compressor, device,
           checkpoint_every: Optional[int], capture: bool) -> _FusedSolve:
    """Fetch (or build) the fused solve of ``op``.

    The key is the reference's (pattern, solver, strategy, codec, overlap,
    kernel flavor, checks, faults, cap, maxiter, dtype, compressor,
    checkpointing) plus the device, :data:`U` and the operator itself:
    two operators on one sparsity pattern hold different values, and a graph
    reads the blocks it was captured with.

    Over a process group a miss is collective (the warm-up runs the hops),
    so the entry lives on the operator, outside the LRU that other solves
    evict from: every rank makes the same solves of its operator, so every
    rank hits or misses alike, whatever else each rank has solved.
    """
    faults = op.faults
    key = (
        "fused", solver, op.partition.pattern.fingerprint(), op.strategy, op.wire,
        bool(op.overlap), "kernel", bool(op.verify),
        None if faults is None else faults.fingerprint(),
        op.message_cap_bytes, str(device), int(maxiter), str(dtype),
        None if compressor is None else str(compressor), checkpoint_every,
        U, capture, id(op),
    )

    def build():
        top = traceable_operator(op, device)
        return _FusedSolve(op, top, solver, maxiter, dtype, fused_dot(op, compressor), checkpoint_every,
                           capture)

    if getattr(op, "group", None) is None:
        return comm_strategies.fused_cached(key, build)
    held = vars(op).setdefault("_fused_entries", {})
    if key not in held:
        held[key] = build()
    return held[key]


def _viol_error(entry: _FusedSolve, viols: np.ndarray) -> Optional[ExchangeIntegrityError]:
    """The structured error a violation vector encodes, or None if clean."""
    if not entry.top.nviol:
        return None
    try:
        entry.top.raise_viols(viols)
    except ExchangeIntegrityError as e:
        return e
    return None


def _restart(entry: _FusedSolve, out: _Out, b, bnorm, tol: float, maxiter: int, solver: str):
    """The one restart from the best iterate, if ``out`` ended on a
    restart status: returns ``(out, status_str, converged, hist, it,
    extra_matvecs, restarts)``."""
    if out.status not in _RESTART[solver]:
        return out, _STATUS_STR[out.status], out.status == _CONV, out.hist, out.it, 0, 0
    bad = _STATUS_STR[out.status]
    # the init section IS the host's true-residual recompute (r = b - A
    # x_best), and its history entry the host's restart entry
    out2 = entry.dispatch(b, bnorm, out.best_x, tol, maxiter - out.it)
    err = _viol_error(entry, out2.viols)
    if err is not None:
        raise err
    if not math.isfinite(out2.hist[0]):
        # the host checks the recomputed residual before re-entering the
        # loop; it keeps the original reason
        status_str, converged = bad, False
    elif out2.status == _CONV:
        status_str, converged = "converged", True
    elif out2.status == _MAXITER:
        status_str, converged = "maxiter", False
    else:
        status_str, converged = _STATUS_STR[out2.status], False
    return (out2, status_str, converged, out.hist + out2.hist, out.it + out2.it, out2.mvc, 1)


def _fused_solve(op, b, x0, tol: float, maxiter: int, reductions, solver: str,
                 checkpoint_every: Optional[int] = None, device: DeviceLike = None,
                 capture: bool = True) -> SolveResult:
    with tracing.span("repro_torch.solve.fused"):
        return _solve(op, b, x0, tol, maxiter, reductions, solver, checkpoint_every, device, capture)


def _solve(op, b, x0, tol: float, maxiter: int, reductions, solver: str,
           checkpoint_every: Optional[int], device: DeviceLike, capture: bool) -> SolveResult:
    global host_reads
    host_reads = 0
    own = getattr(op, "device", None)
    dev = own if isinstance(own, torch.device) else resolve_device(device)
    b = as_device_tensor(b, dev)
    g, L = getattr(op, "ranks_held", op.topo.nranks), op.rows_per_rank
    if tuple(b.shape) != (g, L):
        raise ValueError(f"b must be [{g}, {L}], got {tuple(b.shape)}")
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    rc0 = _recovery_baseline(op)
    compressor = getattr(reductions, "compressor", None)
    with tracing.span("repro_torch.solve.rhs_norm"):
        bnorm = _root(run_hops(fused_dot(op, compressor)(b, b)))
        zero_rhs = float(_read(bnorm)) == 0.0
    if zero_rhs:
        # the host solvers' zero-rhs early return (same _finish_status)
        return SolveResult(x=torch.zeros_like(b), converged=True, iterations=0,
                           residuals=(0.0,), matvecs=0,
                           status=_finish_status("converged", 0, op, rc0))
    # the init section always runs its matvec (for x0 = 0 it computes
    # b - A 0 = b exactly); the host loops count it only when x0 is given
    init_mv_adjust = 1 if x0 is None else 0
    x0 = torch.zeros_like(b) if x0 is None else as_device_tensor(x0, dev, b.dtype)
    def entry_for(vop) -> _FusedSolve:
        with tracing.span("repro_torch.solve.entry"):
            return _entry(vop, solver, maxiter, b.dtype, compressor, dev, checkpoint_every,
                          capture)

    entry = entry_for(op)
    resumes = 0
    if checkpoint_every is None:
        out = entry.dispatch(b, bnorm, x0, tol, maxiter)
        err = _viol_error(entry, out.viols)
        if err is not None:
            raise err
    else:
        got = _dispatch_resumable(op, entry, entry_for, b, bnorm, x0, tol, maxiter, solver,
                                  rc0, init_mv_adjust)
        if isinstance(got, SolveResult):
            return got
        entry, out, resumes = got
    matvecs = out.mvc - init_mv_adjust
    out, status_str, converged, hist, it, extra, restarts = _restart(
        entry, out, b, bnorm, tol, maxiter, solver)
    if resumes:
        status_str += f"+resume:{resumes}"
    return SolveResult(
        x=out.x,
        converged=converged,
        iterations=it,
        residuals=tuple(hist),
        matvecs=matvecs + extra,
        status=_finish_status(status_str, restarts, op, rc0),
        restarts=restarts,
    )


def _dispatch_resumable(op, entry: _FusedSolve, entry_for, b, bnorm, x0, tol: float,
                        maxiter: int, solver: str, rc0: int, init_mv_adjust: int):
    """The checkpoint/resume wrapper around one dispatch.

    A clean dispatch behaves exactly like an unarmed one.  On an integrity
    failure the newest clean checkpoint is harvested and the recovery
    ladder runs, each attempt RESUMING from it -- first on the same
    (strategy, codec), then demoted, then re-advised -- so recovery loses at
    most ``checkpoint_every`` iterations.  An exhausted ladder continues on
    the host loop from the checkpoint.  Returns ``(entry, out, resumes)``
    of the dispatch that finished, or the host fallback's ``SolveResult``;
    ``entry_for(op)`` fetches an operator's entry.
    """
    out = entry.dispatch(b, bnorm, x0, tol, maxiter)
    state = {"ck": entry.harvest(None, out), "used": False}
    err = _viol_error(entry, out.viols)
    if err is None:
        return entry, out, 0
    health = op.health if op.health is not None else HealthTracker()
    health.record_failure(err)

    def attempt(s: str, w: str):
        vop = op if (s == op.strategy and w == op.wire) else dataclasses.replace(
            op, strategy=s, wire=w)
        ventry = entry_for(vop)
        cur = state["ck"]
        if cur is not None:
            o = ventry.resume(b, bnorm, cur, tol, maxiter)
        else:
            o = ventry.dispatch(b, bnorm, x0, tol, maxiter)
        state["ck"] = ventry.harvest(state["ck"], o)
        e = _viol_error(ventry, o.viols)
        if e is not None:
            raise e
        state["used"] = cur is not None
        return ventry, o

    try:
        (entry, out), _path = run_ladder(
            attempt,
            strategy=op.strategy,
            wire=op.wire,
            health=health,
            max_retries=getattr(op, "max_retries", 1),
            fallback=getattr(op, "fallback", True),
            choose_alternative=advise_alternative(op.partition.pattern),
        )
    except ExchangeIntegrityError:
        return _host_resume_fallback(op, entry.top.device, b, tol, maxiter, solver,
                                     state["ck"], rc0, init_mv_adjust)
    return entry, out, 1 if state["used"] else 0


def _on_device(op, device: torch.device):
    """``op`` as an operator on ``device``: a ``DistributedSpMV`` is its
    own; a ``NumpySpMV`` becomes the ``DistributedSpMV`` of its partition
    with its strategy, codec, checks, faults, health tracker and ladder, so
    its solve goes on where the fused solve ran."""
    if isinstance(getattr(op, "device", None), torch.device):
        return op
    dop = DistributedSpMV(
        op.partition, strategy=op.strategy, message_cap_bytes=op.message_cap_bytes,
        device=device, overlap=op.overlap, wire=op.wire, verify=op.verify, faults=op.faults,
        health=op.health,
    )
    dop.exchange.max_retries, dop.exchange.fallback = op.max_retries, op.fallback
    return dop


def _host_resume_fallback(op, device: torch.device, b, tol: float, maxiter: int, solver: str,
                          ck: Optional[_Checkpoint], rc0: int,
                          init_mv_adjust: int) -> SolveResult:
    """Ladder exhausted: continue on the host loop (whose exchange carries
    its own per-call ladder) from the checkpoint, on the solve's device,
    stitching the fused history prefix onto the host continuation."""
    from repro_torch.solve import krylov

    host = krylov.cg if solver == "cg" else krylov.bicgstab
    dop = _on_device(op, device)
    if ck is None:
        res = host(dop, b, tol=tol, maxiter=maxiter)
        base = res.status.split("+")[0]
        return dataclasses.replace(
            res, status=_finish_status(base + "+resume:0", res.restarts, op, rc0))
    prefix = [float(h) for h in _read(ck.state["hist"][: ck.k])]
    res = host(dop, b, x0=ck.state["x"], tol=tol, maxiter=maxiter - ck.it)
    base = res.status.split("+")[0]
    return SolveResult(
        x=res.x,
        converged=res.converged,
        iterations=ck.it + res.iterations,
        residuals=tuple(prefix + list(res.residuals[1:])),
        matvecs=ck.mvc - init_mv_adjust + res.matvecs,
        status=_finish_status(base + "+resume:1", res.restarts, op, rc0),
        restarts=res.restarts,
    )


def fused_cg(op, b, x0=None, tol: float = 1e-6, maxiter: int = 500, reductions=None,
             checkpoint_every: Optional[int] = None, *, device: DeviceLike = None) -> SolveResult:
    """Whole-solve CG: replayed CUDA graphs, no host read per iteration.

    Drop-in for :func:`repro_torch.solve.krylov.cg` (same contract, same
    ``SolveResult`` fields, the same residual history); ``op`` may be a
    :class:`~repro_torch.sparse.spmv.DistributedSpMV` (solved on its device)
    or a :class:`~repro_torch.solve.operator.NumpySpMV` (lowered onto
    ``device``: left out, the CUDA device) or a ``DistributedSpMV(group=)``
    (one rank of a process group: ``b`` is this rank's ``[1, L]``, every
    rank calls at once, and its hops stage through the host between the
    replayed graphs).  The captured solve is cached per operator, pattern,
    strategy, codec, dtype and ``maxiter`` -- see
    ``repro_torch.comm.cache_stats().fused_*`` (over a process group on the
    operator itself).  ``reductions`` contributes only its inter-pod
    compressor (the hierarchical tree runs on the device, over a group in
    :class:`~repro_torch.solve.reductions.GroupReductions`' order); pass the
    one you would hand the host loop.

    ``checkpoint_every=N`` arms fault tolerance: a checkpoint refreshed every
    ``N`` clean iterations, and an ``ExchangeIntegrityError`` from a
    ``verify=True`` operator recovered on the host -- the ladder resumes the
    fused solve from the checkpoint on a healthy (strategy, codec), falling
    back to the host loop on the same device -- losing at most ``N``
    iterations (``status`` gains ``+resume:<n>``).  Fault-free solves are
    the same either way.
    """
    return _fused_solve(op, b, x0, tol, maxiter, reductions, "cg", checkpoint_every, device)


def fused_bicgstab(op, b, x0=None, tol: float = 1e-6, maxiter: int = 500, reductions=None,
                   checkpoint_every: Optional[int] = None, *,
                   device: DeviceLike = None) -> SolveResult:
    """Whole-solve BiCGStab; see :func:`fused_cg` (drop-in for
    :func:`repro_torch.solve.krylov.bicgstab`)."""
    return _fused_solve(op, b, x0, tol, maxiter, reductions, "bicgstab", checkpoint_every,
                        device)


FUSED_SOLVERS = {"cg": fused_cg, "bicgstab": fused_bicgstab}
