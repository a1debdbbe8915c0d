"""A ``torch.distributed`` world of one process per rank: the paper's case
study on a real process group.

The counterpart of the reference's forced host devices feeding
``make_exchange_mesh``: :func:`run_world` starts ``topo.nranks`` processes
(forked by a fork server that has imported torch and :data:`RANK_PRELOAD`
once, and never CUDA: a child forked after CUDA is initialised cannot use
it, and one forked from a process that ran torch's CPU ops may inherit its
thread pools), joins them through a ``file://`` store in a fresh temporary
directory (two worlds on one machine never share a TCP port), builds each
rank's :class:`~repro_torch.comm.topology.ExchangeGroup` and calls
``fn(group, device, *args)`` there.  Each rank uses one CPU thread.  The
backend is gloo, or the group that stages every collective through host
memory around gloo (``backend="staged"``, :mod:`repro_torch.comm.staged`,
which the launchers' ``--mesh`` worlds run on): NCCL refuses two ranks of
one communicator on one card, so every hop stages its payload through host
memory (the paper's staged-through-host path).  A rank that raises ends
the world: the others are killed and :class:`WorldError` carries that
rank's number and traceback, within ``timeout_s``.

``python -m repro_torch.launch.world --topo 4x4 --rows 1048576 --out DIR``
runs :func:`case_study` on the card (``--device cpu`` on the host): it
builds ``spd_system(thermal_like(rows))`` and its partition from the seed
once (:func:`build_problem`, :func:`write_problem`; ``--problem`` takes
them ready-made), every rank loads its rows and plans from them, then
holds its own ``[1, L]`` block and runs

* the exchange of every strategy, barrier and split-phase, codecs ``none``,
  ``bf16`` and ``int8``: each rank's halo bitwise row ``r`` of the stacked
  :class:`~repro_torch.comm.strategies.IrregularExchange` (rank 0 runs it
  and gathers the halos), and with ``none`` bitwise ``execute_numpy``;
* ``DistributedSpMV(group=)``: overlap == barrier, ``matmat`` ==
  ``matmat_looped``, ``w`` equal across strategies and bitwise the stacked
  operator's row;
* CG (``spd_system``) and BiCGStab (``shifted_system``) with every strategy
  and ``auto``, barrier and overlap (on CUDA ranks overlap for CG on
  ``FAULT_SOLVE_STRATEGY`` only, and BiCGStab on :data:`CARD_BICGSTAB`
  only): converged, histories bitwise equal across them and across ranks,
  the true residual, and the stacked host loop's status, iterations
  (within one) and ``x`` (within 1e-4);
* checks, faults and the recovery ladder: every strategy x barrier/split
  (on CUDA ranks the split phase on ``FAULT_SOLVE_STRATEGY`` only) x
  codecs ``none`` and ``int8`` with ``verify=True`` on a normal payload
  (clean: no raise, bitwise the unchecked halo), a transient corruption
  (retry), a lossy-codec corruption (demote, ``int8``) and a persistent
  perturbation of the strategy (re-advise): each rank's halo bitwise row
  ``r`` of the stacked guarded exchange (rank 0), that one bitwise
  ``execute_numpy(faults=, fault_call=, verify=True)`` of the attempt that
  succeeded, the recovery key and health events equal on every rank and to
  the stacked run's; with ``fallback=False`` a persistent corruption raises
  on every rank with the stacked raise's hop and one violation; CG checked
  and CG through a retried fault, converged with the clean history bitwise
  and one status on every rank; ms per checked vs unchecked exchange;
* the fused whole-solve (``fused_cg`` / ``fused_bicgstab`` on the group's
  operators, :func:`_fused_solves`): for every strategy and codec, a first
  solve that captures and a second that replays, bitwise the grouped host
  loop and the stacked host loop in the group tree's order, B1 only by
  graph replays on CUDA ranks, one host read per block; a checked solve, a
  persistent fault every rank raises as the stacked fused solve does, a
  transient fault every rank resumes on the same rung; ms per iteration
  fused vs host loop and the capture seconds;
* the reductions: the on-pod-then-inter-pod tree bitwise ``_tree_sum`` of
  the gathered partials; with ``Compressor()`` one value on every rank,
  within one quantum of the stacked ``TorchReductions``; a CG on the
  compressed tree with one history on every rank and the stacked loop's
  status; ms per dot, tree vs one all-gather over the world;
* B1/B2 launches per rank against a count predicted from the calls made;
* the guards: NCCL, a ``("pod", "local")`` mesh of fake groups handed to
  ``exchange_group_of_mesh``, a rank with another strategy and a rank with
  another fault plan each raise;
* the MoE exchange dispatch (on CUDA ranks one llama4-scout layer at full
  width, one expert per rank in bf16, batch ``nranks x 1024``; on the host
  the same layer narrowed) on the world's ``("pod", "local")``
  ``DeviceMesh``, uniform and skewed routing: each rank's output bitwise
  across the four strategies and ``auto`` and bitwise the mesh all-to-all
  (``ep_axis=("pod", "local")``), the gathered output bitwise the stacked
  ``_dispatch_exchange`` on rank 0, the slots routed / dropped / shipped
  summed over the ranks equal to the stacked run's, the int8 wire bitwise
  the stacked int8 run and not the full-precision output, planning on the
  first of ``MOE_REPS`` uniform calls only; ms per layer call per strategy,
  of the mesh all-to-all and of the stacked layer (mean of ``MOE_TIMED``)
  and of the count all-gather (mean of 50);

and writes ``DIR/world.json``; it exits 1 if any gate failed.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import multiprocessing.connection
import multiprocessing.forkserver
import os
import pickle
import resource
import sys
import tempfile
import time
import traceback
from collections import Counter
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.compression import Compressor, int8_scale
from repro_torch.comm.exchange import execute_numpy
from repro_torch.comm.faults import ExchangeIntegrityError, FaultPlan, FaultSpec
from repro_torch.comm.staged import BACKEND as STAGED
from repro_torch.comm.staged import register as register_staged
from repro_torch.comm.strategies import STRATEGY_NAMES, IrregularExchange, planned
from repro_torch.comm.topology import PodTopology, check_backend, exchange_group_of_mesh, make_exchange_group
from repro_torch.core.device import device_for_rank, resolve_device
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.spmv_ell import spmm_ell, spmv_ell
from repro_torch.solve.fused import fused_bicgstab, fused_cg
from repro_torch.solve.krylov import bicgstab, cg
from repro_torch.solve.problems import shifted_system, spd_system
from repro_torch.solve.reductions import GroupReductions, NumpyReductions, TorchReductions, _tree_sum
from repro_torch.sparse.matrices import GENERATORS
from repro_torch.sparse.partition import partition_csr, rank_partition
from repro_torch.sparse.spmv import DistributedSpMV

#: the case study's tolerances (PERF.md §2): CG/BiCGStab to 1e-6, a true
#: residual under 1e-5, ``x`` within 1e-4 of the stacked solve
TOL_SOLVE = 1e-6
TOL_TRUE = 1e-5
TOL_X = 1e-4
TOL_SPMV = 1e-5
CODECS = ("none", "bf16", "int8")
MODES = ("barrier", "split")
#: trailing feature widths of the exchange payloads (the SpMV's gates run
#: the ``[1, L]`` vector and the ``[1, L, k]`` block through the exchange)
FEATS = ((3,),)
TIMED_REPS = 10
MAXITER = 1000
#: the faults section's codecs, and the strategy of its solves and of the
#: compressed-reduction CG
FAULT_CODECS = ("none", "int8")
FAULT_SOLVE_STRATEGY = "two_step"
#: the strategies whose BiCGStab runs on CUDA ranks, host loop and fused:
#: the advisor's pick on the case study and :data:`FAULT_SOLVE_STRATEGY`
#: (the histories are bitwise equal across strategies; the host worlds of
#: ``tests/test_torch_world.py`` hold the others and ``auto``)
CARD_BICGSTAB = ("standard", FAULT_SOLVE_STRATEGY)
#: the fused section's codecs (:func:`_fused_case`), the strategies of its
#: int8 cases on CUDA ranks, and the iterations of its persistent-fault
#: solve (it raises after its dispatch, whatever its length)
FUSED_CODECS = ("none", "int8")
FUSED_CARD_INT8 = ("two_step", "three_step")
FUSED_DETECT_MAXITER = 10
#: the compressed reductions' CG tolerance (int8 pod sums, ~0.4% per dot)
TOL_COMPRESSED = 1e-4
MAXITER_COMPRESSED = 200
#: dots per timing of the reduction tree and the flat all-gather
DOT_REPS = 50
#: the MoE section's layer (llama4-scout's, at full width on CUDA ranks),
#: its strategies and timed calls
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_STRATEGIES = STRATEGY_NAMES + ("auto",)
MOE_REPS = 5
MOE_TIMED = 3


class WorldError(RuntimeError):
    """A rank of the world raised; ``rank`` and ``traceback`` are its."""

    def __init__(self, rank: int, tb: str):
        super().__init__(f"rank {rank} of the world raised:\n{tb}")
        self.rank = rank
        self.traceback = tb


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, topo: Union[PodTopology, int], device: Optional[str], backend: str,
               timeout_s: float, store: str, out_dir: str, args: tuple, kwargs: dict) -> None:
    """One rank: join the world, run ``fn``, write its JSON result (or its
    traceback, and leave at once: the other ranks may be blocked in a
    collective this rank never reaches)."""
    try:
        timeline = {"entered": time.time()}
        torch.set_num_threads(1)
        timeout = timedelta(seconds=timeout_s)
        if backend == STAGED:
            register_staged()
        dist.init_process_group(backend, init_method=store, rank=rank, world_size=_nranks(topo),
                                timeout=timeout)
        timeline["joined"] = time.time()
        group = rank if isinstance(topo, int) else make_exchange_group(topo, backend, timeout=timeout)
        timeline["grouped"] = time.time()
        dev = torch.device("cpu") if device == "cpu" else device_for_rank(rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.empty(1, device=dev)  # the context exists from here on
        timeline["device"] = time.time()
        result = fn(group, dev, *args, **kwargs)
        if isinstance(result, dict):
            result.setdefault("timeline", timeline)
        path = os.path.join(out_dir, f"rank{rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(result, f)
        os.replace(path + ".tmp", path)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        tb = traceback.format_exc()
        path = os.path.join(out_dir, f"rank{rank}.err")
        with open(path + ".tmp", "w") as f:
            json.dump({"rank": rank, "time": time.time(), "traceback": tb}, f)
        os.replace(path + ".tmp", path)  # whole, even if this rank is killed next
        sys.stderr.write(f"[rank {rank}] {tb}")
        sys.stderr.flush()
        os._exit(1)


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]  # those started
    for p in procs:
        if p.exitcode is None:
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.exitcode is None:
            p.kill()
            p.join()


def _first_error(out_dir: str, failed: List[int], procs) -> WorldError:
    """The rank that raised first (its error file's time): the others may
    have failed after it, on its closed connections."""
    errors = []
    for name in os.listdir(out_dir):
        if name.endswith(".err"):
            with open(os.path.join(out_dir, name)) as f:
                errors.append(json.load(f))
    if errors:
        first = min(errors, key=lambda e: e["time"])
        return WorldError(first["rank"], first["traceback"])
    r = failed[0]
    return WorldError(r, f"exited with code {procs[r].exitcode} and wrote no traceback")


def _nranks(topo: Union[PodTopology, int]) -> int:
    return topo if isinstance(topo, int) else topo.nranks


#: the modules the fork server imports before it forks any rank: torch,
#: DTensor and the port's packages that the ranks' programs import.  None
#: of them initialises CUDA or runs a torch op on import, so each rank forks
#: with them loaded and sets up its own device and threads.  No module run
#: as ``python -m`` (this one, the launchers, the examples) is among them:
#: a rank runs its parent's main module again, and runpy warns when that
#: module is loaded already.
RANK_PRELOAD = ("torch", "torch.distributed", "torch.distributed.tensor", "repro_torch.comm", "repro_torch.solve",
                "repro_torch.sparse", "repro_torch.models.lm")


def rank_context():
    """The multiprocessing context :func:`run_world` starts its ranks from:
    ``forkserver`` with :data:`RANK_PRELOAD`, so a world pays one import of
    torch and the port per process that starts worlds (the server's), not
    one per rank."""
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(RANK_PRELOAD))
    return ctx


def start_rank_server() -> None:
    """Start :func:`run_world`'s fork server now: it imports
    :data:`RANK_PRELOAD` while this process goes on, so the first world
    need not wait for it.  A rank inherits the server's environment, as it
    was when the server started."""
    rank_context()
    multiprocessing.forkserver.ensure_running()


def run_world(fn: Callable, topo: Union[PodTopology, int], *, device: Optional[str] = None,
              backend: str = "gloo", timeout_s: float = 600.0, args: Sequence = (),
              kwargs: Optional[dict] = None) -> list:
    """Start ``topo.nranks`` processes (:func:`rank_context`) and return
    ``fn(group, device, *args, **kwargs)`` of each rank (JSON values), in
    rank order.  ``topo`` an ``int`` starts that many processes joined in a
    plain world, with no exchange group: ``fn`` then takes the rank's
    number as ``group`` (the launchers build their own mesh on it).

    ``fn`` must be importable by name (a module-level function).  A dict
    result gains ``"timeline"``: the epoch seconds at which the rank
    entered (its imports done), joined the store, built its groups and held
    its device.
    ``device="cpu"`` runs every rank on the host; left out, rank ``r`` runs
    on ``cuda:(r % device_count)``.  ``backend`` is ``"gloo"`` or
    ``"staged"`` (every collective staged through host memory, so DTensor
    programs run on CUDA ranks too).  ``timeout_s`` bounds the whole world
    and each of its collectives; past it every rank is killed and
    :class:`TimeoutError` raised.  A rank that raises ends the world with
    :class:`WorldError`.
    """
    check_backend(backend)
    ctx = rank_context()
    with tempfile.TemporaryDirectory(prefix="repro_world_") as d:
        procs = [
            ctx.Process(target=_rank_main, args=(r, fn, topo, device, backend, timeout_s,
                                                 f"file://{d}/store", d, tuple(args), kwargs or {}))
            for r in range(_nranks(topo))
        ]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while True:
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                alive = [p for p in procs if p.exitcode is None]
                if failed or not alive:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"the world of {_nranks(topo)} ranks did not end within {timeout_s} s; "
                        f"ranks {[r for r, p in enumerate(procs) if p.exitcode is None]} were running"
                    )
                multiprocessing.connection.wait([p.sentinel for p in alive], timeout=min(left, 1.0))
            if failed:
                _stop(procs)
                raise _first_error(d, failed, procs)
        finally:
            _stop(procs)
        results = []
        for r in range(_nranks(topo)):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def run_launcher(module: str, argv: Optional[Sequence[str]] = None) -> dict:
    """A launcher's ``main`` (``launch.train``, ``launch.serve``): the
    module's ``parse_args(argv)``, then its ``run(args, device, mesh)`` on a
    ``--mesh`` of ``D x M`` ranks.  With one rank, or in a process group
    already initialised (this process one rank of it), it runs here;
    otherwise it spawns ``D * M`` processes joined by the staged group
    (:func:`run_world` with ``backend="staged"``, on the host and on CUDA
    ranks alike; without ``--device`` a machine with no card raises before
    it spawns) and returns rank 0's ``summary(out)`` and kernel launches
    with every rank's under ``"ranks"``."""
    import importlib

    from repro_torch.launch.mesh import make_host_mesh, parse_mesh

    mod = importlib.import_module(module)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = mod.parse_args(argv)
    data, model = parse_mesh(args.mesh)
    if data * model > 1 and not dist.is_initialized():
        if args.device is None:
            device_for_rank(0)  # no card: raise here, before any rank is spawned
        ranks = run_world(_launcher_rank, data * model, device=args.device, backend=STAGED, args=(module, argv),
                          timeout_s=3600.0)
        return {**ranks[0], "ranks": ranks}
    device = args.device
    if device is None and dist.is_initialized():
        device = device_for_rank(dist.get_rank())
    device = resolve_device(device)
    return mod.run(args, device, make_host_mesh(data, model, device.type))


def _launcher_rank(rank: int, device: torch.device, module: str, argv: list) -> dict:
    """One rank of a launcher's spawned world: its ``summary``, the seconds
    of the launcher's ``run`` (``run_s``), its kernel launches, B3's by
    route and by shape (``flash_attention.by_route``,
    ``by_shape``: ``[q, k, v shapes, causal, window, launches]``), its
    staged collectives (``staged.stats``: calls, host seconds and bytes per
    collective) and its device's peak allocated bytes (``None`` on the
    host)."""
    import importlib

    from repro_torch.comm import staged
    from repro_torch.examples import launch_counts
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_host_mesh, parse_mesh

    mod = importlib.import_module(module)
    before, routes, shapes = launch_counts(), Counter(flash_attention.by_route), Counter(flash_attention.by_shape)
    collectives = staged.stats()
    args = mod.parse_args(argv)
    t0 = time.perf_counter()
    out = mod.run(args, device, make_host_mesh(*parse_mesh(args.mesh), device.type))
    run_s = time.perf_counter() - t0
    was = lambda name: Counter(collectives.get(name, {}))
    return {"rank": rank, "device": str(device), **mod.summary(out), "run_s": run_s,
            "launches": {k: v - before[k] for k, v in launch_counts().items()},
            "b3_routes": dict(Counter(flash_attention.by_route) - routes),
            "b3_shapes": [[*key, n] for key, n in (Counter(flash_attention.by_shape) - shapes).items()],
            "staged": {name: dict(Counter(c) - was(name)) for name, c in staged.stats().items()},
            "device_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None}


def probe(group, device: torch.device, fail_rank: int = -1) -> dict:
    """The world's smallest program: one all-gather of the ranks' numbers.
    ``fail_rank`` raises on that rank before the collective, which shows
    how a failing rank ends the world."""
    if group.rank == fail_rank:
        raise ValueError(f"rank {group.rank} fails on purpose before the world's first collective")
    got = [torch.zeros(1, dtype=torch.int64) for _ in range(group.topo.nranks)]
    dist.all_gather(got, torch.tensor([group.rank]))
    return {"rank": group.rank, "ranks": [int(t) for t in got], "device": str(device)}


#: the collectives a DTensor program issues (``_functional_collectives``),
#: and what :func:`probe_collectives` tries: those, and the all-gather as a
#: plain ``torch.distributed`` call (``all_gather_c10d``), beside DTensor's
COLLECTIVES = ("all_gather", "reduce_scatter", "all_to_all", "all_reduce")
PROBES = COLLECTIVES + ("all_gather_c10d",)


def collective(rank: int, device: torch.device, name: str, misshape_rank: int = -1) -> dict:
    """One collective of a DTensor program, as DTensor issues it
    (``_functional_collectives`` on the world group, of whichever backend),
    on this rank's ``[world]`` tensor of ``device`` holding its rank:
    ``{"ok": the values every rank should get, "values": what this rank
    got, "backend": the world's}``.  With ``all_gather_c10d``, rank
    ``misshape_rank`` hands the all-gather an output one element short,
    which gloo refuses (how a backend's own error ends the world)."""
    from torch.distributed import _functional_collectives as funcol

    world = dist.get_world_size()
    t = torch.full((world,), float(rank), device=device)
    total = float(sum(range(world)))
    ranks = torch.arange(world, dtype=torch.float32, device=device)
    grp = dist.group.WORLD
    if name == "all_gather":
        out, want = funcol.all_gather_tensor(t, 0, grp), ranks.repeat_interleave(world)
    elif name == "reduce_scatter":
        out, want = funcol.reduce_scatter_tensor(t, "sum", 0, grp), torch.full((1,), total, device=device)
    elif name == "all_to_all":
        out, want = funcol.all_to_all_single(t, None, None, grp), ranks
    elif name == "all_reduce":
        out, want = funcol.all_reduce(t, "sum", grp), torch.full((world,), total, device=device)
    elif name == "all_gather_c10d":
        out, want = torch.empty(world * world, device=device), ranks.repeat_interleave(world)
        dist.all_gather_into_tensor(out[1:] if rank == misshape_rank else out, t)
    else:
        raise ValueError(f"unknown collective {name!r}; one of {PROBES}")
    out = funcol.wait_tensor(out) if isinstance(out, funcol.AsyncCollectiveTensor) else out
    return {"rank": rank, "ok": bool(torch.equal(out, want)), "values": out.tolist(),
            "backend": dist.get_backend()}


def collectives(rank: int, device: torch.device) -> dict:
    """Every one of :data:`PROBES` in turn on this world: ``{name:
    collective(rank, device, name)}``."""
    return {name: collective(rank, device, name) for name in PROBES}


def probe_collectives(device: Optional[str] = None, nranks: int = 2, timeout_s: float = 120.0,
                      backend: str = "gloo") -> dict:
    """Which of :data:`PROBES` the ``backend`` group (``"gloo"`` or
    ``"staged"``) runs on ``device`` tensors (left out, each rank's CUDA
    device): ``{name: "ok" | "wrong values" | the world's error}``, one
    world per collective (a collective without a path may end its
    process), the worlds at once."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name: str) -> str:
        try:
            ranks = run_world(collective, nranks, device=device, backend=backend, timeout_s=timeout_s,
                              args=(name,))
        except (WorldError, TimeoutError) as e:
            return f"{type(e).__name__}: {str(e).splitlines()[-1][:200]}"
        return "ok" if all(r["ok"] for r in ranks) else "wrong values"

    with ThreadPoolExecutor(len(PROBES)) as pool:
        return dict(zip(PROBES, pool.map(one, PROBES)))


def dot_operands(topo: PodTopology, length: int, seed: int) -> list:
    """Stacked ``[nranks, length]`` float32 operand pairs for :func:`dots`,
    their values spread over seven binades (so a change of summation order
    shows in the last bits)."""
    rng = np.random.default_rng(seed)
    x, y = ((rng.normal(size=(topo.nranks, length)) * 10.0 ** rng.integers(-3, 4, size=(topo.nranks, length)))
            .astype(np.float32) for _ in range(2))
    return [(x, x), (x, y), (y, -x)]


def dots(group, device: torch.device, length: int = 64, seed: int = 0) -> dict:
    """The reduction tree on :func:`dot_operands`: this rank's tree and
    int8-compressed dot of each pair (``GroupReductions``), as ``float.hex``
    so every bit survives JSON."""
    r = group.rank
    tree, comp = GroupReductions(group.topo, group), GroupReductions(group.topo, group, Compressor())
    out = []
    for x, y in dot_operands(group.topo, length, seed):
        xs, ys = (torch.as_tensor(a[r : r + 1], device=device) for a in (x, y))
        out.append({"tree": tree.dot(xs, ys).hex(), "compressed": comp.dot(xs, ys).hex()})
    return {"rank": r, "dots": out}


# ---------------------------------------------------------------------------
# The case study
# ---------------------------------------------------------------------------


def payload(topo: PodTopology, L: int, feat: tuple, seed: int) -> np.ndarray:
    """The exchange's stacked ``[nranks, L, *feat]`` float32 payload: values
    over many binades, and in each rank's first and last rows an inf, a nan,
    a -inf and a value beyond float16's range (the codecs' special cases)."""
    rng = np.random.default_rng(seed)
    shape = (topo.nranks, L) + tuple(feat)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
    for row, value in ((0, np.inf), (1, np.nan), (-1, -np.inf), (-2, 7e4)):
        x[:, row % L] = value
    return x


def inputs(topo: PodTopology, L: int, seed: int, mm_cols: int) -> dict:
    """The stacked SpMV and solve operands, from the seed."""
    rng = np.random.default_rng(seed + 4)
    return {
        "v": rng.normal(size=(topo.nranks, L)).astype(np.float32),
        "V": rng.normal(size=(topo.nranks, L, mm_cols)).astype(np.float32),
        "b": rng.normal(size=(topo.nranks, L)).astype(np.float32),
        "b2": rng.normal(size=(topo.nranks, L)).astype(np.float32),
    }


def fault_payload(topo: PodTopology, L: int, seed: int) -> np.ndarray:
    """The faults section's stacked ``[nranks, L]`` float32 payload: normal
    values, on which every check of a clean call passes."""
    return np.random.default_rng(seed + 12).normal(size=(topo.nranks, L)).astype(np.float32)


def fault_cases(strategy: str, seed: int) -> dict:
    """The faults section's cases for ``strategy``: ``name -> (codecs,
    IrregularExchange keyword arguments)``.  ``clean`` checks a fault-free
    call; ``retry`` corrupts the first call only; ``demote`` corrupts every
    lossy-codec hop (so ``int8`` alone); ``readvise`` perturbs every hop of
    ``strategy``; ``detect`` corrupts every call with no retry or fallback."""
    corrupt = FaultSpec(kind="corrupt")
    return {
        "clean": (FAULT_CODECS, dict(verify=True)),
        "retry": (FAULT_CODECS, dict(verify=True, faults=FaultPlan(seed=seed, specs=(corrupt,),
                                                                     active_calls=(0,)))),
        "demote": (("int8",), dict(verify=True, faults=FaultPlan(
            seed=seed, specs=(FaultSpec(kind="corrupt", codecs=("lossy",)),)))),
        "readvise": (FAULT_CODECS, dict(verify=True, faults=FaultPlan(
            seed=seed, specs=(FaultSpec(kind="perturb", strategies=(strategy,)),)))),
        "detect": (FAULT_CODECS, dict(verify=True, faults=FaultPlan(seed=seed, specs=(corrupt,)),
                                      max_retries=0, fallback=False)),
    }


def systems(matrix: str, rows: int, seed: int):
    """``(spd_system(M), shifted_system(M'))`` of the generator ``matrix``."""
    gen = GENERATORS[matrix]
    return (spd_system(gen(rows, np.random.default_rng(seed))),
            shifted_system(gen(rows, np.random.default_rng(seed + 1))))


def build_problem(topo: PodTopology, matrix: str, rows: int, seed: int) -> tuple:
    """``(A, B, part, part_b)``: :func:`systems` and their partitions over
    ``topo``."""
    A, B = systems(matrix, rows, seed)
    return A, B, partition_csr(A, topo), partition_csr(B, topo)


def write_problem(directory: str, A, B, part, part_b) -> None:
    """Write what each rank of a world holds of :func:`build_problem`'s
    systems to ``directory``, so a world builds them once: rank 0 the
    systems and partitions whole (its stacked checks need them), every
    other rank its :func:`~repro_torch.sparse.partition.rank_partition` of
    each (its rows, the pattern whole)."""
    sizes = {"n": A.n, "nnz": A.nnz}
    for r in range(part.topo.nranks):
        held = (A, B, part, part_b) if r == 0 else (None, None, rank_partition(part, r), rank_partition(part_b, r))
        with open(os.path.join(directory, f"problem{r}.pkl"), "wb") as f:
            pickle.dump((sizes, *held), f, protocol=pickle.HIGHEST_PROTOCOL)


def load_problem(directory: str, rank: int) -> tuple:
    """Rank ``rank``'s share of :func:`write_problem`: ``(sizes, A, B, part,
    part_b)``, ``A`` and ``B`` ``None`` off rank 0."""
    with open(os.path.join(directory, f"problem{rank}.pkl"), "rb") as f:
        return pickle.load(f)


def product64(A, v: np.ndarray, absolute: bool = False) -> np.ndarray:
    """``A @ v`` (or ``|A| @ |v|``, the scale of its rounding) in float64 on
    the host (``v: [n]``)."""
    rows = np.repeat(np.arange(A.n), np.diff(A.indptr))
    data, vals = A.data.astype(np.float64), v.astype(np.float64)[A.indices]
    if absolute:
        data, vals = np.abs(data), np.abs(vals)
    return np.bincount(rows, weights=data * vals, minlength=A.n)


def _same_bits(a, b) -> bool:
    a, b = torch.as_tensor(a).contiguous(), torch.as_tensor(b).contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gather0(t: torch.Tensor, group) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (same shape) on rank 0, through the host."""
    t = t.detach().cpu().contiguous()
    out = [torch.empty_like(t) for _ in range(group.topo.nranks)] if group.rank == 0 else None
    dist.gather(t, out, dst=0)
    return out


def _gather_rows(t: torch.Tensor, group) -> Optional[List[torch.Tensor]]:
    """Rank 0 gets every rank's ``t[0]``."""
    got = _gather0(t, group)
    return None if got is None else [x[0] for x in got]


def _barrier() -> None:
    dist.barrier()


def _all_max(x: float, group) -> float:
    got = [torch.zeros(1, dtype=torch.float64) for _ in range(group.topo.nranks)]
    dist.all_gather(got, torch.tensor([float(x)], dtype=torch.float64))
    return max(float(t) for t in got)


def _all_same(value, group) -> bool:
    """Whether every rank holds the same ``value`` (by the hash of its repr)."""
    h = int.from_bytes(hashlib.sha1(repr(value).encode()).digest()[:8], "little", signed=True)
    got = [torch.zeros(1, dtype=torch.int64) for _ in range(group.topo.nranks)]
    dist.all_gather(got, torch.tensor([h], dtype=torch.int64))
    return len(Counter(int(t) for t in got)) == 1


class _Launches:
    """B1/B2 launches of the grouped calls made inside :meth:`counted`
    (rank 0's stacked comparisons run outside it)."""

    def __init__(self):
        self.n = {"spmv_ell": 0, "spmm_ell": 0}

    @contextlib.contextmanager
    def counted(self):
        before = (spmv_ell.launches, spmm_ell.launches)
        try:
            yield
        finally:
            self.n["spmv_ell"] += spmv_ell.launches - before[0]
            self.n["spmm_ell"] += spmm_ell.launches - before[1]


def _exchanges(group, device, part, seed: int, keep: bool, gates: dict, out: dict) -> dict:
    """Every strategy x codec x barrier/split, each rank's halo held to the
    stacked exchange's row on rank 0; then ms per staged exchange."""
    topo, r, L = group.topo, group.rank, part.rows_per_rank
    for fi, feat in enumerate(FEATS):
        full = payload(topo, L, feat, seed + 3 + fi)
        mine = torch.as_tensor(full[r : r + 1], device=device)
        for codec in CODECS:
            for strat in STRATEGY_NAMES:
                ex = IrregularExchange(part.pattern, strat, device=device, wire=codec, group=group)
                stacked = None
                if r == 0:
                    stacked = IrregularExchange(part.pattern, strat, device=device, wire=codec)(
                        torch.as_tensor(full, device=device)).cpu()
                    if codec == "none":
                        want = execute_numpy(ex.plan, full)
                        gates[f"stacked {strat} {feat} == execute_numpy"] = _same_bits(stacked, torch.as_tensor(want))
                for mode in MODES:
                    halo = ex(mine) if mode == "barrier" else ex.start(mine).finish()
                    key = f"{strat}|{mode}|{codec}|{feat}"
                    if keep:  # as int32 bit patterns: JSON drops a nan's sign and payload
                        out.setdefault("halos", {})[key] = halo.cpu().view(torch.int32).numpy().tolist()
                    halos = _gather0(halo, group)
                    if r == 0:
                        gates[f"exchange {key} == stacked rows"] = all(
                            _same_bits(h[0], stacked[q]) for q, h in enumerate(halos))
    # ms per staged exchange: the slowest rank's host wall, [1, L] float32
    ms = {}
    v = torch.as_tensor(payload(topo, L, (), seed + 3)[r : r + 1], device=device)
    for codec in ("none", "int8"):
        for strat in STRATEGY_NAMES:
            ex = IrregularExchange(part.pattern, strat, device=device, wire=codec, group=group)
            for mode in MODES:
                call = (lambda: ex(v)) if mode == "barrier" else (lambda: ex.start(v).finish())
                call()
                _sync(device)
                _barrier()
                t0 = time.perf_counter()
                for _ in range(TIMED_REPS):
                    call()
                _sync(device)
                ms[f"{strat}|{mode}|{codec}"] = _all_max((time.perf_counter() - t0) / TIMED_REPS * 1e3, group)
    return ms


def _spmv(group, device, A, part, data: dict, keep: bool, gates: dict, out: dict, launches: _Launches,
          predicted: dict) -> None:
    """``DistributedSpMV(group=)`` of every strategy, barrier and overlap,
    vector and ``matmat``: bitwise among themselves and the stacked rows."""
    r = group.rank
    v = torch.as_tensor(data["v"][r : r + 1], device=device)
    V = torch.as_tensor(data["V"][r : r + 1], device=device)
    k = V.shape[2]
    first = None
    for strat in STRATEGY_NAMES:
        op = DistributedSpMV(part, strategy=strat, device=device, group=group)
        ov = DistributedSpMV(part, strategy=strat, device=device, overlap=True, group=group)
        with launches.counted():
            w, w_ov = op(v), ov(v)
            W, W_looped, W_ov = op.matmat(V), op.matmat_looped(V), ov.matmat(V)
        # barrier and overlap SpMV 2 B1 each, k columns looped 2 B1 each,
        # barrier and overlap SpMM 2 B2 each
        predicted["spmv_ell"] += 2 * (2 + k)
        predicted["spmm_ell"] += 4
        if first is None:
            first = (w, W)
        gates[f"spmv {strat}: overlap == barrier"] = _same_bits(w_ov, w)
        gates[f"spmv {strat}: matmat == matmat_looped, overlap == barrier"] = (
            _same_bits(W, W_looped) and _same_bits(W_ov, W))
        gates[f"spmv {strat}: w, W == standard's"] = _same_bits(w, first[0]) and _same_bits(W, first[1])
        if keep:
            out.setdefault("w", {})[strat] = w.cpu().numpy().tolist()
            out.setdefault("W", {})[strat] = W.cpu().numpy().tolist()
        ws, Ws = _gather0(w, group), _gather0(W, group)
        if r == 0:
            st = DistributedSpMV(part, strategy=strat, device=device)
            w_st = st(torch.as_tensor(data["v"], device=device)).cpu()
            W_st = st.matmat(torch.as_tensor(data["V"], device=device)).cpu()
            gates[f"spmv {strat}: w == stacked rows"] = all(_same_bits(x[0], w_st[q]) for q, x in enumerate(ws))
            gates[f"spmv {strat}: W == stacked rows"] = all(_same_bits(x[0], W_st[q]) for q, x in enumerate(Ws))
    rows = _gather_rows(first[0], group)
    if r == 0:
        v64 = data["v"].reshape(-1)
        err = np.abs(torch.cat(rows).numpy().reshape(-1) - product64(A, v64))
        out["spmv_rel_err"] = float((err / (product64(A, v64, absolute=True) + 1e-30)).max())
        gates[f"spmv: max |w - w64| / (|A||v|) = {out['spmv_rel_err']:.3e} <= {TOL_SPMV}"] = (
            out["spmv_rel_err"] <= TOL_SPMV)


def _solves(group, device, systems_, parts, data: dict, keep: bool, gates: dict, out: dict,
            launches: _Launches, predicted: dict, histories: dict, host_runs: dict) -> dict:
    """CG on ``spd_system`` and BiCGStab on ``shifted_system`` with every
    strategy and ``auto`` (:func:`_solved`), barrier and overlap (on CUDA
    ranks overlap for CG on :data:`FAULT_SOLVE_STRATEGY` only:
    :func:`_overlapped`); rank 0 holds
    the result to the stacked host loop.  Returns each run's summary;
    ``histories`` gets each solver's (common) residual history,
    ``host_runs`` each run's result by ``(solver, strategy, overlap)``."""
    r = group.rank
    summary = {}
    for solver, fn, M, part, rhs in (("cg", cg, systems_[0], parts[0], "b"),
                                     ("bicgstab", bicgstab, systems_[1], parts[1], "b2")):
        b = torch.as_tensor(data[rhs][r : r + 1], device=device)
        runs = {}
        for strat in STRATEGY_NAMES + ("auto",):
            if not _solved(device, solver, strat):
                continue
            for overlap in (False, True) if _overlapped(device, solver, strat) else (False,):
                op = DistributedSpMV(part, strategy=strat, device=device, overlap=overlap, group=group)
                _sync(device)
                _barrier()
                t0 = time.perf_counter()
                with launches.counted():
                    res = fn(op, b, tol=TOL_SOLVE, maxiter=MAXITER)
                _sync(device)
                wall = time.perf_counter() - t0
                predicted["spmv_ell"] += 2 * res.matvecs  # diag + off per matvec
                runs[(strat, overlap)] = host_runs[(solver, strat, overlap)] = res
                summary[f"{solver}|{strat}|{'overlap' if overlap else 'barrier'}"] = {
                    "strategy": op.strategy, "status": res.status, "iterations": res.iterations,
                    "matvecs": res.matvecs, "final_residual": res.final_residual,
                    "ms_per_iteration": _all_max(wall / max(res.iterations, 1) * 1e3, group),
                }
        ref = runs[("standard", False)]
        histories[solver] = ref.residuals
        gates[f"{solver}: every run converged"] = all(x.converged for x in runs.values())
        gates[f"{solver}: histories, x, status, matvecs bitwise equal across strategies and overlap"] = all(
            x.residuals == ref.residuals and _same_bits(x.x, ref.x)
            and (x.status, x.matvecs) == (ref.status, ref.matvecs) for x in runs.values())
        gates[f"{solver}: every rank holds the same history"] = _all_same(ref.residuals, group)
        if keep:
            out.setdefault("solves", {})[solver] = {
                f"{s}|{o}": {"x": x.x.cpu().numpy().tolist(), "residuals": list(x.residuals),
                             "status": x.status, "iterations": x.iterations}
                for (s, o), x in runs.items()}
        xs = _gather_rows(ref.x, group)
        if r == 0:
            x = torch.cat(xs).double().numpy().reshape(-1)
            bf = data[rhs].astype(np.float64).reshape(-1)
            true = float(np.linalg.norm(bf - product64(M, x)) / np.linalg.norm(bf))
            st = fn(DistributedSpMV(part, strategy="auto", device=device),
                    torch.as_tensor(data[rhs], device=device), tol=TOL_SOLVE, maxiter=MAXITER)
            dx = float(np.abs(st.x.double().cpu().numpy().reshape(-1) - x).max())
            summary[f"{solver}|stacked"] = {"status": st.status, "iterations": st.iterations,
                                            "true_residual": true, "max_dx": dx}
            gates[f"{solver}: true residual {true:.3e} <= {TOL_TRUE}"] = true <= TOL_TRUE
            gates[f"{solver}: status {ref.status} == stacked {st.status}"] = ref.status == st.status
            gates[f"{solver}: iterations {ref.iterations} within one of stacked {st.iterations}"] = (
                abs(ref.iterations - st.iterations) <= 1)
            gates[f"{solver}: max |x - x_stacked| {dx:.3e} <= {TOL_X}"] = dx <= TOL_X
    return summary


def _guarded(ex: IrregularExchange, x: torch.Tensor, mode: str) -> tuple:
    """One guarded call, barrier or split-phase: ``(halo or None, record)``,
    the record holding the recovery key, the health events, the ladder's
    physical attempts so far and a raised error's fields."""
    halo, err = None, None
    try:
        halo = ex(x) if mode == "barrier" else ex.start(x).finish()
    except ExchangeIntegrityError as e:
        err = {**e.diagnostics(), "violation": e.violation}
    inner = ex._two_phase[0] if mode == "split" else ex
    return halo, {"recovery": ex.health.last_recovery, "events": list(ex.health.events),
                  "calls": inner._calls, "error": err}


def _from_rank0(value, group):
    """Rank 0's ``value`` (any picklable object) on every rank."""
    got = [value if group.rank == 0 else None]
    dist.broadcast_object_list(got, src=0)
    return got[0]


def _faults(group, device, part, seed: int, keep: bool, gates: dict, out: dict) -> dict:
    """Checks, faults and the recovery ladder under the group: every
    :func:`fault_cases` case x strategy x codec x barrier/split
    (:func:`_fault_mode`) on a ``[1,
    L]`` payload, held to the stacked guarded exchange that rank 0 runs
    under the same plan and to ``execute_numpy``; then ms per checked vs
    unchecked barrier exchange per strategy."""
    topo, r, L = group.topo, group.rank, part.rows_per_rank
    full = fault_payload(topo, L, seed)
    mine = torch.as_tensor(full[r : r + 1], device=device)
    stacked_in = torch.as_tensor(full, device=device) if r == 0 else None
    fields = ("op_index", "stage_kind", "round_index")
    for strat in STRATEGY_NAMES:
        for case, (codecs, kw) in fault_cases(strat, seed).items():
            for codec in codecs:
                for mode in MODES:
                    if not _fault_mode(device, strat, mode):
                        continue
                    key = f"{case}|{strat}|{mode}|{codec}"
                    ex = IrregularExchange(part.pattern, strat, device=device, wire=codec, group=group, **kw)
                    halo, rec = _guarded(ex, mine, mode)
                    out.setdefault("fault_records", {})[key] = rec
                    if keep and halo is not None:
                        out.setdefault("fault_halos", {})[key] = halo.cpu().view(torch.int32).numpy().tolist()
                    want = None
                    if r == 0:
                        st = IrregularExchange(part.pattern, strat, device=device, wire=codec, **kw)
                        st_halo, want = _guarded(st, stacked_in, mode)
                        plan_ = st.plan if mode == "barrier" else st._two_phase[0].plan
                        if case == "detect":
                            try:
                                execute_numpy(plan_, full, codec, faults=kw["faults"], fault_call=0, verify=True)
                                np_err = None
                            except ExchangeIntegrityError as e:
                                np_err = e.diagnostics()
                            gates[f"faults {key}: the stacked raise == execute_numpy's"] = (
                                want["error"] is not None and np_err is not None
                                and all(want["error"][f] == np_err[f] for f in fields))
                        else:
                            # the attempt that succeeded: the ladder's last
                            succ = (strat, codec) if want["recovery"] is None else tuple(
                                want["recovery"].split(":", 1)[1].split("/"))
                            try:
                                oracle = execute_numpy(planned(part.pattern, succ[0]), full, succ[1],
                                                       faults=kw.get("faults"), fault_call=want["calls"] - 1,
                                                       verify=True)
                            except ExchangeIntegrityError:
                                oracle = None
                            gates[f"faults {key}: stacked == execute_numpy of the attempt that succeeded "
                                  f"{succ}"] = oracle is not None and _same_bits(st_halo.cpu(), torch.as_tensor(oracle))
                    want = _from_rank0(want, group)
                    err = rec["error"]
                    if case == "detect":
                        gates[f"faults {key}: raised, hop == the stacked raise's"] = (
                            err is not None and all(err[f] == want["error"][f] for f in fields))
                    else:
                        gates[f"faults {key}: recovery {rec['recovery']} and events == stacked"] = (
                            err is None and (rec["recovery"], rec["events"]) == (want["recovery"], want["events"]))
                    gates[f"faults {key}: every rank the same recovery, events and error"] = _all_same(
                        (rec["recovery"], rec["events"], err), group)
                    if case == "clean":
                        plain = IrregularExchange(part.pattern, strat, device=device, wire=codec, group=group)
                        unchecked = plain(mine) if mode == "barrier" else plain.start(mine).finish()
                        gates[f"faults {key}: the checked halo == the unchecked"] = (
                            halo is not None and _same_bits(halo, unchecked))
                    if halo is not None:
                        halos = _gather0(halo, group)
                        if r == 0:
                            gates[f"faults {key}: halos == the stacked rows"] = all(
                                _same_bits(h[0], st_halo[q].cpu()) for q, h in enumerate(halos))
    # ms per checked and unchecked barrier exchange: the slowest rank's host wall
    ms = {}
    for strat in STRATEGY_NAMES:
        for checked in (False, True):
            ex = IrregularExchange(part.pattern, strat, device=device, verify=checked, group=group)
            ex(mine)
            _sync(device)
            _barrier()
            t0 = time.perf_counter()
            for _ in range(TIMED_REPS):
                ex(mine)
            _sync(device)
            ms[f"{strat}|{'verify' if checked else 'plain'}"] = _all_max(
                (time.perf_counter() - t0) / TIMED_REPS * 1e3, group)
    return ms


def _fault_solves(group, device, A, part, data: dict, seed: int, clean: tuple, keep: bool, gates: dict,
                  out: dict, launches: _Launches, predicted: dict) -> dict:
    """CG checked, and CG through a transient corruption the ladder retries:
    converged, the clean group run's history bitwise, one status on every
    rank, the true residual.  Returns each run's summary."""
    r, strat = group.rank, FAULT_SOLVE_STRATEGY
    b = torch.as_tensor(data["b"][r : r + 1], device=device)
    runs = {
        "verify": (dict(verify=True), "converged"),
        "retry": (dict(verify=True, faults=FaultPlan(seed=seed + 11, specs=(FaultSpec(kind="corrupt"),),
                                                     active_calls=(0,))),
                  f"converged+exchange:retry:{strat}/none"),
    }
    summary = {}
    for name, (kw, want) in runs.items():
        op = DistributedSpMV(part, strategy=strat, device=device, group=group, **kw)
        _sync(device)
        _barrier()
        t0 = time.perf_counter()
        with launches.counted():
            res = cg(op, b, tol=TOL_SOLVE, maxiter=MAXITER)
        _sync(device)
        wall = time.perf_counter() - t0
        predicted["spmv_ell"] += 2 * res.matvecs
        summary[f"cg|{name}"] = {
            "strategy": strat, "status": res.status, "iterations": res.iterations, "matvecs": res.matvecs,
            "final_residual": res.final_residual, "recoveries": op.health.recovery_count,
            "ms_per_iteration": _all_max(wall / max(res.iterations, 1) * 1e3, group),
        }
        gates[f"faults cg {name}: converged, status {res.status!r} == {want!r}"] = (
            res.converged and res.status == want)
        gates[f"faults cg {name}: history bitwise the clean group run's"] = res.residuals == clean
        gates[f"faults cg {name}: every rank holds the same history and status"] = _all_same(
            (res.residuals, res.status), group)
        if keep:
            out.setdefault("fault_solve_runs", {})[name] = {
                "x": res.x.cpu().numpy().tolist(), "residuals": list(res.residuals), "status": res.status,
                "iterations": res.iterations}
        xs = _gather_rows(res.x, group)
        if r == 0:
            x = torch.cat(xs).double().numpy().reshape(-1)
            bf = data["b"].astype(np.float64).reshape(-1)
            true = float(np.linalg.norm(bf - product64(A, x)) / np.linalg.norm(bf))
            summary[f"cg|{name}"]["true_residual"] = true
            gates[f"faults cg {name}: true residual {true:.3e} <= {TOL_TRUE}"] = true <= TOL_TRUE
    return summary


def _solved(device: torch.device, solver: str, strategy: str) -> bool:
    """Whether the host-loop solves run ``(solver, strategy)``: on the host
    every strategy and ``auto``; on CUDA ranks all of them for CG and
    :data:`CARD_BICGSTAB` for BiCGStab (the phase's time on the card)."""
    return device.type != "cuda" or solver == "cg" or strategy in CARD_BICGSTAB


def _fault_mode(device: torch.device, strategy: str, mode: str) -> bool:
    """Whether the faults section runs ``strategy`` in ``mode``: on the
    host both modes of every strategy; on CUDA ranks barrier for every
    strategy and the split phase on :data:`FAULT_SOLVE_STRATEGY` (the
    phase's time on the card; the host worlds of
    ``tests/test_torch_world.py`` hold every pair)."""
    return device.type != "cuda" or mode == "barrier" or strategy == FAULT_SOLVE_STRATEGY


def _overlapped(device: torch.device, solver: str, strategy: str) -> bool:
    """Whether the host-loop solves run ``(solver, strategy)`` split-phase
    too: on the host all of them; on CUDA ranks CG on
    :data:`FAULT_SOLVE_STRATEGY` alone (the phase's time on the card: the
    histories are bitwise equal across strategies and modes anyway)."""
    return device.type != "cuda" or (solver == "cg" and strategy == FAULT_SOLVE_STRATEGY)


def _fused_case(device: torch.device, solver: str, strategy: str, codec: str, mode: str) -> bool:
    """Whether the fused section runs ``(solver, strategy, codec, mode)``:
    barrier with every codec and the split phase (``"overlap"``) with
    ``none`` on the host; on CUDA ranks barrier with ``none`` for every
    strategy of CG and :data:`CARD_BICGSTAB` of BiCGStab, and for CG the
    split phase on :data:`FAULT_SOLVE_STRATEGY` and the int8 wire on
    :data:`FUSED_CARD_INT8` (the phase's time on the card)."""
    if device.type != "cuda":
        return mode == "barrier" or codec == "none"
    if not _solved(device, solver, strategy):
        return False
    if codec == "none":
        return mode == "barrier" or (solver == "cg" and strategy == FAULT_SOLVE_STRATEGY)
    return mode == "barrier" and solver == "cg" and strategy in FUSED_CARD_INT8


def _fused_cached(device: torch.device, solver: str, strategy: str, codec: str, mode: str) -> bool:
    """Whether a second, cached solve follows the first of a fused case:
    on the host always; on CUDA ranks for CG on :data:`FAULT_SOLVE_STRATEGY`,
    barrier, wire none (the phase's time on the card), the other cases
    timed by their first solve less its warm-up and capture."""
    return device.type != "cuda" or (solver, strategy, codec, mode) == ("cg", FAULT_SOLVE_STRATEGY, "none", "barrier")


def _timed_solve(fn, device: torch.device, group) -> tuple:
    """``(fn(), the slowest rank's host-wall seconds)`` of one collective solve."""
    _sync(device)
    _barrier()
    t0 = time.perf_counter()
    res = fn()
    _sync(device)
    return res, _all_max(time.perf_counter() - t0, group)


def _error_fields(solve) -> Optional[dict]:
    """The fields of the ``ExchangeIntegrityError`` that ``solve()`` raises
    (None if it raises none)."""
    try:
        solve()
    except ExchangeIntegrityError as e:
        return {**e.diagnostics(), "violation": e.violation}
    return None


def _fused_solves(group, device, systems_, parts, data: dict, seed: int, host_runs: dict, host_summary: dict,
                  keep: bool, gates: dict, out: dict, launches: _Launches, predicted: dict) -> dict:
    """The fused whole-solve over the group (``fused_cg`` / ``fused_bicgstab``
    on ``DistributedSpMV(group=)``): for every strategy, codec and mode
    (:func:`_fused_case`) a first solve (on CUDA it warms up and captures)
    and, where :func:`_fused_cached`, a second that replays, each held
    bitwise to the grouped host loop of the same operator (history, ``x``,
    status, iterations, matvecs) and, on rank 0, the gathered ``x`` and the
    history to the stacked host loop in the group tree's summation order
    (``reductions=NumpyReductions``); converged, with a true residual under
    :data:`TOL_TRUE` (codec none); B1 launched by graph replays only, two
    per matvec of each replayed program, and one host read per block.  Then
    :func:`_fused_checks`.  Returns the summary: ms per iteration fused vs
    host loop, capture seconds, host reads, B1 counts."""
    from repro_torch.solve import fused as F

    r, topo = group.rank, group.topo
    cuda = device.type == "cuda"
    summary = {}
    for solver, host_fn, fused_fn, M, part, rhs in (
            ("cg", cg, fused_cg, systems_[0], parts[0], "b"),
            ("bicgstab", bicgstab, fused_bicgstab, systems_[1], parts[1], "b2")):
        b = torch.as_tensor(data[rhs][r : r + 1], device=device)
        full = torch.as_tensor(data[rhs], device=device) if r == 0 else None
        per_iter = 1 if solver == "cg" else 2  # matvecs per iteration
        warm_up = 2 * (1 + per_iter) if cuda else 0  # B1 of the warm-up's init and one iteration, eagerly
        for codec in FUSED_CODECS:
            stacked = None
            for strat, mode in ((s, m) for s in STRATEGY_NAMES for m in ("barrier", "overlap")):
                if not _fused_case(device, solver, strat, codec, mode):
                    continue
                key = f"{solver}|{strat}|{codec}|{mode}"
                overlap = mode == "overlap"
                op = DistributedSpMV(part, strategy=strat, device=device, group=group, wire=codec, overlap=overlap)
                if codec == "none":
                    host = host_runs[(solver, strat, overlap)]
                    host_ms = host_summary[f"{solver}|{strat}|{mode}"]["ms_per_iteration"]
                else:
                    with launches.counted():
                        host, host_s = _timed_solve(lambda: host_fn(op, b, tol=TOL_SOLVE, maxiter=MAXITER),
                                                    device, group)
                    predicted["spmv_ell"] += 2 * host.matvecs
                    host_ms = host_s / max(host.iterations, 1) * 1e3
                runs = {}
                for name in ("first", "cached") if _fused_cached(device, solver, strat, codec, mode) else ("first",):
                    eager0, graph0, progs0 = spmv_ell.launches, F.graph_launches["spmv_ell"], dict(F.program_runs)
                    with launches.counted():
                        res, wall = _timed_solve(lambda: fused_fn(op, b, tol=TOL_SOLVE, maxiter=MAXITER), device,
                                                 group)
                    ran = {k: F.program_runs[k] - progs0[k] for k in progs0}
                    first = name == "first"
                    runs[name] = dict(res=res, wall=wall, reads=F.host_reads, ran=ran,
                                      eager=spmv_ell.launches - eager0 - (warm_up if first else 0),
                                      replayed=F.graph_launches["spmv_ell"] - graph0,
                                      capture_s=_all_max(F.last_capture_s, group) if cuda and first else 0.0)
                    predicted["spmv_ell"] += warm_up if first else 0
                f = runs["first"]
                c = runs.get("cached", f)  # the solve timed: the replays alone where there is one
                res = c["res"]
                want_b1 = 2 * (c["ran"]["init"] + c["ran"]["block"] * F.U * per_iter)
                bound = math.ceil(res.iterations / F.U) + F.HOST_READ_SLACK
                gates[f"fused {key}: converged"] = res.converged
                gates[f"fused {key}: history, x, status, iterations, matvecs bitwise the grouped host loop"] = (
                    res.residuals == host.residuals and _same_bits(res.x, host.x)
                    and (res.status, res.iterations, res.matvecs) == (host.status, host.iterations, host.matvecs))
                if c is not f:
                    gates[f"fused {key}: the cached solve == the first, bitwise"] = (
                        res.residuals == f["res"].residuals and _same_bits(res.x, f["res"].x))
                gates[f"fused {key}: every rank holds the same history and status"] = _all_same(
                    (res.residuals, res.status), group)
                gates[f"fused {key}: host reads {c['reads']} <= blocks + slack {bound}"] = c["reads"] <= bound
                if cuda:
                    gates[f"fused {key}: B1 only by replays, {c['replayed']} == 2 x matvecs of the replayed "
                          f"programs {want_b1}, none eager beyond the warm-up's {warm_up}"] = (
                        c["replayed"] == want_b1 and c["eager"] == 0)
                else:  # the eager body on the host: no graph
                    gates[f"fused {key}: no graph on the host"] = f["replayed"] == c["replayed"] == 0
                row = {"strategy": strat, "codec": codec, "mode": mode, "status": res.status,
                       "iterations": res.iterations, "matvecs": res.matvecs,
                       "ms_per_iteration": (c["wall"] - c["capture_s"]) / max(res.iterations, 1) * 1e3,
                       "timed": "cached solve" if c is not f else "first solve less its warm-up and capture",
                       "host_ms_per_iteration": host_ms, "first_solve_s": f["wall"], "solve_s": c["wall"],
                       "capture_s": f["capture_s"] if cuda else None,
                       "host_reads": c["reads"], "program_runs": c["ran"], "b1_replayed": c["replayed"],
                       "b1_eager": c["eager"], "b1_warm_up": warm_up}
                summary[key] = row
                if keep:
                    out.setdefault("fused_runs", {})[key] = {
                        "x": res.x.cpu().numpy().tolist(), "residuals": list(res.residuals), "status": res.status,
                        "iterations": res.iterations, "host_residuals": list(host.residuals),
                        "host_x": host.x.cpu().numpy().tolist()}
                xs = _gather_rows(res.x, group)
                if r == 0:
                    x = torch.stack(xs).to(device)
                    if stacked is None or codec != "none":  # every strategy and mode of codec none alike
                        st_op = DistributedSpMV(part, strategy=strat, device=device, wire=codec)
                        stacked = host_fn(st_op, full, tol=TOL_SOLVE, maxiter=MAXITER,
                                          reductions=NumpyReductions(topo))
                    gates[f"fused {key}: history and x bitwise the stacked host loop in the tree's order"] = (
                        stacked.residuals == res.residuals and _same_bits(stacked.x, x))
                    if codec == "none":
                        x64 = x.double().cpu().numpy().reshape(-1)
                        bf = data[rhs].astype(np.float64).reshape(-1)
                        row["true_residual"] = float(np.linalg.norm(bf - product64(M, x64)) / np.linalg.norm(bf))
                        gates[f"fused {key}: true residual {row['true_residual']:.3e} <= {TOL_TRUE}"] = (
                            row["true_residual"] <= TOL_TRUE)
    summary["checks"] = _fused_checks(group, device, parts[0], data, seed, host_runs, keep, gates, out)
    return summary


def _fused_checks(group, device, part, data: dict, seed: int, host_runs: dict, keep: bool, gates: dict,
                  out: dict) -> dict:
    """The fused CG's checks over the group (:data:`FAULT_SOLVE_STRATEGY`):
    ``verify=True`` clean; a persistent perturbation
    (:data:`FUSED_DETECT_MAXITER` iterations) that every rank raises with
    one hop and one violation, the stacked fused raise's; a transient one
    at matvec call 7 under ``checkpoint_every=5``, which the ladder resumes
    from the checkpoint on a re-advised strategy: the stacked fused
    solve's status and the clean history on every rank.  The stacked
    solves sum their dots in their own order: the hop, the violation and
    the rung do not depend on it."""
    r, strat = group.rank, FAULT_SOLVE_STRATEGY
    b = torch.as_tensor(data["b"][r : r + 1], device=device)
    full = torch.as_tensor(data["b"], device=device) if r == 0 else None
    clean = host_runs[("cg", strat, False)]
    persistent = FaultPlan(seed=seed + 15, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),))
    transient = FaultPlan(seed=seed + 16, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0, strategies=(strat,)),),
                          active_calls=(7,))
    res = {}
    checked, wall = _timed_solve(lambda: fused_cg(DistributedSpMV(part, strategy=strat, device=device, group=group,
                                                                  verify=True), b, tol=TOL_SOLVE, maxiter=MAXITER),
                                 device, group)
    res["verify"] = {"status": checked.status, "iterations": checked.iterations,
                     "ms_per_iteration": wall / max(checked.iterations, 1) * 1e3}
    gates["fused checks verify: converged, the clean host loop's history and x, bitwise"] = (
        checked.converged and checked.residuals == clean.residuals and _same_bits(checked.x, clean.x))
    err = _error_fields(lambda: fused_cg(DistributedSpMV(part, strategy=strat, device=device, group=group,
                                                         verify=True, faults=persistent), b, tol=TOL_SOLVE,
                                         maxiter=FUSED_DETECT_MAXITER))
    want = None
    if r == 0:
        want = _error_fields(lambda: fused_cg(DistributedSpMV(part, strategy=strat, device=device, verify=True,
                                                              faults=persistent), full, tol=TOL_SOLVE,
                                              maxiter=FUSED_DETECT_MAXITER))
    want = _from_rank0(want, group)
    res["detect"] = {"error": err, "stacked_error": want}
    gates["fused checks detect: every rank raises the stacked fused raise (hop and violation)"] = (
        err is not None and err == want)
    gates["fused checks detect: every rank the same error"] = _all_same(err, group)
    resumed = fused_cg(DistributedSpMV(part, strategy=strat, device=device, group=group, verify=True,
                                       faults=transient), b, tol=TOL_SOLVE, maxiter=MAXITER, checkpoint_every=5)
    stacked_status = None
    if r == 0:
        stacked_status = fused_cg(DistributedSpMV(part, strategy=strat, device=device, verify=True, faults=transient),
                                  full, tol=TOL_SOLVE, maxiter=MAXITER, checkpoint_every=5).status
    stacked_status = _from_rank0(stacked_status, group)
    res["resume"] = {"status": resumed.status, "iterations": resumed.iterations, "stacked_status": stacked_status}
    gates[f"fused checks resume: {resumed.status!r} == stacked {stacked_status!r}, resumed once, the clean history"] = (
        resumed.converged and "+resume:1" in resumed.status and resumed.status == stacked_status
        and resumed.residuals == clean.residuals)
    gates["fused checks resume: every rank the same status and history"] = _all_same(
        (resumed.status, resumed.residuals), group)
    if keep:
        out["fused_checks"] = {"verify": {"residuals": list(checked.residuals), "x": checked.x.cpu().numpy().tolist()},
                               "detect": err, "resume": {"status": resumed.status,
                                                         "residuals": list(resumed.residuals)}}
    return res


def _flat_dot(red: GroupReductions, x: torch.Tensor, y: torch.Tensor) -> float:
    """The tree's baseline: every rank's float64 partial all-gathered over
    the whole world and summed rank -> pod -> world on every rank."""
    parts = [torch.empty(1, dtype=torch.float64) for _ in range(red.topo.nranks)]
    dist.all_gather(parts, torch.tensor([red.partial(x, y)], dtype=torch.float64))
    return _tree_sum(torch.cat(parts).numpy(), red.topo)


def _reductions(group, device, part, data: dict, keep: bool, gates: dict, out: dict, launches: _Launches,
                predicted: dict) -> dict:
    """The reduction tree over the group, plain and int8-compressed, held to
    the gathered partials and to the stacked ``TorchReductions``; a CG on
    the compressed tree; ms per dot, tree vs the flat all-gather."""
    topo, r = group.topo, group.rank
    tree, comp = GroupReductions(topo, group), GroupReductions(topo, group, Compressor())
    values = {}
    for a, c in (("b", "b"), ("v", "b"), ("b", "b2")):
        name = f"{a}.{c}"
        x = torch.as_tensor(data[a][r : r + 1], device=device)
        y = x if a == c else torch.as_tensor(data[c][r : r + 1], device=device)
        plain, compressed, flat = tree.dot(x, y), comp.dot(x, y), _flat_dot(tree, x, y)
        partial = tree.partial(x, y)
        values[name] = {"tree": plain, "compressed": compressed, "partial": partial}
        gates[f"reductions {name}: every rank holds the same tree and compressed bits"] = _all_same(
            (plain.hex(), compressed.hex()), group)
        gates[f"reductions {name}: the tree == the flat all-gather, bitwise"] = plain.hex() == flat.hex()
        parts = _gather0(torch.tensor([partial], dtype=torch.float64), group)
        if r == 0:
            p = torch.cat(parts).numpy()
            gates[f"reductions {name}: the tree == _tree_sum of the gathered partials, bitwise"] = (
                plain.hex() == _tree_sum(p, topo).hex())
            pods = p.reshape(topo.npods, topo.ppn).sum(axis=1)
            quantum = float(int8_scale(torch.tensor(np.abs(pods[np.isfinite(pods)]).max(initial=0.0)),
                                       Compressor().qmax))
            stacked = TorchReductions(topo, Compressor()).dot(torch.as_tensor(data[a], device=device),
                                                               torch.as_tensor(data[c], device=device))
            values[name].update(stacked=stacked, quantum=quantum)
            gates[f"reductions {name}: |compressed - stacked| {abs(compressed - stacked):.3e} <= one "
                  f"quantum {quantum:.3e}"] = abs(compressed - stacked) <= quantum
    summary = {"values": values}
    # CG on the compressed tree: one history on every rank, the stacked status
    strat = FAULT_SOLVE_STRATEGY
    b = torch.as_tensor(data["b"][r : r + 1], device=device)
    op = DistributedSpMV(part, strategy=strat, device=device, group=group)
    _sync(device)
    _barrier()
    t0 = time.perf_counter()
    with launches.counted():
        res = cg(op, b, tol=TOL_COMPRESSED, maxiter=MAXITER_COMPRESSED, reductions=comp)
    _sync(device)
    wall = time.perf_counter() - t0
    predicted["spmv_ell"] += 2 * res.matvecs
    summary["cg|compressed"] = {"strategy": strat, "status": res.status, "iterations": res.iterations,
                                "final_residual": res.final_residual,
                                "ms_per_iteration": _all_max(wall / max(res.iterations, 1) * 1e3, group)}
    gates["reductions cg compressed: every rank holds the same history and status"] = _all_same(
        (res.residuals, res.status), group)
    if keep:
        out["compressed_cg"] = {"residuals": list(res.residuals), "status": res.status,
                                "iterations": res.iterations, "x": res.x.cpu().numpy().tolist()}
    if r == 0:
        st = cg(DistributedSpMV(part, strategy=strat, device=device), torch.as_tensor(data["b"], device=device),
                tol=TOL_COMPRESSED, maxiter=MAXITER_COMPRESSED, reductions=TorchReductions(topo, Compressor()))
        summary["cg|compressed|stacked"] = {"status": st.status, "iterations": st.iterations}
        gates[f"reductions cg compressed: status {res.status} == stacked {st.status}"] = res.status == st.status
    # ms per dot: the slowest rank's host wall
    x = torch.as_tensor(data["b"][r : r + 1], device=device)
    ms = {}
    for name, dot in (("tree", tree.dot), ("compressed", comp.dot), ("flat", lambda u, w: _flat_dot(tree, u, w))):
        dot(x, x)
        _barrier()
        t0 = time.perf_counter()
        for _ in range(DOT_REPS):
            dot(x, x)
        ms[name] = _all_max((time.perf_counter() - t0) / DOT_REPS * 1e3, group)
    summary["dot_ms"] = ms
    return summary


def _fake_mesh(topo: PodTopology, device: torch.device):
    """A ``("pod", "local")`` ``DeviceMesh`` of this world whose dimension
    groups run over the dry-run's fake backend, which moves no data."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.comm.topology import WORLD_AXES

    local, _ = dist.new_subgroups_by_enumeration(
        [[topo.rank_of(p, l) for l in range(topo.ppn)] for p in range(topo.npods)], backend="fake")
    pod, _ = dist.new_subgroups_by_enumeration(
        [[topo.rank_of(p, l) for p in range(topo.npods)] for l in range(topo.ppn)], backend="fake")
    layout = torch.arange(topo.nranks).reshape(topo.npods, topo.ppn)
    return DeviceMesh.from_group([pod, local], device.type, mesh=layout, mesh_dim_names=WORLD_AXES)


def _guards(group, device, part) -> dict:
    """Each refusal under a group raises with its ROADMAP item, the ranks
    at fault or the backend it cannot serve; returns ``{guard: message}``."""
    cases = {
        "nccl": lambda: make_exchange_group(group.topo, backend="nccl"),
        # a mesh of groups that move no data: refused before any collective
        "mesh_backend": lambda: exchange_group_of_mesh(_fake_mesh(group.topo, device)),
        # rank 1 plans another strategy: every rank raises at construction
        "mismatch": lambda: IrregularExchange(part.pattern, "two_step" if group.rank == 1 else "standard",
                                              device=device, group=group),
        # rank 1 holds another fault plan: every rank raises at construction
        "fault_mismatch": lambda: IrregularExchange(
            part.pattern, "standard", device=device, group=group, verify=True,
            faults=FaultPlan(seed=1 if group.rank == 1 else 0, specs=(FaultSpec(),))),
    }
    got = {}
    for name, make in cases.items():
        try:
            make()
        except (NotImplementedError, RuntimeError, ValueError) as e:
            got[name] = f"{type(e).__name__}: {e}"
        else:
            got[name] = "did not raise"
    return got


def moe_shapes(device: torch.device, nranks: int) -> tuple:
    """``(MoEConfig, d_model, act, batch, seq)`` of the MoE section: on a
    CUDA device the config's layer with one expert per rank and ``nranks x
    1024`` tokens; on the host d_model 32, experts 64 wide, ``nranks x 32``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    if device.type == "cuda":
        return cfg.moe, cfg.d_model, cfg.act, nranks, 1024
    return dataclasses.replace(cfg.moe, n_experts=nranks, d_ff_expert=64), 32, cfg.act, nranks, 32


def moe_params(layer, seed: int, experts: Sequence[int], device: torch.device) -> dict:
    """The section's bf16 weights: the router and the shared expert drawn
    whole from ``seed``, and only the routed ``experts`` (each from a seed of
    its own, at the whole tensor's scale), so a rank draws its own 1/n."""
    from repro_torch.models.sharding import init_params

    specs = layer.params()
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    p = {"router": specs["router"].initialize(gen(seed), torch.bfloat16, device)}
    if "shared" in specs:
        p["shared"] = init_params(specs["shared"], gen(seed + 1), torch.bfloat16, device)
    for j, key in enumerate(("w_in", "w_gate", "w_out")):
        spec = specs[key]
        p[key] = torch.cat([
            torch.randn((1, *spec.shape[1:]), generator=gen(seed + 2 + 3 * e + j), device=device)
            .mul_(spec.std()).bfloat16() for e in experts])
    return p


def moe_inputs(shape: tuple, seed: int, device: torch.device) -> dict:
    """The uniform and skewed ``[B, S, M]`` bf16 inputs (the reference
    benchmark's: a constant bias skews the router's top-k)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bias = torch.randn(shape[-1:], generator=gen, device=device)
    return {"uniform": torch.randn(shape, generator=gen, device=device).bfloat16(),
            "skewed": (torch.randn(shape, generator=gen, device=device) * 0.3 + bias).bfloat16()}


def _timed(fn, device, reps: int, group) -> float:
    """The slowest rank's host-wall ms per call of ``fn`` over ``reps``."""
    _sync(device)
    _barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return _all_max((time.perf_counter() - t0) / reps * 1e3, group)


def _moe(group, device, seed: int, gates: dict) -> dict:
    """The MoE section (see the module docstring); returns its values."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.comm import WORLD_AXES, cache_stats, clear_caches
    from repro_torch.models.moe import MoELayer
    from repro_torch.models.sharding import from_whole, tree_map

    topo, r, n = group.topo, group.rank, group.topo.nranks
    cfg, M, act, B, S = moe_shapes(device, n)
    mesh = init_device_mesh(device.type, (topo.npods, topo.ppn), mesh_dim_names=WORLD_AXES)
    shard, whole = (Shard(0), Shard(0)), (Replicate(), Replicate())
    base = MoELayer(M, cfg, act)
    e_local = cfg.n_experts // n
    mine = moe_params(base, seed + 40, range(r * e_local, (r + 1) * e_local), device)
    specs = base.params()
    dp = {k: DTensor.from_local(v, mesh, shard, run_check=False, shape=torch.Size(specs[k].shape),
                                stride=torch.empty(specs[k].shape, device="meta").stride())
          if k.startswith("w_") else tree_map(lambda t: from_whole(t, mesh, whole), v) if isinstance(v, dict)
          else from_whole(v, mesh, whole) for k, v in mine.items()}
    del mine
    inputs = moe_inputs((B, S, M), seed + 41, device)
    xs = {k: from_whole(v, mesh, shard) for k, v in inputs.items()}
    if r:  # the whole batch stays on rank 0 alone, for the stacked run
        inputs = dict.fromkeys(inputs)
    res = {"d_model": M, "experts": cfg.n_experts, "d_ff_expert": cfg.d_ff_expert,
           "top_k": cfg.top_k, "shared": cfg.n_shared, "batch": [B, S], "ms": {}, "tally": {}}
    outs = {}
    with torch.no_grad():
        for name, x in xs.items():
            a2a = MoELayer(M, cfg, act, ep_axis=WORLD_AXES)
            y0 = a2a(dp, x, mesh=mesh).to_local()
            res["ms"][f"{name}|all_to_all"] = _timed(lambda: a2a(dp, x, mesh=mesh), device, MOE_TIMED, group)
            first = None
            for strategy in MOE_STRATEGIES:
                layer = MoELayer(M, cfg, act, dispatch="exchange", strategy=strategy)
                y = layer(dp, x, mesh=mesh).to_local()
                res["tally"][f"{name}|{strategy}"] = layer.tally.read()
                if strategy == "auto":
                    res[f"{name}|auto_picked"] = next(iter(layer.dispatcher._strategies.values()))
                gates[f"moe {name} {strategy}: bitwise the mesh all_to_all"] = torch.equal(y, y0)
                first = y if first is None else first
                gates[f"moe {name} {strategy}: bitwise across strategies"] = torch.equal(y, first)
                res["ms"][f"{name}|{strategy}"] = _timed(lambda: layer(dp, x, mesh=mesh), device, MOE_TIMED,
                                                         group)
            gates[f"moe {name}: finite"] = bool(torch.isfinite(first).all())
            outs[name] = first
            del y0

        # the stacked exchange on rank 0, against the gathered rows
        rows = {name: _gather0(y, group) for name, y in outs.items()}
        stacked_tally, compare = {}, {}
        if r == 0:
            params = moe_params(base, seed + 40, range(cfg.n_experts), device)
            for name, x in inputs.items():
                layer = MoELayer(M, cfg, act, dispatch="exchange", strategy="standard")
                want = layer(params, x, topo)
                stacked_tally[name] = layer.tally.read()
                got = torch.cat(rows[name]).to(device)
                compare[name] = {"max_abs_err": float((got.float() - want.float()).abs().max()),
                                 "max_abs": float(want.float().abs().max())}
                gates[f"moe {name}: bitwise the stacked exchange"] = torch.equal(got, want)
                if name == "uniform":
                    res["ms"]["uniform|stacked"] = _timed_one(lambda: layer(params, x, topo), device, MOE_TIMED)
                    # the int8 wire (it rounds the bf16 payload on the
                    # inter-pod hops), stacked
                    wired_want = MoELayer(M, cfg, act, dispatch="exchange", strategy="two_step",
                                          wire="int8")(params, x, topo)
            del params, want, got
        res["stacked"] = compare
        _barrier()
        # the tallies: summed over the ranks, the stacked run's
        for name in inputs:
            for strategy in MOE_STRATEGIES:
                t = res["tally"][f"{name}|{strategy}"]
                got = torch.tensor([t["routed"], t["dropped"], t["shipped"]], dtype=torch.int64)
                dist.all_reduce(got)
                if r == 0:
                    want = stacked_tally[name]
                    gates[f"moe {name} {strategy}: slots routed, dropped, shipped the stacked run's"] = (
                        got.tolist() == [want["routed"], want["dropped"], want["shipped"]])
                    res["tally"][f"{name}|{strategy}|summed"] = got.tolist()
        res["tally"]["stacked"] = stacked_tally

        # the int8 wire: bitwise the stacked int8 run, and not the full
        # precision output (the codec acted); then planning on the first
        # call only
        x = xs["uniform"]
        wired = MoELayer(M, cfg, act, dispatch="exchange", strategy="two_step", wire="int8")(dp, x, mesh=mesh)
        wired = _gather0(wired.to_local(), group)
        if r == 0:
            got = torch.cat(wired).to(device)
            full = torch.cat(rows["uniform"]).to(device)
            res["int8_max_abs_err"] = float((got.float() - full.float()).abs().max())
            gates["moe int8 wire: bitwise the stacked int8 run"] = torch.equal(got, wired_want)
            gates["moe int8 wire: not the full-precision output"] = not torch.equal(got, full)
            del got, full, wired_want
        clear_caches()
        layer = MoELayer(M, cfg, act, dispatch="exchange", strategy="standard")
        for i in range(MOE_REPS):
            layer(dp, x, mesh=mesh)
            if i == 0:
                one = cache_stats()
        last = cache_stats()
        res["cache"] = {k: [getattr(one, k), getattr(last, k)] for k in ("plan_misses", "exchange_misses",
                                                                         "exchange_hits")}
        gates["moe cache: planning on the first call only"] = (
            one.plan_misses == last.plan_misses and one.exchange_misses == last.exchange_misses
            and last.exchange_hits - one.exchange_hits == 2 * (MOE_REPS - 1))

        # the count all-gather alone: one [n] int64 row per rank
        row = torch.zeros(n, dtype=torch.int64)
        got = [torch.empty_like(row) for _ in range(n)]
        res["ms"]["count_all_gather"] = _timed(lambda: dist.all_gather(got, row), torch.device("cpu"), 50, group)
    if device.type == "cuda":
        res["device_peak_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
    return res


def _timed_one(fn, device, reps: int) -> float:
    """ms per call of ``fn`` on this rank alone (host wall)."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def case_study(group, device: torch.device, *, problem: str, seed: int = 0, mm_cols: int = 8,
               keep: bool = False) -> dict:
    """The paper's case study on this rank (see the module docstring) over
    the systems :func:`write_problem` wrote to ``problem``; returns its
    gates, times, launch counts and memory."""
    started = time.time()
    topo, r = group.topo, group.rank
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    sizes, A, B, part, part_b = load_problem(problem, r)
    if part.topo != topo:
        raise ValueError(f"the problem in {problem} is partitioned over {part.topo}, the world is {topo}")
    data = inputs(topo, part.rows_per_rank, seed, mm_cols)
    setup_s = time.perf_counter() - t0
    setup_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    gates, out = {}, {}
    launches, predicted = _Launches(), {"spmv_ell": 0, "spmm_ell": 0}
    histories = {}
    t1 = time.perf_counter()
    exchange_ms = _exchanges(group, device, part, seed, keep, gates, out)
    t2 = time.perf_counter()
    _spmv(group, device, A, part, data, keep, gates, out, launches, predicted)
    t3 = time.perf_counter()
    host_runs = {}
    solves = _solves(group, device, (A, B), (part, part_b), data, keep, gates, out, launches, predicted,
                     histories, host_runs)
    t4 = time.perf_counter()
    fused = _fused_solves(group, device, (A, B), (part, part_b), data, seed, host_runs, solves, keep, gates,
                          out, launches, predicted)
    t4f = time.perf_counter()
    fault_ms = _faults(group, device, part, seed, keep, gates, out)
    fault_solves = _fault_solves(group, device, A, part, data, seed, histories["cg"], keep, gates, out,
                                 launches, predicted)
    t5 = time.perf_counter()
    reductions = _reductions(group, device, part, data, keep, gates, out, launches, predicted)
    t6 = time.perf_counter()
    guards = _guards(group, device, part)
    sizes.update(rows_per_rank=part.rows_per_rank, halo_width=part.halo_width)
    del A, B, part, part_b, data  # the MoE section's memory
    moe_out = _moe(group, device, seed, gates)
    t7 = time.perf_counter()
    # on the host the wrappers run the plain versions and launch nothing
    want = predicted if device.type == "cuda" else {"spmv_ell": 0, "spmm_ell": 0}
    gates[f"launches {launches.n} == predicted {want}"] = launches.n == want
    expect = {"nccl": "A.6.3b item 5", "mesh_backend": "unknown backend 'fake'", "mismatch": "ranks [1]",
              "fault_mismatch": "ranks [1]"}
    for name, text in expect.items():
        gates[f"guard {name} raises naming {text!r}"] = text in guards[name]
    memory = {"host_max_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
              "host_max_rss_after_setup_bytes": setup_rss, **_host_memory()}
    if device.type == "cuda":
        memory.update(device_peak_allocated_bytes=torch.cuda.max_memory_allocated(device),
                      device_reserved_bytes=torch.cuda.memory_reserved(device))
    return {
        "rank": r, "device": str(device), "started_at": started, "setup_s": setup_s,
        "phase_s": {"exchange": t2 - t1, "spmv": t3 - t2, "solve": t4 - t3, "fused": t4f - t4,
                    "faults": t5 - t4f, "reductions": t6 - t5, "moe": t7 - t6},
        **sizes,
        "gates": gates, "exchange_ms": exchange_ms, "solves": solves, "fault_ms": fault_ms,
        "fault_solves": fault_solves, "fused": fused, "reductions": reductions, "launches": launches.n,
        "predicted_launches": predicted, "guards": guards, "memory": memory, "moe": moe_out, **out,
    }


def _host_memory() -> dict:
    """This process's proportional and private resident bytes now (Linux's
    ``smaps_rollup``; the max RSS above also counts the shared library
    pages every rank maps)."""
    try:
        with open("/proc/self/smaps_rollup") as f:
            fields = dict(line.split(":", 1) for line in f if ":" in line)
    except OSError:
        return {}
    def nbytes(key: str) -> int:
        return int(fields[key].split()[0]) * 1024 if key in fields else 0

    return {"host_pss_bytes": nbytes("Pss"),
            "host_private_bytes": nbytes("Private_Clean") + nbytes("Private_Dirty")}


def parse_topo(text: str) -> PodTopology:
    npods, ppn = (int(x) for x in text.lower().split("x"))
    return PodTopology(npods=npods, ppn=ppn)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--topo", default="4x4", help="NPODSxPPN (default 4x4: 16 processes)")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--matrix", default="thermal_like")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mm-cols", type=int, default=8)
    ap.add_argument("--device", default=None, help="'cpu' runs on the host; left out, the CUDA device")
    ap.add_argument("--timeout", type=float, default=540.0, help="seconds for the whole world")
    ap.add_argument("--keep-arrays", action="store_true", help="write each rank's halos, w and x too")
    ap.add_argument("--problem", default=None,
                    help="a directory write_problem filled with build_problem's systems of --matrix, --rows and "
                         "--seed over --topo (left out: built here)")
    ap.add_argument("--out", required=True, help="directory for world.json")
    args = ap.parse_args(argv)
    topo = parse_topo(args.topo)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the host")
        kbuild.build(["spmv_ell"])  # once here, not in every rank
    start_rank_server()  # it imports while the problem is built
    with tempfile.TemporaryDirectory(prefix="repro_problem_") as built:
        t_build = time.time()
        problem = args.problem
        if problem is None:
            problem = built
            write_problem(problem, *build_problem(topo, args.matrix, args.rows, args.seed))
        t0 = time.time()
        ranks = run_world(case_study, topo, device=args.device, timeout_s=args.timeout, kwargs=dict(
            problem=problem, seed=args.seed, mm_cols=args.mm_cols, keep=args.keep_arrays))
        total = time.time() - t0
    failed = [f"rank {x['rank']}: {k}" for x in ranks for k, ok in x["gates"].items() if not ok]
    # the world's start, by step: the slowest rank's seconds since the spawn
    start = {k: max(x["timeline"][k] for x in ranks) - t0 for k in ranks[0]["timeline"]}
    record = {"topo": args.topo, "rows": args.rows, "matrix": args.matrix, "device": args.device or "cuda",
              "build_s": t0 - t_build, "start_s": max(x["started_at"] for x in ranks) - t0, "start_steps_s": start,
              "total_s": total,
              "failed_gates": failed, "ranks": ranks}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "world.json"), "w") as f:
        json.dump(record, f)
    r0 = ranks[0]
    print(f"world {args.topo}: {len(ranks)} processes, n={r0['n']} L={r0['rows_per_rank']} "
          f"H={r0['halo_width']}, build {record['build_s']:.2f} s, start {record['start_s']:.2f} s "
          f"({', '.join(f'{k} {v:.2f}' for k, v in start.items())}), total {total:.2f} s; "
          f"{sum(len(x['gates']) for x in ranks)} gates, {len(failed)} failed", flush=True)
    for line in failed:
        print("FAILED", line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
