"""Traffic kind ``solve_stream``: one closed-loop caller runs whole solves
back to back.

Each solve is the program's fused solver (``repro_torch.solve.
FUSED_SOLVERS[traffic["solver"]]``) on ``DistributedSpMV(partition_csr(A,
topo), strategy=traffic["strategy"])`` from ``x0 = 0``, with a fresh
``[nranks, L]`` N(0, 1) right-hand side drawn on the device from the seed.
A sample of the window's solves, drawn from the seed, and its slowest
solve are judged against the reference's float64 CG on the same CSR.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import common
from portbench.inputs import device_seed, host_rng
from portbench.reference import DeviceCSR, cg, csr_matmul

#: solves run before the window: the first warms up and captures
WARMUP_SOLVES = 2
#: solves in the profiled stretch
PROFILED_SOLVES = 20
#: solves of the window judged against the reference, besides the slowest
SAMPLE = 8
#: the reference solves on until this relative residual for its ``x``
REFERENCE_RUN_TO = 1e-12


class Driver:
    def __init__(self, A, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.comm import PodTopology
        from repro_torch.solve import FUSED_SOLVERS
        from repro_torch.sparse import DistributedSpMV, partition_csr

        if traffic["solver"] != "cg":
            raise ValueError(f"the reference judges CG solves only, not {traffic['solver']!r}")
        self.A, self.device = A, device
        self.tol, self.maxiter = float(traffic["tol"]), int(traffic["maxiter"])
        self.topo = PodTopology(npods=int(cfg["npods"]), ppn=int(cfg["ppn"]))
        part = partition_csr(common.program_csr(A), self.topo)
        self.op = DistributedSpMV(part, strategy=traffic["strategy"], device=device)
        self.solve_fn = FUSED_SOLVERS[traffic["solver"]]
        self.shape = (self.topo.nranks, part.rows_per_rank)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(device_seed(seed, 1))
        self.sampler = common.Reservoir(SAMPLE, host_rng(seed, 2))
        self.slowest = None
        self.statuses: Dict[str, int] = {}
        for _ in range(WARMUP_SOLVES):
            self._solve()
        common.sync(device)
        self.notes = {"strategy": self.op.strategy, "rows_per_rank": self.shape[1],
                      "halo_width": part.halo_width}

    def _solve(self):
        b = torch.randn(self.shape, generator=self.gen, device=self.device)
        return b, self.solve_fn(self.op, b, tol=self.tol, maxiter=self.maxiter)

    def profiled_stretch(self) -> dict:
        for _ in range(PROFILED_SOLVES):
            self._solve()
        common.sync(self.device)
        return {"solves": PROFILED_SOLVES, "units": PROFILED_SOLVES}

    def window(self, seconds: float) -> dict:
        from repro_torch.comm import cache_stats
        from repro_torch.solve import fused as F

        before = cache_stats()
        solves = iterations = 0
        reads, walls = [], []
        t0 = now = time.perf_counter()
        deadline = t0 + seconds
        while True:
            last = now
            b, res = self._solve()
            now = time.perf_counter()
            walls.append(now - last)
            solves += 1
            iterations += res.iterations
            reads.append(F.host_reads)
            self.statuses[res.status] = self.statuses.get(res.status, 0) + 1
            item = (b, res.x, res.iterations, res.converged)
            self.sampler.offer(lambda: item)
            if self.slowest is None or res.iterations > self.slowest[2]:
                self.slowest = item
            if now >= deadline:
                break
        after = cache_stats()
        self.notes.update(statuses=self.statuses, host_reads_per_solve=[min(reads), max(reads)],
                          cache_misses_in_window=common.misses(before, after),
                          solve_ms_p10_p50_p90_max=[float(np.percentile(walls, q)) * 1e3 for q in (10, 50, 90, 100)])
        return {"elapsed_s": now - t0, "solves": solves, "iterations": iterations,
                "attempted": solves, "failed": solves - self.statuses.get("converged", 0)}

    def release(self) -> list:
        """Free the program's state; returns the judged solves."""
        from repro_torch.comm import clear_caches

        items = self.sampler.items + ([self.slowest] if self.slowest is not None else [])
        self.op = None
        clear_caches()
        return items

    def check(self, items: list, limits: dict) -> Dict[str, tuple]:
        numbers = judge(self.A, items, self.tol, self.maxiter, self.device)
        self.notes["not_compared"] = {k: v for k, v in numbers.items() if k not in limits}
        return {k: (numbers[k], limits[k]) for k in limits}

    def control_numbers(self, items: list, dtype) -> Dict[str, float]:
        """The compared numbers of the control: the reference in ``dtype``
        in the program's place on the same right-hand sides."""
        ctrl = control(self.A, items, self.tol, self.maxiter, self.device, dtype)
        return judge(self.A, ctrl, self.tol, self.maxiter, self.device)


def judge(A, items: List[tuple], tol: float, maxiter: int, device) -> Dict[str, float]:
    """The compared numbers of solves ``(b, x, iterations, converged)``:
    ``resid``, the worst true relative residual of ``x`` in float64;
    ``x_err``, the worst relative distance of ``x`` to the reference's
    solution (solved on to :data:`REFERENCE_RUN_TO`); ``iters_gap``, the
    worst distance of ``iterations`` to the reference's at ``tol``; and
    ``unconverged``, the solves that did not report convergence."""
    R = DeviceCSR.of(A, device)
    out = {"resid": 0.0, "x_err": 0.0, "iters_gap": 0, "unconverged": 0}
    for b, x, iters, converged in items:
        b64 = b.reshape(-1).to(device, torch.float64)
        x64 = x.reshape(-1).to(device, torch.float64)
        ref = cg(R, b64, tol, maxiter, run_to=REFERENCE_RUN_TO)
        resid = float(torch.linalg.vector_norm(b64 - csr_matmul(R, x64)) / torch.linalg.vector_norm(b64))
        x_err = float(torch.linalg.vector_norm(x64 - ref.x) / torch.linalg.vector_norm(ref.x))
        out["resid"] = common.worst(out["resid"], resid)
        out["x_err"] = common.worst(out["x_err"], x_err)
        out["iters_gap"] = max(out["iters_gap"], abs(int(iters) - ref.iterations))
        out["unconverged"] += 0 if converged else 1
    return out


def control(A, items: List[tuple], tol: float, maxiter: int, device, dtype) -> List[tuple]:
    """The reference in ``dtype`` put in the program's place: its solves of
    the same right-hand sides, as ``(b, x, iterations, converged)``."""
    R = DeviceCSR.of(A, device, dtype)
    out = []
    for b, *_ in items:
        res = cg(R, b.reshape(-1).to(device, dtype), tol, maxiter)
        out.append((b, res.x.float(), res.iterations, res.converged))
    return out
