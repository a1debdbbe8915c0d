"""Traffic kind ``spmv_serve``: open-loop tenants applying one operator to
vectors of their own.

Requests arrive at the mix's fixed ``rate_per_s``, their times drawn from
the seed (``portbench.arrivals``; the same number in every run, in another
order for each seed), whether or not the answers to earlier ones are back.
A request is one SpMV of a fresh ``[nranks, L]`` N(0, 1) vector, drawn on
the device from the seed when it arrives.  The path is the program's
serving stack: ``ContinuousBatcher.next_batch`` (one lane, up to
``max_width`` wide, coalescing for ``coalesce_ms``, its strategy pinned to
the operator's) -> ``BatchExecutor.execute_resilient`` ->
``DistributedSpMV.matmat`` (kernel B2), with up to ``inflight_batches``
batches dispatched ahead, so the host enqueues while the card works.  A
request is timed from its arrival, not from when the host got to it, to
the moment the host sees its batch's device work done.  A sample of the
window's answers, drawn from the seed, is judged against the reference's
float64 product of each request's own vector.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import arrivals, common
from portbench.inputs import device_seed, host_rng
from portbench.reference import DeviceCSR, csr_matmul

FP = "operator"
#: seconds of the mix's arrivals served after every batch width has been
#: warmed up, before the window, and in the profiled stretch
WARMUP_S = 1.0
PROFILED_S = 0.25
#: answers of the window judged against the reference
SAMPLE = 32


class Driver:
    def __init__(self, A, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from repro_torch.comm import PodTopology
        from repro_torch.serving import BatchExecutor, ContinuousBatcher, WorkloadClass
        from repro_torch.sparse import DistributedSpMV, partition_csr

        self.A, self.device, self.seed = A, device, seed
        topo = PodTopology(npods=int(cfg["npods"]), ppn=int(cfg["ppn"]))
        part = partition_csr(common.program_csr(A), topo)
        self.op = DistributedSpMV(part, strategy=traffic["strategy"], device=device)
        self.max_width = int(traffic["max_width"])
        self.batcher = ContinuousBatcher({FP: WorkloadClass.from_pattern(part.pattern, fp=FP)},
                                         window=float(traffic["coalesce_ms"]) * 1e-3,
                                         max_width=self.max_width, strategy=self.op.strategy)
        self.executor = BatchExecutor(batcher=self.batcher)
        self.executor.register_spmv(FP, self.op)
        self.ahead = int(traffic["inflight_batches"])
        self.pattern, self.rate = traffic["arrivals"], float(traffic["rate_per_s"])
        self.shape = (topo.nranks, part.rows_per_rank)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(device_seed(seed, 1))
        self.sampler = common.Reservoir(SAMPLE, host_rng(seed, 2))
        self.origin = time.perf_counter()
        self.rid = 0
        # every width a batch can have, then a stretch of the mix itself
        for w in range(1, self.max_width + 1):
            self._serve(np.zeros(w))
        self._serve(self._arrivals(WARMUP_S, 3))
        common.sync(device)
        self.notes = {"strategy": self.op.strategy, "rows_per_rank": self.shape[1],
                      "halo_width": part.halo_width}

    def _arrivals(self, seconds: float, stream: int) -> np.ndarray:
        return arrivals.offsets(self.pattern, self.rate, seconds, self.seed, stream)

    def _serve(self, offsets: np.ndarray, sample: bool = False) -> dict:
        """Serve requests arriving at ``offsets`` seconds from now, until
        every one has its answer."""
        from repro_torch.serving import Request

        n = len(offsets)
        start = time.perf_counter()
        due = start + np.asarray(offsets, dtype=np.float64)
        pending: Dict[int, tuple] = {}  # rid -> (index, vector)
        inflight = collections.deque()
        latencies = np.full(n, np.nan)
        widths: Dict[int, int] = {}
        stats = {"batches": 0, "dispatched": 0, "shed": 0, "queue_max": 0}
        i = 0
        while i < n or pending:
            now = time.perf_counter()
            while i < n and due[i] <= now:
                v = torch.randn(self.shape, generator=self.gen, device=self.device)
                if self.batcher.submit(Request(arrival=due[i] - self.origin, rid=self.rid, fp=FP)):
                    pending[self.rid] = (i, v)
                else:
                    stats["shed"] += 1
                self.rid += 1
                i += 1
            stats["queue_max"] = max(stats["queue_max"], len(self.batcher.queue))
            while len(inflight) < self.ahead:
                with torch.profiler.record_function("portbench.batcher"):
                    batch = self.batcher.next_batch(now - self.origin)
                if batch is None:
                    break
                with torch.profiler.record_function("portbench.dispatch"):
                    V = torch.stack([pending[r.rid][1] for r in batch.requests], dim=-1)
                    outcome = self.executor.execute_resilient(batch, V)
                    inflight.append((outcome, common.Done(self.device)))
                stats["batches"] += 1
                stats["dispatched"] += batch.width
                widths[batch.width] = widths.get(batch.width, 0) + 1
            while inflight and inflight[0][1].query():
                outcome, _ = inflight.popleft()
                now = time.perf_counter()
                if not outcome.ok:
                    stats["shed"] += outcome.batch.width
                for j, r in enumerate(outcome.batch.requests):
                    k, v = pending.pop(r.rid)
                    latencies[k] = now - due[k]
                    if sample and outcome.ok:
                        self.sampler.offer(lambda v=v, y=outcome.value, j=j: (v, y[:, :, j].clone()))
        return {**stats, "latencies": latencies, "widths": widths, "start": start,
                "last_answer": time.perf_counter()}

    def profiled_stretch(self) -> dict:
        got = self._serve(self._arrivals(PROFILED_S, 4))
        common.sync(self.device)
        return {"batch_widths": [w for w, k in sorted(got["widths"].items()) for _ in range(k)],
                "units": got["dispatched"]}

    def window(self, seconds: float) -> dict:
        from repro_torch.comm import cache_stats

        before = cache_stats()
        got = self._serve(self._arrivals(seconds, 5), sample=True)
        common.sync(self.device)
        lat_ms = got["latencies"][np.isfinite(got["latencies"])] * 1e3
        self.notes.update(cache_misses_in_window=common.misses(before, cache_stats()),
                          latency_ms_p50_p95_max=[float(np.percentile(lat_ms, q)) for q in (50, 95, 100)]
                          if len(lat_ms) else [],
                          queue_max=got["queue_max"], offered_per_s=len(got["latencies"]) / seconds,
                          drain_ms=(got["last_answer"] - got["start"] - seconds) * 1e3)
        return {"elapsed_s": seconds, "latencies_ms": lat_ms, "batches": got["batches"],
                "dispatched": got["dispatched"], "batch_widths": got["widths"],
                "attempted": len(got["latencies"]), "failed": got["shed"]}

    def release(self) -> list:
        from repro_torch.comm import clear_caches

        self.op = self.executor = self.batcher = None
        clear_caches()
        return self.sampler.items

    def check(self, items: list, limits: dict) -> Dict[str, tuple]:
        numbers = judge(self.A, items, self.device)
        return {k: (numbers[k], limits[k]) for k in limits}

    def control_numbers(self, items: list, dtype) -> Dict[str, float]:
        """The compared numbers of the control: the reference in ``dtype``
        in the program's place on the same vectors."""
        return judge(self.A, control(self.A, items, self.device, dtype), self.device)


def judge(A, items: List[tuple], device) -> Dict[str, float]:
    """``spmv_err``: over the answers ``(vector, answer)``, the worst gap to
    the reference's float64 product of that vector, row by row relative to
    ``|A| |vector|`` (the scale of the row's rounding)."""
    R = DeviceCSR.of(A, device)
    X = torch.stack([v.reshape(-1) for v, _ in items], dim=1).to(device, torch.float64)
    Y = torch.stack([y.reshape(-1) for _, y in items], dim=1).to(device, torch.float64)
    gap = (Y - csr_matmul(R, X)).abs() / csr_matmul(R, X, absolute=True).clamp_min(1e-300)
    return {"spmv_err": float(gap.max()) if bool(torch.isfinite(gap).all()) else float("nan")}


def control(A, items: List[tuple], device, dtype) -> List[tuple]:
    """The reference in ``dtype`` put in the program's place: its answers
    to the same vectors, as ``(vector, answer)``."""
    R = DeviceCSR.of(A, device, dtype)
    X = torch.stack([v.reshape(-1) for v, _ in items], dim=1).to(device, dtype)
    Y = csr_matmul(R, X).float()
    return [(v, Y[:, j]) for j, (v, _) in enumerate(items)]
