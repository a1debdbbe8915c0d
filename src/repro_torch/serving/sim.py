"""Seeded, virtual-clock traffic simulation for the serving front-end.

Tier-1 tests must exercise scheduler behavior -- bursty arrivals, skewed
fingerprint popularity, starvation bounds, cache thrash -- without
wall-clock flakiness, so the simulator is a discrete-event loop on a
virtual clock: time advances only to the next arrival, coalescing
deadline, or batch completion, and service times come from the advisor's
performance model (:func:`repro_torch.core.advisor.advise_stats`) plus a fixed
per-dispatch host overhead.  Every quantity is a pure function of the
(trace, config) pair, so identical seeds produce identical event traces,
identical p50/p99, and an identical ``trace_hash`` -- pinned in
``tests/test_serving.py``.

Event tuples, in emission order (ties: arrivals, then dispatch+completion):

* ``("arrive", t, rid, fp)`` -- request admitted to its lane
* ``("reject", t, rid, fp)`` -- request shed by admission control
* ``("dispatch", t, fp, width, key, rids)`` -- batch started; ``key`` is the
  advisor's strategy/codec key, ``rids`` the coalesced request ids
* ``("complete", t, fp, rids)`` -- batch finished at virtual ``t``

Under a seeded chaos schedule (``SimConfig.chaos``) a dispatch may also
emit, between its ``dispatch`` and ``complete``/``shed``:

* ``("fault", t, fp, "strategy/wire")`` -- one seeded integrity failure
* ``("probe", t, fp, "strategy/wire")`` -- a half-open breaker probing
* ``("recover", t, fp, "action:strategy/wire")`` -- ladder rung that saved
  the batch
* ``("shed", t, fp, rids)`` -- ladder exhausted; the batch's requests shed

All chaos decisions are pure functions of (plan seed, ladder-attempt
index, spec ordinal), so ``trace_hash`` covers fault handling too; with
``chaos=None`` the event trace is byte-identical to pre-chaos simulators.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm.faults import (
    ExchangeIntegrityError,
    FaultPlan,
    HealthTracker,
    run_ladder,
)
from repro_torch.runtime import AdmissionController, StragglerWatchdog

from .batcher import ContinuousBatcher
from .queue import RequestQueue
from .request import Request, WorkloadClass


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Knobs of one simulated serving deployment."""

    window: float = 1e-3  # coalescing window (virtual seconds)
    max_width: int = 8  # request cap per batch
    memory_budget: Optional[int] = None  # resident bytes cap per batch
    machine: str = "tpu_v5e_pod"
    wire: object = None  # advisor wire= argument (None keeps full precision)
    #: pin every batch to one executable strategy; None = advisor's choice
    strategy: Optional[str] = None
    #: fixed per-dispatch host cost: queue pop, plan-cache lookup, launch.
    #: This is the term coalescing amortizes even when byte terms dominate.
    host_overhead_s: float = 50e-6
    max_queue_depth: int = 4096
    #: seeded fault schedule: each ladder attempt draws one deterministic
    #: firing decision per spec (None = fault-free, trace unchanged)
    chaos: Optional[FaultPlan] = None
    #: ladder retries per faulted dispatch before codec demote / re-advise
    chaos_retries: int = 1
    #: per-request latency SLO; completions past it count as deadline
    #: misses (ladder attempts charge service time, so faults can miss it)
    deadline_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.host_overhead_s <= 0:
            raise ValueError(
                "host_overhead_s must be > 0 (a zero-cost dispatch would let "
                f"the event loop stall), got {self.host_overhead_s}"
            )


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Everything a test may pin about one simulation."""

    events: Tuple[tuple, ...]
    latencies: Tuple[Tuple[int, float], ...]  # (rid, complete - arrival), rid order
    p50: float
    p99: float
    throughput: float  # completed requests per virtual second
    makespan: float  # first arrival -> last completion
    completed: int
    rejected: int
    batches: int
    mean_width: float
    escalations: int  # watchdog escalations from admission overload
    shed: int = 0  # requests lost to exhausted recovery ladders
    fault_events: int = 0  # seeded integrity failures injected
    recoveries: int = 0  # batches saved by a ladder rung below the first
    probes: int = 0  # half-open breaker probe attempts
    probe_recoveries: int = 0  # probes that closed a breaker
    deadline_misses: int = 0  # completions past config.deadline_s

    @property
    def trace_hash(self) -> str:
        """sha1 over the full event trace -- equal hashes mean the two runs
        made bit-identical scheduling decisions."""
        return hashlib.sha1(repr(self.events).encode()).hexdigest()

    def summary(self) -> Dict[str, float]:
        return {
            "p50_s": self.p50,
            "p99_s": self.p99,
            "throughput_rps": self.throughput,
            "completed": float(self.completed),
            "rejected": float(self.rejected),
            "batches": float(self.batches),
            "mean_width": self.mean_width,
        }


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals) + 0.5) - 1))
    return sorted_vals[idx]


def simulate(
    classes: Dict[str, WorkloadClass],
    trace: Sequence[Request],
    config: SimConfig = SimConfig(),
) -> SimResult:
    """Run ``trace`` through a single-executor serving deployment.

    The executor is the serial resource: one batch's exchange + fused
    compute at a time, matching the host-side dispatch loop of the real
    front-end.  Service time for a batch is the advisor's predicted
    exchange time at the coalesced payload width plus
    ``config.host_overhead_s``; under chaos, every extra ladder attempt
    charges another full service quantum (and ``"slow"`` specs their
    ``delay_s``), so faults degrade latency even when they recover.
    """
    watchdog = StragglerWatchdog()
    admission = AdmissionController(
        max_queue_depth=config.max_queue_depth, watchdog=watchdog
    )
    # faults and overload share ONE escalation budget: the health tracker's
    # integrity failures land on the same watchdog as admission rejections
    health = HealthTracker(watchdog=watchdog) if config.chaos is not None else None
    batcher = ContinuousBatcher(
        classes,
        RequestQueue(admission),
        window=config.window,
        max_width=config.max_width,
        memory_budget=config.memory_budget,
        machine=config.machine,
        wire=config.wire,
        health=health,
        strategy=config.strategy,
    )
    order = sorted(trace)  # (arrival, rid): generator interleaving is irrelevant
    events = []
    latencies: Dict[int, float] = {}
    now = 0.0
    busy_until = 0.0
    ti = 0
    n = len(order)
    last_complete = 0.0
    widths = []
    attempt_clock = [0]  # global ladder-attempt index (the chaos seed axis)
    fault_events = 0
    shed_requests = 0
    recoveries = 0
    # Generous stall guard: every loop iteration either consumes an arrival,
    # dispatches a batch, or advances the clock to a strictly later event.
    for _ in range(8 * n + 64):
        while ti < n and order[ti].arrival <= now:
            req = order[ti]
            ti += 1
            tag = "arrive" if batcher.submit(req) else "reject"
            events.append((tag, req.arrival, req.rid, req.fp))
        if busy_until <= now:
            batch = batcher.next_batch(now)
            if batch is not None:
                rids = tuple(r.rid for r in batch.requests)
                quantum = batch.predicted_time + config.host_overhead_s
                events.append(("dispatch", now, batch.fp, batch.width, batch.key, rids))
                ok, service, nfaults, path = True, quantum, 0, None
                if config.chaos is not None:
                    ok, service, nfaults, path = _chaos_dispatch(
                        config, batch, health, attempt_clock, events, now, quantum
                    )
                    fault_events += nfaults
                done = now + service
                if ok:
                    if path is not None:
                        recoveries += 1
                        events.append(("recover", now, batch.fp, path.key))
                    events.append(("complete", done, batch.fp, rids))
                    for r in batch.requests:
                        latencies[r.rid] = done - r.arrival
                else:
                    shed_requests += len(rids)
                    admission.record_shed(
                        len(rids), {"fp": batch.fp, "requests": len(rids)}
                    )
                    events.append(("shed", done, batch.fp, rids))
                widths.append(batch.width)
                busy_until = done
                last_complete = done
                continue
        if ti >= n and len(batcher.queue) == 0:
            break
        candidates = []
        if ti < n:
            candidates.append(order[ti].arrival)
        if len(batcher.queue):
            deadline = batcher.next_deadline(now)
            if deadline is not None:
                candidates.append(max(deadline, busy_until))
        if not candidates:
            break
        now = max(now, min(candidates))
    else:
        raise RuntimeError(
            "simulate() exceeded its event budget -- the scheduler stalled "
            f"with {len(batcher.queue)} queued and {n - ti} arrivals pending"
        )
    lat_sorted = sorted(latencies.values())
    t0 = order[0].arrival if order else 0.0
    makespan = max(last_complete - t0, 0.0)
    completed = len(latencies)
    deadline_misses = (
        0
        if config.deadline_s is None
        else sum(1 for v in lat_sorted if v > config.deadline_s)
    )
    return SimResult(
        events=tuple(events),
        latencies=tuple(sorted(latencies.items())),
        p50=_percentile(lat_sorted, 0.50),
        p99=_percentile(lat_sorted, 0.99),
        throughput=completed / makespan if makespan > 0 else 0.0,
        makespan=makespan,
        completed=completed,
        rejected=admission.rejected,
        batches=batcher.batches,
        mean_width=sum(widths) / len(widths) if widths else 0.0,
        escalations=admission.escalations,
        shed=shed_requests,
        fault_events=fault_events,
        recoveries=recoveries,
        probes=0 if health is None else health.probes,
        probe_recoveries=0 if health is None else health.probe_recoveries,
        deadline_misses=deadline_misses,
    )


def _chaos_dispatch(
    config: SimConfig,
    batch,
    health: HealthTracker,
    attempt_clock,
    events,
    now: float,
    quantum: float,
):
    """One batch through the REAL recovery ladder under the seeded schedule.

    Each ladder attempt consumes one tick of the global attempt clock; a
    spec fires iff ``plan.active(tick)``, it matches the attempted
    (strategy, wire), and its seeded coin (``rng([seed, tick, spec])``)
    lands under ``prob`` -- so the full fault/recovery history is a pure
    function of (plan, trace) and lands in ``trace_hash``.  Returns
    ``(ok, service_s, n_faults, recovery_path)``.
    """
    plan = config.chaos
    state = {"attempts": 0, "faults": 0, "delay": 0.0}

    def attempt(strategy: str, wire: str):
        tick = attempt_clock[0]
        attempt_clock[0] += 1
        state["attempts"] += 1
        for si, spec in enumerate(plan.specs):
            if not plan.active(tick) or not spec.matches(strategy, wire):
                continue
            coin = np.random.default_rng([plan.seed, tick, si]).random()
            if coin >= spec.prob:
                continue
            if spec.kind == "slow":
                state["delay"] += spec.delay_s
                continue
            state["faults"] += 1
            events.append(("fault", now, batch.fp, f"{strategy}/{wire}"))
            raise ExchangeIntegrityError(
                strategy=strategy,
                codec=wire,
                stage_kind="a2a_pod",
                op_index=0,
                violation=1.0,
            )
        return True

    probes_before = health.probes
    try:
        _, path = run_ladder(
            attempt,
            strategy=batch.strategy,
            wire=batch.wire,
            health=health,
            max_retries=config.chaos_retries,
            choose_alternative=_fixed_preference,
        )
    except ExchangeIntegrityError:
        ok, path = False, None
    else:
        ok = True
    if health.probes > probes_before:
        events.append(("probe", now, batch.fp, f"{batch.strategy}/{batch.wire}"))
    service = state["attempts"] * quantum + state["delay"]
    return ok, service, state["faults"], path


def _fixed_preference(health: HealthTracker, current: str):
    """The simulator's re-advise chooser: deterministic fixed preference
    order over the executable strategies, skipping degraded ones (the real
    executor re-ranks via the advisor; the sim keeps the decision cheap
    and trace-stable)."""
    for name in ("two_step", "three_step", "split", "standard"):
        if name != current and not health.is_degraded(name):
            return name
    return None


def sequential_baseline(
    classes: Dict[str, WorkloadClass],
    trace: Sequence[Request],
    config: SimConfig = SimConfig(),
) -> SimResult:
    """The no-coalescing control: same trace, same advisor, but every
    request dispatches alone (``max_width=1``, zero window)."""
    return simulate(
        classes, trace, dataclasses.replace(config, window=0.0, max_width=1)
    )


def serving_report(
    classes: Dict[str, WorkloadClass],
    trace: Sequence[Request],
    config: SimConfig = SimConfig(),
) -> Dict[str, object]:
    """Coalesced vs. sequential on one trace -- the acceptance-criterion
    record (`BENCH_exchange.json` schema 4 ``serving`` section)."""
    coalesced = simulate(classes, trace, config)
    sequential = sequential_baseline(classes, trace, config)
    speedup = (
        coalesced.throughput / sequential.throughput
        if sequential.throughput > 0
        else 0.0
    )
    return {
        "coalesced": coalesced.summary(),
        "sequential": sequential.summary(),
        "speedup": speedup,
        "max_width": config.max_width,
        "window_s": config.window,
        "trace_hash": coalesced.trace_hash,
    }
