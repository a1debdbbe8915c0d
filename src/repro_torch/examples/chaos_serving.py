"""Chaos serving demo: the recovery ladder keeping a fault storm invisible.

Everything here is seeded, so every number reprints bit-for-bit:

1. Run the continuous-batching traffic simulator twice on one trace --
   fault-free, then under a seeded ``FaultPlan`` storm -- and compare:
   the storm costs latency (every ladder attempt charges a service
   quantum) but not answers (completion stays ~100%, shed only when the
   whole retry -> demote -> re-advise ladder is exhausted).  Identical
   seeds give identical ``trace_hash`` values: fault handling is part of
   the deterministic schedule, not noise on top of it.
2. Drain real batches through :class:`repro_torch.serving.BatchExecutor`
   with a *variant* handler family -- each handler one
   :class:`repro_torch.comm.IrregularExchange` on ``--device`` with the
   storm's ``FaultPlan`` and its checks on -- so the demote/re-advise rungs
   genuinely run a different (strategy, codec), and assert the recovered
   halo buffers are bitwise equal to a fault-free exchange
   (:func:`repro_torch.comm.execute_numpy`).
3. Heal: walk the :class:`repro_torch.comm.faults.HealthTracker` circuit
   breaker through closed -> open -> half-open -> closed and show the
   advisor ranking sinking the degraded pair, then restoring it after
   one successful probe.

The port's counterpart of ``examples/chaos_serving.py`` (whose handlers run
the numpy executor): the same lines, plus ``--device``.  The simulator and
the breaker walk are host code; only step 2 runs on the device.

    PYTHONPATH=src python -m repro_torch.examples.chaos_serving [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.comm import IrregularExchange
from repro_torch.comm.exchange import execute_numpy, plan, random_pattern
from repro_torch.comm.faults import FaultPlan, FaultSpec, HealthTracker
from repro_torch.comm.topology import PodTopology
from repro_torch.core.advisor import EXECUTABLE_STRATEGY, advise_stats
from repro_torch.core.device import resolve_device
from repro_torch.examples import add_device_option, counts_launches, run
from repro_torch.serving import BatchExecutor, SimConfig, WorkloadClass, simulate
from repro_torch.serving.batcher import Batch
from repro_torch.serving.request import Request
from repro_torch.testing import make_trace


@counts_launches
def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    add_device_option(ap)
    device = resolve_device(ap.parse_args(argv).device)

    topo = PodTopology(npods=2, ppn=4)
    rng = np.random.default_rng(0)

    # -- 1. simulated storm -------------------------------------------------
    classes = {}
    patterns = {}
    for i in range(3):
        pat = random_pattern(
            np.random.default_rng(300 + i), topo, local_size=32, max_elems=4
        )
        patterns[f"s{i}"] = pat
        classes[f"s{i}"] = WorkloadClass.from_pattern(pat, fp=f"s{i}")
    trace = make_trace(11, 96, sorted(classes), pattern="burst", rate=4000.0)
    storm_plan = FaultPlan(
        seed=11,
        specs=(
            FaultSpec(kind="perturb", prob=0.35, frac=0.1,
                      strategies=("two_step",)),
            FaultSpec(kind="slow", prob=0.1, delay_s=1e-3),
        ),
    )
    clean = simulate(classes, trace, SimConfig(max_width=8, strategy="two_step"))
    cfg = SimConfig(max_width=8, strategy="two_step", chaos=storm_plan,
                    deadline_s=0.25)
    storm = simulate(classes, trace, cfg)
    again = simulate(classes, trace, cfg)
    print("chaos serving: fault storm vs fault-free on one trace")
    print(f"  fault-free: {clean.completed} completed, p99 {clean.p99*1e3:.2f}ms,"
          f" trace {clean.trace_hash[:12]}")
    print(f"  storm:      {storm.completed} completed, p99 {storm.p99*1e3:.2f}ms,"
          f" {storm.fault_events} faults, {storm.recoveries} ladder recoveries,"
          f" {storm.shed} shed, {storm.probes} probes, trace {storm.trace_hash[:12]}")
    assert storm.trace_hash == again.trace_hash, "chaos must be deterministic"
    assert storm.completed + storm.shed == clean.completed

    # -- 2. a real executor drain with variant handlers ---------------------
    # one fingerprint's exchanges are hit by a persistent per-strategy fault;
    # the re-advise rung moves the batch off two_step and the healed halo is
    # bitwise what a fault-free exchange produces
    fp = FaultPlan(seed=5, specs=(
        FaultSpec(kind="perturb", prob=1.0, frac=0.25, strategies=("two_step",)),
    ))
    local = rng.normal(size=(topo.nranks, 32)).astype(np.float32)
    reference = {
        name: execute_numpy(plan("standard", pat), local)
        for name, pat in patterns.items()
    }

    def make_family(name):
        pat = patterns[name]

        def make(strategy, wire):
            # one attempt per call: the executor's ladder does the recovery
            return IrregularExchange(pat, strategy, device=device, wire=wire, faults=fp,
                                     verify=True, max_retries=0, fallback=False)

        return make

    ex = BatchExecutor(health=HealthTracker())
    outcomes = []
    for i, name in enumerate(sorted(patterns)):
        ex.register_variants(name, make_family(name))
        batch = Batch(
            fp=name, requests=(Request(arrival=0.0, rid=i, fp=name),),
            payload_width=1, resident_bytes=local.nbytes,
            strategy="two_step", wire="none", key="two_step/device_aware",
            predicted_time=1e-4, kind="spmv",
        )
        outcomes.append(ex.execute_resilient(batch, local))
    healed = {}
    for o in outcomes:
        assert o.ok, o.error
        healed[o.batch.fp] = o.value.cpu().numpy()
        assert np.array_equal(healed[o.batch.fp], reference[o.batch.fp]), o.batch.fp
    recovered = [o for o in outcomes if o.recovery]
    print(f"  executor drain: {len(outcomes)} batches, "
          f"{len(recovered)} recovered "
          f"({', '.join(sorted({o.recovery for o in recovered}))}), "
          f"0 shed, healed halos bitwise correct")

    # -- 3. breaker heal: rankings sink, probe, recover ---------------------
    health = HealthTracker(cooldown=3)
    stats = classes["s0"].stats
    baseline = advise_stats(stats, machine="tpu_v5e_pod", health=health)
    best = EXECUTABLE_STRATEGY[baseline.best.strategy]
    for _ in range(2):  # trip the breaker on the clean winner
        health.record_call()
        health.failures[(best, "none")] = health.failures.get((best, "none"), 0) + 1
        health._opened_at[(best, "none")] = health.calls
        health._cooldowns.setdefault((best, "none"), health.cooldown)
    sunk = advise_stats(stats, machine="tpu_v5e_pod", health=health)
    for _ in range(health.cooldown):  # cooldown passes in breaker ticks
        health.record_call()
    state = health.breaker_state(best, "none")
    healed_now = health.record_success(best, "none")  # the probe succeeds
    recovered_rank = advise_stats(stats, machine="tpu_v5e_pod", health=health)
    print(f"  breaker: clean winner {best!r} sank to "
          f"{EXECUTABLE_STRATEGY[sunk.best.strategy]!r} when degraded; "
          f"state {state!r} after cooldown; probe success -> "
          f"{EXECUTABLE_STRATEGY[recovered_rank.best.strategy]!r} restored "
          f"(probe_recoveries={health.probe_recoveries}, healed={healed_now})")
    assert state == "half_open" and healed_now
    assert recovered_rank.best.key == baseline.best.key
    return {
        "clean": clean, "storm": storm, "healed": healed,
        "recoveries": sorted(o.recovery for o in recovered),
        "breaker": (best, EXECUTABLE_STRATEGY[sunk.best.strategy], state,
                    EXECUTABLE_STRATEGY[recovered_rank.best.strategy], health.probe_recoveries),
    }


if __name__ == "__main__":
    run(main)
