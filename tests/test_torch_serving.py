"""The port's serving front end and executor against the JAX package's.

* ``repro_torch.serving.simulate`` is a copy of the reference's seeded
  virtual-clock simulator: for the same seed and config it emits the same
  events and the same ``trace_hash``, with and without a chaos schedule;
  ``make_trace`` / ``zipf_weights`` are bitwise the reference's.
* The queue, batcher, admission and watchdog cases of the reference's
  ``tests/test_serving.py``, as parametrised cases.
* ``BatchExecutor`` drains a simulated schedule through the port's
  ``DistributedSpMV.matmat`` (kernel B2's plain version on the CPU); every
  completed batch equals the operator's product of its columns and the
  float64 CSR product, and the resilient drain's ladder, deadline, backoff
  and shedding behave as the reference's.
"""

import gc
import importlib.util
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.comm
import repro.serving
import repro.testing
import repro_torch.comm
import repro_torch.serving
import repro_torch.testing
from repro.comm import FaultPlan as RefFaultPlan
from repro.comm import FaultSpec as RefFaultSpec
from repro.comm import PodTopology as RefTopology
from repro.comm import random_pattern as ref_random_pattern
from repro.serving import SimConfig as RefSimConfig
from repro.serving import WorkloadClass as RefWorkloadClass
from repro.serving import serving_report as ref_serving_report
from repro.serving import simulate as ref_simulate
from repro.testing import make_trace as ref_make_trace
from repro.testing import zipf_weights as ref_zipf_weights
from repro_torch.comm import FaultPlan, FaultSpec, PodTopology, execute_numpy, plan, random_pattern
from repro_torch.comm import faults as F
from repro_torch.runtime import AdmissionController, StragglerWatchdog
from repro_torch.serving import (
    Batch,
    BatchExecutor,
    ContinuousBatcher,
    Request,
    RequestQueue,
    SimConfig,
    WorkloadClass,
    measure_spmv_replay,
    sequential_baseline,
    serving_report,
    simulate,
)
from repro_torch.solve import spd_system
from repro_torch.sparse import DistributedSpMV, partition_csr, reference_mm, thermal_like
from repro_torch.testing import ARRIVAL_PATTERNS, make_trace, zipf_weights

TOPO = PodTopology(npods=2, ppn=4)
REF_TOPO = RefTopology(npods=2, ppn=4)


def _classes(ref=False, n=4):
    make_pattern, make_class = (
        (ref_random_pattern, RefWorkloadClass) if ref else (random_pattern, WorkloadClass))
    topo = REF_TOPO if ref else TOPO
    return {
        f"c{i}": make_class.from_pattern(
            make_pattern(np.random.default_rng(100 + i), topo, local_size=32, max_elems=4),
            fp=f"c{i}")
        for i in range(n)
    }


CLASSES, REF_CLASSES = _classes(), _classes(ref=True)
FPS = sorted(CLASSES)


def _storm(seed, ref=False):
    plan_, spec = (RefFaultPlan, RefFaultSpec) if ref else (FaultPlan, FaultSpec)
    return plan_(seed=seed, specs=(
        spec(kind="perturb", prob=0.3, frac=0.1, strategies=("two_step",)),
        spec(kind="corrupt", prob=0.1, codecs=("lossy",)),
        spec(kind="slow", prob=0.1, delay_s=2e-3),
    ))


# ---------------------------------------------------------------------------
# the simulator against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "chaos"])
@pytest.mark.parametrize("pattern", ARRIVAL_PATTERNS)
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_simulate_equals_reference(seed, pattern, chaos):
    kw = dict(window=1e-3, max_width=8)
    port_cfg, ref_cfg = SimConfig(**kw), RefSimConfig(**kw)
    if chaos:
        port_cfg = SimConfig(**kw, chaos=_storm(seed), deadline_s=0.05, strategy="two_step")
        ref_cfg = RefSimConfig(**kw, chaos=_storm(seed, ref=True), deadline_s=0.05,
                               strategy="two_step")
    got = simulate(CLASSES, make_trace(seed, 200, FPS, pattern=pattern, rate=50000.0), port_cfg)
    want = ref_simulate(REF_CLASSES, ref_make_trace(seed, 200, FPS, pattern=pattern, rate=50000.0),
                        ref_cfg)
    assert got.events == want.events
    assert got.trace_hash == want.trace_hash
    assert got.summary() == want.summary()
    assert (got.shed, got.fault_events, got.recoveries, got.deadline_misses) == (
        want.shed, want.fault_events, want.recoveries, want.deadline_misses)
    if chaos:
        assert got.fault_events > 0


def test_serving_report_equals_reference():
    got = serving_report(CLASSES, make_trace(7, 256, FPS, pattern="burst", rate=200000.0,
                                             skew=1.2, burst=32), SimConfig())
    want = ref_serving_report(REF_CLASSES, ref_make_trace(7, 256, FPS, pattern="burst",
                                                          rate=200000.0, skew=1.2, burst=32),
                              RefSimConfig())
    assert got == want
    assert got["speedup"] >= 3.0 and got["coalesced"]["mean_width"] > 4.0


def test_chip_smoke_trace_hash_is_the_reference_hash():
    """``chip_smoke.py`` checks ``simulate()``'s hash on the card against a
    constant: it is the reference simulator's hash for that case."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = smoke.sim_case(repro.comm, repro.serving, repro.testing)
    got = smoke.sim_case(repro_torch.comm, repro_torch.serving, repro_torch.testing)
    assert want.trace_hash == got.trace_hash == smoke.SIM_TRACE_HASH
    assert got.events == want.events and got.fault_events > 0 and got.recoveries > 0


@pytest.mark.parametrize("kw", [
    dict(pattern="poisson", skew=1.0),
    dict(pattern="burst", burst=8, rate=8000.0),
    dict(pattern="uniform", rate=1000.0, skew=0.0),
    dict(pattern="poisson", skew=1.5, t0=3.0, kinds={"c0": "solve"}),
])
def test_make_trace_equals_reference(kw):
    got = make_trace(3, 100, FPS, **kw)
    want = ref_make_trace(3, 100, FPS, **kw)
    assert [(r.arrival, r.rid, r.fp, r.kind) for r in got] == [
        (r.arrival, r.rid, r.fp, r.kind) for r in want]
    for n, skew in ((1, 1.0), (4, 0.0), (10, 1.5)):
        assert zipf_weights(n, skew).tobytes() == ref_zipf_weights(n, skew).tobytes()


def test_workload_classes_equal_reference():
    for fp in FPS:
        got, want = CLASSES[fp], REF_CLASSES[fp]
        assert (got.bytes_per_request, got.base_width, got.kind) == (
            want.bytes_per_request, want.base_width, want.kind)
        assert vars(got.stats) == vars(want.stats)  # two packages' PatternStats


# ---------------------------------------------------------------------------
# the reference's queue / batcher / admission cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["fifo-lanes", "controller-counts", "overload-escalates",
                                  "controller-validation", "watchdog-escalates",
                                  "watchdog-needs-a-step", "record-shed"])
def test_queue_admission_and_watchdog(case):
    if case == "fifo-lanes":
        q = RequestQueue()
        for i in range(6):
            assert q.submit(Request(arrival=0.1 * i, rid=i, fp=f"c{i % 2}"))
        assert len(q) == 6
        assert [r.rid for r in q.take("c0", 2)] == [0, 2]
        assert [r.rid for r in q.take("c0", 9)] == [4]
        assert q.peek_oldest("c0") is None and q.take("c0", 1) == []
        assert [fp for fp, _, _ in q.lanes()] == ["c1"]
    elif case == "controller-counts":
        ac = AdmissionController(max_queue_depth=2, reject_burst=3)
        assert ac.admit(0) and ac.admit(1)
        assert not ac.admit(2) and not ac.admit(5)
        assert ac.admit(1)
        assert (ac.admitted, ac.rejected) == (3, 2)
    elif case == "overload-escalates":
        wd = StragglerWatchdog(budget=2)
        ac = AdmissionController(max_queue_depth=1, watchdog=wd, reject_burst=4)
        ac.admit(0)
        for _ in range(8):
            ac.admit(1)
        assert ac.rejected == 8
        assert [e.get("kind") for e in wd.events] == ["admission_overload"] * 2
        assert ac.escalations == 1
    elif case == "controller-validation":
        with pytest.raises(ValueError):
            AdmissionController(max_queue_depth=0)
        with pytest.raises(ValueError):
            AdmissionController(reject_burst=0)
    elif case == "watchdog-escalates":
        wd = StragglerWatchdog(factor=3.0, budget=2)
        for step, dt in enumerate([1.0, 1.0, 5.0, 6.0]):
            wd.start_step()
            wd._t0 -= dt  # a step that took dt seconds
            exhausted = wd.end_step(step)
        assert exhausted and wd.consecutive == 2 and len(wd.events) == 2
        assert wd.record_external("x") and wd.events[-1] == {"kind": "x"}
    elif case == "watchdog-needs-a-step":
        with pytest.raises(RuntimeError, match="no open step"):
            StragglerWatchdog().end_step(0)
    else:
        wd = StragglerWatchdog(budget=1)
        ac = AdmissionController(watchdog=wd)
        ac.record_shed(3, {"fp": "c0"})
        assert ac.shed == 3 and ac.escalations == 1
        assert wd.events[-1]["kind"] == "batch_shed"


@pytest.mark.parametrize("case", ["validation", "advice-memo", "strategy-from-advisor",
                                  "class-validation", "pinned-strategy", "readvise",
                                  "memory-budget", "sequential-is-width-one"])
def test_batcher(case):
    if case == "validation":
        with pytest.raises(ValueError):
            ContinuousBatcher({})
        with pytest.raises(ValueError):
            ContinuousBatcher(CLASSES, max_width=0)
        with pytest.raises(ValueError):
            ContinuousBatcher(CLASSES, window=-1.0)
        bpr = min(c.bytes_per_request for c in CLASSES.values())
        with pytest.raises(ValueError):
            ContinuousBatcher(CLASSES, memory_budget=bpr - 1)
        with pytest.raises(KeyError):
            ContinuousBatcher(CLASSES).submit(Request(0.0, 0, "nope"))
        with pytest.raises(ValueError, match="unknown strategy"):
            ContinuousBatcher(CLASSES, strategy="nope")
    elif case == "advice-memo":
        b = ContinuousBatcher(CLASSES, max_width=8)
        assert b.advise("c0", 8) is b.advise("c0", 8)
        assert (b.advice_hits, b.advice_misses) == (1, 1)
        b.advise("c0", 4)
        assert b.advice_misses == 2
    elif case == "strategy-from-advisor":
        b = ContinuousBatcher(CLASSES, window=0.0, max_width=8)
        for i in range(8):
            b.submit(Request(arrival=0.0, rid=i, fp="c0"))
        batch = b.next_batch(0.0)
        assert batch is not None and batch.width == 8 and batch.payload_width == 8
        best = b.advise("c0", 8).best
        assert (batch.key, batch.predicted_time) == (best.key, best.predicted_time)
        assert batch.strategy in ("standard", "two_step", "three_step", "split")
    elif case == "class-validation":
        cls = CLASSES["c0"]
        with pytest.raises(ValueError):
            WorkloadClass(fp="x", stats=cls.stats, bytes_per_request=0)
        with pytest.raises(ValueError):
            WorkloadClass(fp="x", stats=cls.stats, bytes_per_request=1, base_width=0)
        with pytest.raises(ValueError):
            ContinuousBatcher({"other": cls})
    elif case == "pinned-strategy":
        b = ContinuousBatcher(CLASSES, window=0.0, max_width=4, strategy="split")
        for i in range(4):
            b.submit(Request(arrival=0.0, rid=i, fp="c1"))
        assert b.next_batch(0.0).strategy == "split"
    elif case == "readvise":
        b = ContinuousBatcher(CLASSES, max_width=8)
        first = b.advise("c0", 8)
        again = b.readvise("c0", 8)
        assert again is not first and again.best.key == first.best.key
        assert b.advice_misses == 2
    elif case == "memory-budget":
        budget = CLASSES["c2"].bytes_per_request * 3
        res = simulate(CLASSES, make_trace(2, 120, FPS, pattern="burst", rate=100000.0, burst=16),
                       SimConfig(window=1e-3, max_width=8, memory_budget=budget))
        for ev in res.events:
            if ev[0] == "dispatch":
                assert ev[3] * CLASSES[ev[2]].bytes_per_request <= budget
        assert res.completed == 120
    else:
        res = sequential_baseline(CLASSES, make_trace(4, 60, FPS, pattern="poisson", rate=50000.0),
                                  SimConfig(max_width=8))
        assert res.mean_width == 1.0 and res.batches == res.completed == 60


def test_next_deadline_and_ripeness():
    b = ContinuousBatcher(CLASSES, window=1e-3, max_width=2)
    assert b.next_deadline(0.0) is None and b.next_batch(0.0) is None
    b.submit(Request(arrival=0.0, rid=0, fp="c0"))
    assert b.next_deadline(0.0) == 1e-3 and b.next_batch(0.0) is None
    b.submit(Request(arrival=0.0, rid=1, fp="c0"))  # lane full: ripe now
    assert b.next_deadline(0.0) == 0.0
    assert [r.rid for r in b.next_batch(0.0).requests] == [0, 1]


# ---------------------------------------------------------------------------
# the executor on the port's DistributedSpMV
# ---------------------------------------------------------------------------

N = 256


def _spmv_case(seed=0):
    A = spd_system(thermal_like(N, np.random.default_rng(seed)))
    part = partition_csr(A, TOPO)
    return A, part


def test_run_schedule_drains_a_simulated_schedule_through_matmat():
    """Batches the simulator dispatched drain through one ``matmat`` each;
    every completed batch equals the operator's product of its columns
    (bitwise) and the float64 CSR product."""
    A, part = _spmv_case()
    ops = {fp: DistributedSpMV(part, strategy="two_step", device="cpu") for fp in ("a", "b")}
    classes = {fp: WorkloadClass.from_pattern(part.pattern, fp=fp) for fp in ops}
    trace = make_trace(5, 40, sorted(classes), pattern="burst", rate=20000.0, burst=8)
    res = simulate(classes, trace, SimConfig(max_width=8))
    ex = BatchExecutor(health=F.HealthTracker())
    for fp, op in ops.items():
        ex.register_spmv(fp, op)
    batcher = ContinuousBatcher(classes, max_width=8)
    by_rid = {r.rid: r for r in trace}
    batches, payloads = [], []
    rng = np.random.default_rng(6)
    g, L = TOPO.nranks, part.rows_per_rank
    for ev in res.events:
        if ev[0] != "dispatch":
            continue
        _, _, fp, width, _, rids = ev
        adv = batcher.advise(fp, width).best
        batches.append(Batch(fp=fp, requests=tuple(by_rid[r] for r in rids), payload_width=width,
                             resident_bytes=classes[fp].bytes_per_request * width,
                             strategy="two_step", wire=adv.wire, key=adv.key,
                             predicted_time=adv.predicted_time, kind="spmv"))
        payloads.append(torch.as_tensor(rng.standard_normal((g, L, width)).astype(np.float32)))
    outcomes = ex.run_schedule(batches, payloads)
    assert len(outcomes) == res.batches and all(o.ok and o.recovery is None for o in outcomes)
    assert sum(o.batch.width for o in outcomes) == res.completed == 40
    for o, V in zip(outcomes, payloads):
        W = o.value
        assert torch.equal(W, ops[o.batch.fp].matmat(V))
        want = reference_mm(A, V.numpy().reshape(-1, V.shape[2]))
        np.testing.assert_allclose(W.numpy().reshape(want.shape), want, rtol=1e-4, atol=1e-4)
        for c in range(V.shape[2]):  # B2 is bitwise per column
            assert torch.equal(W[:, :, c], ops[o.batch.fp].matmat(V[:, :, c:c + 1].contiguous())[:, :, 0])
    assert ex.executed == len(outcomes) and ex.shed_batches == 0


def test_register_moe_drains_a_simulated_moe_schedule():
    """MoE dispatch batches: the simulator coalesces requests of a measured
    routing class, each request a token batch of one row per rank; the
    executor runs each coalesced batch (requests stacked on the batch axis)
    through one exchange-dispatch ``MoELayer`` call, bitwise the all-to-all
    layer on the same stacked payload."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import MoELayer

    M, S = 16, 4
    cfg = MoEConfig(n_experts=16, top_k=2, d_ff_expert=32)
    rng = np.random.default_rng(7)
    params = {k: torch.as_tensor((rng.standard_normal(shape) * sc).astype(np.float32))
              for k, shape, sc in (("router", (M, 16), 2.0), ("w_in", (16, M, 32), 0.1),
                                   ("w_gate", (16, M, 32), 0.1), ("w_out", (16, 32, M), 0.1))}
    counts = rng.integers(0, 12, size=(TOPO.nranks, TOPO.nranks))
    classes = {"moe": WorkloadClass.from_routing(counts, ppn=TOPO.ppn, d_model=M, fp="moe")}
    trace = make_trace(3, 24, ["moe"], pattern="poisson", rate=2000.0, kinds={"moe": "moe"})
    res = simulate(classes, trace, SimConfig(max_width=8))
    layer = MoELayer(M, cfg, dispatch="exchange", strategy="two_step")
    base = MoELayer(M, cfg)
    ex = BatchExecutor()
    ex.register_moe("moe", layer, params, TOPO)
    by_rid = {r.rid: r for r in trace}
    batches, payloads = [], []
    for ev in res.events:
        if ev[0] != "dispatch":
            continue
        _, _, fp, width, key, rids = ev
        batches.append(Batch(fp=fp, requests=tuple(by_rid[r] for r in rids), payload_width=width,
                             resident_bytes=classes[fp].bytes_per_request * width, strategy="two_step",
                             wire="none", key=key, predicted_time=0.0, kind="moe"))
        payloads.append(torch.as_tensor(
            rng.standard_normal((width * TOPO.nranks, S, M)).astype(np.float32)))
    outcomes = ex.run_schedule(batches, payloads)
    assert len(outcomes) == res.batches and all(o.ok and o.recovery is None for o in outcomes)
    assert sum(o.batch.width for o in outcomes) == res.completed == 24
    assert len({o.batch.width for o in outcomes}) > 1  # widths differ: several capacities
    for o, x in zip(outcomes, payloads):
        assert torch.equal(o.value, base(params, x, TOPO))
    assert layer.dispatcher.histogram.updates == len(outcomes) and ex.executed == len(outcomes)


def _exchange_fixture():
    rng = np.random.default_rng(0)
    pats = {f"t{i}": random_pattern(np.random.default_rng(40 + i), TOPO, local_size=16, max_elems=4)
            for i in range(3)}
    x = rng.normal(size=(TOPO.nranks, 16)).astype(np.float32)
    refs = {k: execute_numpy(plan("standard", p), x) for k, p in pats.items()}
    return pats, x, refs


def _batch(fp, rids=(0,), strategy="two_step", wire="none"):
    return Batch(fp=fp, requests=tuple(Request(arrival=0.0, rid=r, fp=fp) for r in rids),
                 payload_width=len(rids), resident_bytes=1024, strategy=strategy, wire=wire,
                 key=f"{strategy}/device_aware", predicted_time=1e-4, kind="spmv")


def _family(pat, faults=None):
    counter = {"n": 0}

    def make(strategy, wire):
        def handler(payload):
            idx = counter["n"]
            counter["n"] += 1
            return execute_numpy(plan(strategy, pat), payload, wire=wire, faults=faults,
                                 fault_call=idx, verify=True)

        return handler

    return make


@pytest.mark.parametrize("error", [KeyError, F.ExchangeIntegrityError])
def test_run_schedule_leaves_no_reference_cycle(error):
    """An outcome that carries a handler's error (a ``KeyError``, or an
    integrity error that exhausts the ladder) does not keep the schedule's
    payloads alive: they are freed when the caller drops the outcomes, not
    when the collector runs.  The error keeps its type, message and the
    traceback's text."""
    ex = BatchExecutor(max_retries=0, fallback=False)

    def failing(payload):
        if error is KeyError:
            raise KeyError("no operator for this fingerprint")
        raise F.ExchangeIntegrityError(strategy="two_step", codec="none", stage_kind="a2a_pod", op_index=0)

    ex.register("t0", failing)

    def caller():
        payload = torch.zeros(8)
        outs = ex.run_schedule([_batch("t0", (0,)), _batch("ghost", (1, 2))], [payload, payload])
        assert [o.ok for o in outs] == [False, False]
        assert isinstance(outs[0].error, error) and isinstance(outs[1].error, KeyError)
        assert "failing" in "".join(outs[0].error.__notes__)
        assert [o.shed_rids for o in outs] == [(0,), (1, 2)] and ex.shed_requests == 3
        return weakref.ref(payload)

    gc.collect()
    gc.disable()
    try:
        ref = caller()
        alive = ref() is not None
    finally:
        gc.enable()
    assert not alive


@pytest.mark.parametrize("case", ["keyerror-keeps-work", "handler-bug", "ladder-recovers",
                                  "retry-cures-transient", "deadline-sheds", "backoff-capped",
                                  "fault-free-equals-execute", "storm-completes"])
def test_resilient_drain(case):
    pats, x, refs = _exchange_fixture()
    if case == "keyerror-keeps-work":
        ex = BatchExecutor()
        ex.register_variants("t0", _family(pats["t0"]))
        ex.register_variants("t2", _family(pats["t2"]))
        outs = ex.run_schedule([_batch("t0", (0,)), _batch("ghost", (1, 2)), _batch("t2", (3,))],
                               [x, x, x])
        assert [o.ok for o in outs] == [True, False, True]
        assert np.array_equal(outs[0].value, refs["t0"]) and np.array_equal(outs[2].value, refs["t2"])
        assert isinstance(outs[1].error, KeyError) and outs[1].shed_rids == (1, 2)
        assert ex.shed_batches == 1 and ex.shed_requests == 2
        with pytest.raises(ValueError):
            ex.run_schedule([_batch("t0")], [])
    elif case == "handler-bug":
        ex = BatchExecutor()
        ex.register_variants("t0", _family(pats["t0"]))

        def buggy(payload):
            raise ValueError("handler bug")

        ex.register("t1", buggy)
        outs = ex.run_schedule([_batch("t1"), _batch("t0", (1,))], [x, x])
        assert not outs[0].ok and isinstance(outs[0].error, ValueError)
        assert outs[1].ok and np.array_equal(outs[1].value, refs["t0"])
    elif case == "ladder-recovers":
        storm = F.FaultPlan(seed=5, specs=(F.FaultSpec(kind="perturb", prob=1.0, frac=0.25,
                                                       strategies=("two_step",)),))
        ex = BatchExecutor(health=F.HealthTracker())
        ex.register_variants("t0", _family(pats["t0"], faults=storm))
        o = ex.execute_resilient(_batch("t0"), x)
        assert o.ok and o.recovery.startswith(("demote:", "readvise:")) and o.attempts >= 2
        assert np.array_equal(o.value, refs["t0"]) and ex.recovered_batches == 1
    elif case == "retry-cures-transient":
        transient = F.FaultPlan(seed=7, specs=(F.FaultSpec(kind="corrupt"),), active_calls=(0,))
        ex = BatchExecutor()
        ex.register_variants("t1", _family(pats["t1"], faults=transient))
        o = ex.execute_resilient(_batch("t1"), x)
        assert o.ok and o.recovery == "retry:two_step/none" and o.attempts == 2
        assert np.array_equal(o.value, refs["t1"])
    elif case == "deadline-sheds":
        always = F.FaultPlan(seed=3, specs=(F.FaultSpec(kind="corrupt"),))
        t = {"now": 0.0}

        def clock():
            t["now"] += 10.0
            return t["now"]

        wd = StragglerWatchdog(budget=1)
        adm = AdmissionController(watchdog=wd)
        ex = BatchExecutor(deadline_s=5.0, clock=clock, sleep=lambda s: None, watchdog=wd,
                           admission=adm)
        ex.register_variants("t0", _family(pats["t0"], faults=always))
        o = ex.execute_resilient(_batch("t0", rids=(7, 8)), x)
        assert not o.ok and o.deadline_missed and o.shed_rids == (7, 8)
        assert ex.deadline_misses == 1 and adm.shed == 2 and adm.escalations == 1
        assert any(e.get("kind") == "batch_shed" for e in wd.events)
    elif case == "backoff-capped":
        always = F.FaultPlan(seed=3, specs=(F.FaultSpec(kind="corrupt"),))
        pauses = []
        ex = BatchExecutor(max_retries=3, fallback=False, backoff_base_s=0.1, backoff_max_s=0.25,
                           clock=lambda: 0.0, sleep=pauses.append)
        ex.register_variants("t0", _family(pats["t0"], faults=always))
        o = ex.execute_resilient(_batch("t0"), x)
        assert not o.ok and pauses == [0.2, 0.25, 0.25]
        assert o.backoff_s == pytest.approx(sum(pauses))
    elif case == "fault-free-equals-execute":
        ex = BatchExecutor()
        ex.register_variants("t0", _family(pats["t0"]))
        b = _batch("t0")
        o = ex.execute_resilient(b, x)
        assert o.ok and o.recovery is None and o.attempts == 1
        assert np.array_equal(o.value, ex.execute(b, x)) and np.array_equal(o.value, refs["t0"])
        with pytest.raises(KeyError):
            ex.execute(_batch("ghost"), x)
    else:
        storm = F.FaultPlan(seed=11, specs=(
            F.FaultSpec(kind="perturb", prob=0.4, frac=0.2, strategies=("two_step",)),
            F.FaultSpec(kind="corrupt", prob=0.15, codecs=("lossy",)),
        ))
        ex = BatchExecutor(health=F.HealthTracker())
        for k, p in pats.items():
            ex.register_variants(k, _family(p, faults=storm))
        names = sorted(pats)
        outs = ex.run_schedule([_batch(names[i % 3], rids=(i,)) for i in range(48)], [x] * 48)
        done = sum(len(o.batch.requests) for o in outs if o.ok)
        assert done / 48 >= 0.99
        assert all(np.array_equal(o.value, refs[o.batch.fp]) for o in outs if o.ok)
        assert any(o.recovery for o in outs)


def test_executor_entry_points_that_wait_or_need_the_card():
    _, part = _spmv_case()
    op = DistributedSpMV(part, strategy="two_step", device="cpu")
    with pytest.raises(ValueError, match="times the card"):
        measure_spmv_replay(op, 4, 2, np.random.default_rng(0))
    with pytest.raises(ValueError, match=">= 1"):
        measure_spmv_replay(op, 0, 2, np.random.default_rng(0))
