"""The port's spans and counters (``repro_torch.tracing``).

Off (no profiler session) nothing is recorded; inside a
``torch.profiler.profile`` session the fused solve, the serving batcher and
executor, the operator and the exchange leave their spans among the
profile's host events, nested as the calls nest, and the counters equal
what the program did, counted by hand.  On the CPU there is no stream to
time, so no interval is kept.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.comm import IrregularExchange, PodTopology, clear_caches
from repro_torch.serving import BatchExecutor, ContinuousBatcher, Request, WorkloadClass
from repro_torch.solve import fused_cg, spd_system
from repro_torch.solve import fused as F
from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like

TOPO = PodTopology(npods=2, ppn=2)
N = 144
FP = "op"
SOLVE_SPANS = ("rhs_norm", "entry", "init", "blocks", "unpack")


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    clear_caches()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    part = partition_csr(spd_system(thermal_like(N, rng)), TOPO)
    op = DistributedSpMV(part, strategy="standard", device="cpu")
    return part, op


def rhs(part, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((TOPO.nranks, part.rows_per_rank)).astype(np.float32))


def serve(part, op, arrivals, now):
    """Submit requests arriving at ``arrivals`` (seconds), take one batch
    at ``now`` and run it through the executor."""
    batcher = ContinuousBatcher({FP: WorkloadClass.from_pattern(part.pattern, fp=FP)}, window=1e-3,
                                max_width=8, strategy=op.strategy)
    executor = BatchExecutor(batcher=batcher)
    executor.register_spmv(FP, op)
    for rid, t in enumerate(arrivals):
        assert batcher.submit(Request(arrival=t, rid=rid, fp=FP))
    batch = batcher.next_batch(now)
    V = torch.randn(TOPO.nranks, part.rows_per_rank, batch.width, generator=torch.Generator().manual_seed(1))
    outcome = executor.execute_resilient(batch, V)
    assert outcome.ok
    return batcher, outcome


def host_spans(prof):
    """``(name, start ns, end ns)`` of the session's ``repro_torch.`` host events."""
    return [(e.name(), int(e.start_ns()), int(e.end_ns())) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.name().startswith("repro_torch.")]


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def named(spans, short):
    return [s for s in spans if s[0] == "repro_torch." + short]


# -- off means off -------------------------------------------------------------


def test_no_session_records_nothing(case):
    part, op = case
    assert not tracing.active()
    assert tracing.span("repro_torch.solve.fused") is tracing.span("repro_torch.serve.batch")
    assert fused_cg(op, rhs(part, 0), tol=1e-6, maxiter=200).converged
    serve(part, op, [0.0, 1e-4], 2e-3)
    local = torch.randn(TOPO.nranks, part.rows_per_rank)
    IrregularExchange(part.pattern, "standard", device="cpu")(local)
    tracing.count("solve.host_reads")
    assert tracing.counters() == {}
    assert tracing.stream_ms("exchange") == []


def test_active_follows_the_session():
    assert not tracing.active()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.active()
    assert not tracing.active()


# -- spans, nested by their times -------------------------------------------------


def test_fused_cg_spans_nest_inside_the_solve(case):
    part, op = case
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fused_cg(op, rhs(part, 1), tol=1e-6, maxiter=200)
    assert res.converged
    spans = host_spans(prof)
    (solve,) = named(spans, "solve.fused")
    starts = []
    for short in SOLVE_SPANS:
        (sp,) = named(spans, "solve." + short)
        assert inside(sp, solve), short
        starts.append(sp[1])
    assert starts == sorted(starts)  # rhs norm, entry, init, blocks, unpack in turn


def test_a_served_batch_nests_operator_and_exchange_inside_execute(case):
    part, op = case
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(part, op, [0.0, 2e-4, 5e-4], 2e-3)
    spans = host_spans(prof)
    (batch,) = named(spans, "serve.batch")
    (execute,) = named(spans, "serve.execute")
    (matmat,) = named(spans, "spmv.matmat")
    (exchange,) = named(spans, "exchange.run")
    (compute,) = named(spans, "spmv.compute")
    assert batch[2] <= execute[1]
    assert inside(matmat, execute)
    assert inside(exchange, matmat) and inside(compute, matmat)
    assert exchange[2] <= compute[1]


def test_a_matvec_nests_exchange_and_compute(case):
    part, op = case
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op(rhs(part, 2))
    spans = host_spans(prof)
    (matvec,) = named(spans, "spmv.matvec")
    assert [s[0] for s in spans if inside(s, matvec) and s != matvec] == [
        "repro_torch.exchange.run", "repro_torch.spmv.compute"]


# -- counters equal hand counts -------------------------------------------------------


@pytest.mark.parametrize("solves", [1, 3])
def test_solve_counters_equal_the_solver_s_own(case, solves):
    part, op = case
    reads = 0
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in range(solves):
            assert fused_cg(op, rhs(part, 10 + seed), tol=1e-6, maxiter=200).converged
            reads += F.host_reads
    assert tracing.counters() == {"solve.host_reads": reads}
    assert reads > solves


@pytest.mark.parametrize("arrivals,now", [([0.0, 2e-4, 5e-4], 2e-3), ([1.0], 1.5), ([0.0] * 9, 1e-4)])
def test_serving_counters_equal_the_known_waits(case, arrivals, now):
    part, op = case
    with profile(activities=[ProfilerActivity.CPU]):
        _, outcome = serve(part, op, arrivals, now)
    width = min(len(arrivals), 8)  # a full lane goes before its window ends
    got = tracing.counters()
    assert set(got) == {"serve.queue_wait_s"} and width == outcome.batch.width
    assert got["serve.queue_wait_s"] == pytest.approx(sum(now - t for t in arrivals[:width]), rel=1e-12)


def test_polling_an_unripe_lane_records_nothing(case):
    part, _ = case
    batcher = ContinuousBatcher({FP: WorkloadClass.from_pattern(part.pattern, fp=FP)}, window=1e-3)
    batcher.submit(Request(arrival=0.0, rid=0, fp=FP))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert batcher.next_batch(1e-4) is None
    assert tracing.counters() == {} and named(host_spans(prof), "serve.batch") == []


def test_stream_intervals_are_empty_on_the_cpu(case):
    part, op = case
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.stream_interval("exchange", torch.device("cpu")):
            serve(part, op, [0.0], 2e-3)
    assert tracing.stream_ms("exchange") == []
    assert set(tracing.counters()) == {"serve.queue_wait_s"}


@pytest.mark.parametrize("between", ["read", "untraced solve"])
def test_a_second_session_counts_only_its_own_solves(case, between):
    part, op = case
    with profile(activities=[ProfilerActivity.CPU]):
        fused_cg(op, rhs(part, 20), tol=1e-6, maxiter=200)
        fused_cg(op, rhs(part, 21), tol=1e-6, maxiter=200)
    if between == "read":
        assert tracing.counters()["solve.host_reads"] > 0
    else:
        fused_cg(op, rhs(part, 22), tol=1e-6, maxiter=200)
    with profile(activities=[ProfilerActivity.CPU]):
        fused_cg(op, rhs(part, 23), tol=1e-6, maxiter=200)
        reads = F.host_reads
    assert tracing.counters() == {"solve.host_reads": reads}
    assert tracing.counters() == {"solve.host_reads": reads}  # a read after the session keeps it


def test_a_second_session_counts_only_its_own_waits(case):
    part, op = case
    with profile(activities=[ProfilerActivity.CPU]):
        serve(part, op, [0.0, 1e-4], 2e-3)
    assert tracing.counters()["serve.queue_wait_s"] == pytest.approx(3.9e-3, rel=1e-12)
    with profile(activities=[ProfilerActivity.CPU]):
        serve(part, op, [1.0], 1.5)
    assert tracing.counters() == {"serve.queue_wait_s": pytest.approx(0.5, rel=1e-12)}


def test_reset_clears_everything(case):
    part, op = case
    with profile(activities=[ProfilerActivity.CPU]):
        fused_cg(op, rhs(part, 4), tol=1e-6, maxiter=200)
        tracing.count("extra", 2.5)
    assert tracing.counters()["extra"] == 2.5
    tracing.reset()
    assert tracing.counters() == {} and tracing.stream_ms("exchange") == []


# -- on the card ----------------------------------------------------------------------


@pytest.mark.cuda
def test_on_the_card_the_exchange_is_timed_and_the_graphs_counted():
    """A traced fused CG replays graphs and holds no interval (its exchange
    is captured); a traced ``matmat`` keeps one exchange interval each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode (run this file on the GPU)")
    part = partition_csr(spd_system(thermal_like(N, np.random.default_rng(3))), TOPO)
    op = DistributedSpMV(part, strategy="standard", device="cuda")
    b = rhs(part, 5).cuda()
    V = torch.randn(TOPO.nranks, part.rows_per_rank, 3, device="cuda")
    fused_cg(op, b, tol=1e-6, maxiter=200)
    op.matmat(V)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert fused_cg(op, b, tol=1e-6, maxiter=200).converged
        reads = F.host_reads
        assert tracing.counters() == {"solve.host_reads": reads}
        assert F.graph_launches["spmv_ell"] > 0 and tracing.stream_ms("exchange") == []
        for _ in range(3):
            op.matmat(V)
        assert len(tracing.stream_ms("exchange")) == 3
        for _ in range(2 * tracing._HARVEST):  # finished intervals are read back as the session goes
            op.matmat(V)
            torch.cuda.synchronize()
            assert len(tracing._pending) <= tracing._HARVEST + 1
    ms = tracing.stream_ms("exchange")
    assert len(ms) == 3 + 2 * tracing._HARVEST and all(m > 0 for m in ms)
