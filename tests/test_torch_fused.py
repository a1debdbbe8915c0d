"""The port's whole-solve CG/BiCGStab (``repro_torch.solve.fused``).

On the CPU the fused solvers run their init and block functions eagerly --
the same device program a CUDA graph captures on the card.  They are held

* to the port's own host loops (``repro_torch.solve.krylov``): the same
  iterations, status, matvecs and restarts, and residual histories and
  solutions that are bitwise equal (the same float64 scalars from the same
  ops in the same order);
* to the reference's ``fused_cg`` / ``fused_bicgstab`` (one subprocess on 8
  forced host devices runs every reference case): within the reference's own
  host-vs-fused tolerances, 1e-5 (CG) and 1e-2 (BiCGStab), since the
  reference carries float32 scalars in its loop;
* to the reference's ``tests/test_fused.py`` contract: exit paths, codecs,
  integrity errors, cache accounting, checkpoint/resume (held to the port's
  clean solve and to the numpy oracle: the reference's device resume test is
  red, ROADMAP §C caveat 1).
"""

import json
import math

import numpy as np
import pytest
import torch

from conftest import run_devices
from repro_torch.comm import (
    STRATEGY_NAMES,
    ExchangeIntegrityError,
    FaultPlan,
    FaultSpec,
    PodTopology,
    cache_sizes,
    cache_stats,
    clear_caches,
    set_cache_limits,
)
from repro_torch.comm import strategies as comm_strategies
from repro_torch.solve import (
    FUSED_SOLVERS,
    NumpySpMV,
    bicgstab,
    cg,
    fused_bicgstab,
    fused_cg,
    shifted_system,
    spd_system,
)
from repro_torch.solve import fused as F
from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like
from repro_torch.testing import make_trace

TOPO = PodTopology(npods=2, ppn=4)
N = 256
HOST = {"cg": cg, "bicgstab": bicgstab}
MAKE = {"cg": spd_system, "bicgstab": shifted_system}


def _system(solver="cg", seed=0):
    rng = np.random.default_rng(seed)
    A = MAKE[solver](thermal_like(N, rng))
    part = partition_csr(A, TOPO)
    b = rng.standard_normal((TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    return A, part, b


def _op(part, **kw):
    return DistributedSpMV(part, device="cpu", **{"strategy": "two_step", **kw})


def _same(f, h):
    """The fused result is the host loop's, bitwise."""
    assert (f.status, f.iterations, f.matvecs, f.restarts) == (
        h.status, h.iterations, h.matvecs, h.restarts)
    assert f.residuals == h.residuals
    assert torch.equal(f.x, h.x)


# ---------------------------------------------------------------------------
# against the port's host loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "split"])
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_fused_equals_host_loop(solver, strategy, overlap):
    _, part, b = _system(solver)
    op = _op(part, strategy=strategy, overlap=overlap)
    f = FUSED_SOLVERS[solver](op, b, tol=1e-6, maxiter=200)
    h = HOST[solver](op, b, tol=1e-6, maxiter=200)
    assert f.converged
    _same(f, h)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_fused_histories_bitwise_across_strategies_and_overlap(solver):
    _, part, b = _system(solver, seed=3)
    ref = None
    for strategy in STRATEGY_NAMES:
        for overlap in (False, True):
            r = FUSED_SOLVERS[solver](_op(part, strategy=strategy, overlap=overlap), b,
                                      tol=1e-6, maxiter=200)
            ref = ref or r
            assert r.residuals == ref.residuals, (strategy, overlap)
            assert torch.equal(r.x, ref.x)


@pytest.mark.parametrize("codec", ["none", "bf16", "f16", "int8"])
def test_fused_codecs_equal_host_loop(codec):
    """A fixed horizon (tol below reach) with each wire codec: the fused
    solve is the host loop's with the same codec, bitwise."""
    _, part, b = _system()
    op = _op(part, wire=codec)
    f = fused_cg(op, b, tol=1e-12, maxiter=12)
    h = cg(op, b, tol=1e-12, maxiter=12)
    assert f.iterations == 12 and f.status == "maxiter"
    _same(f, h)


def test_fused_exit_paths_equal_host_loop():
    # stagnation + restart: CG on a nonsymmetric (diagonally dominant) matrix
    rng = np.random.default_rng(0)
    A = shifted_system(thermal_like(N, rng))
    part = partition_csr(A, TOPO)
    b = rng.standard_normal((TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    op = _op(part, strategy="standard")
    h, f = cg(op, b, tol=1e-10, maxiter=400), fused_cg(op, b, tol=1e-10, maxiter=400)
    assert f.status == "stagnation+restart" and len(f.residuals) == f.iterations + 2
    _same(f, h)
    # indefinite breakdown: half the diagonal of an SPD system flipped
    S = spd_system(thermal_like(N, rng))
    rows = np.repeat(np.arange(S.n), np.diff(S.indptr))
    S.data[np.flatnonzero((rows == S.indices) & (rows % 2 == 0))] *= -1.0
    parti = partition_csr(S, TOPO)
    bi = rng.standard_normal((TOPO.nranks, parti.rows_per_rank)).astype(np.float32)
    hi, fi = cg(_op(parti), bi, tol=1e-8, maxiter=50), fused_cg(_op(parti), bi, tol=1e-8, maxiter=50)
    assert fi.status == "breakdown:indefinite" and torch.isfinite(fi.x).all()
    _same(fi, hi)
    # warm start from the solution: no iteration, the one true-residual matvec
    _, partg, bg = _system(seed=4)
    opg = _op(partg)
    for hs, fs in ((cg, fused_cg), (bicgstab, fused_bicgstab)):
        exact = hs(opg, bg, tol=1e-6, maxiter=200)
        warm = fs(opg, bg, x0=exact.x, tol=1e-6, maxiter=200)
        assert warm.converged and warm.iterations == 0 and warm.matvecs == 1
        _same(warm, hs(opg, bg, x0=exact.x, tol=1e-6, maxiter=200))


def test_fused_maxiter_and_private_eager_body(monkeypatch):
    _, part, b = _system()
    op = _op(part)
    for maxiter in (0, 1, F.U - 1, F.U, F.U + 1):
        f = fused_cg(op, b, tol=1e-9, maxiter=maxiter)
        _same(f, cg(op, b, tol=1e-9, maxiter=maxiter))
    # the private switch and other block sizes run the same program
    ref = fused_cg(op, b, tol=1e-6, maxiter=200)
    _same(F._fused_solve(op, b, None, 1e-6, 200, None, "cg", capture=False), ref)
    for block in (5, 8):
        monkeypatch.setattr(F, "U", block)
        _same(fused_cg(op, b, tol=1e-6, maxiter=200), ref)
        assert comm_strategies._FUSED_CACHE[next(reversed(comm_strategies._FUSED_CACHE))].block == block


def test_fused_zero_rhs_and_validation():
    _, part, _ = _system()
    op = _op(part)
    z = np.zeros((TOPO.nranks, part.rows_per_rank), np.float32)
    for solver in (fused_cg, fused_bicgstab):
        r = solver(op, z)
        assert r.converged and r.iterations == 0 and r.matvecs == 0
        assert r.residuals == (0.0,) and r.status == "converged" and r.restarts == 0
    with pytest.raises(ValueError, match="b must be"):
        fused_cg(op, np.zeros((TOPO.nranks, part.rows_per_rank + 1), np.float32))
    with pytest.raises(ValueError, match="checkpoint_every"):
        fused_cg(op, z + 1, checkpoint_every=0)


def test_one_plan_miss_one_fused_miss_then_a_hit():
    _, part, b = _system()
    clear_caches()
    op = _op(part)
    f = fused_cg(op, b, tol=1e-6, maxiter=200)
    s = cache_stats()
    assert s.plan_misses == 1 and (s.fused_misses, s.fused_hits) == (1, 0)
    f2 = fused_cg(op, b, tol=1e-6, maxiter=200)
    s = cache_stats()
    assert s.plan_misses == 1 and (s.fused_misses, s.fused_hits) == (1, 1)
    assert f2.residuals == f.residuals
    assert cache_sizes()["fused"] == 1


def test_host_reads_per_solve_are_bounded():
    _, part, b = _system()
    op = _op(part)
    f = fused_cg(op, b, tol=1e-6, maxiter=200)
    assert F.host_reads <= math.ceil(f.iterations / F.U) + F.HOST_READ_SLACK
    # a restart stays within the bound too
    rng = np.random.default_rng(0)
    A = shifted_system(thermal_like(N, rng))
    partn = partition_csr(A, TOPO)
    bn = rng.standard_normal((TOPO.nranks, partn.rows_per_rank)).astype(np.float32)
    f = fused_cg(_op(partn, strategy="standard"), bn, tol=1e-10, maxiter=400)
    assert f.restarts == 1
    assert F.host_reads <= math.ceil(f.iterations / F.U) + F.HOST_READ_SLACK
    assert F.graph_launches == {"spmv_ell": 0}  # nothing is captured on the CPU


def test_operators_on_one_pattern_solve_their_own_systems():
    """Two operators with the same sparsity (equal pattern fingerprints) and
    different values: each fused solve is its own host loop's, never the
    other operator's cached solve."""
    A, part, b = _system()
    scaled = dataclasses_replace_data(A, 2.0)
    part2 = partition_csr(scaled, TOPO)
    assert part2.pattern.fingerprint() == part.pattern.fingerprint()
    op1, op2 = _op(part), _op(part2)
    f1, f2 = fused_cg(op1, b, tol=1e-6, maxiter=200), fused_cg(op2, b, tol=1e-6, maxiter=200)
    _same(f1, cg(op1, b, tol=1e-6, maxiter=200))
    _same(f2, cg(op2, b, tol=1e-6, maxiter=200))
    assert not torch.equal(f1.x, f2.x)
    # the entries keep their operators (and so the blocks their graphs read)
    held = {id(e.op) for e in comm_strategies._FUSED_CACHE.values()}
    assert {id(op1), id(op2)} <= held


def dataclasses_replace_data(A, factor):
    import dataclasses

    return dataclasses.replace(A, data=(A.data * factor).astype(A.data.dtype))


def test_integrity_error_fields_equal_host_loop():
    _, part, b = _system()
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),))

    def provoke(solver, overlap):
        op = _op(part, verify=True, faults=fp, overlap=overlap)
        op.exchange.max_retries, op.exchange.fallback = 0, False
        if overlap:
            op.exchange.start(torch.as_tensor(b))  # builds the inter-pod sub-exchange
            sub = op.exchange._two_phase[0]
            sub.max_retries, sub.fallback = 0, False
        with pytest.raises(ExchangeIntegrityError) as e:
            solver(op, b, tol=1e-6, maxiter=10)
        return e.value

    for overlap in (False, True):
        host, fused = provoke(cg, overlap), provoke(fused_cg, overlap)
        for field in ("strategy", "codec", "stage_kind", "op_index", "round_index", "hop_class"):
            assert getattr(host, field) == getattr(fused, field), (overlap, field)
        assert fused.violation > 0


@pytest.mark.parametrize("solver,call", [("cg", 7), ("bicgstab", 9)])
def test_checkpoint_resume_equals_clean_solve(solver, call):
    _, part, b = _system(solver)
    fsolve = FUSED_SOLVERS[solver]
    clean = fsolve(_op(part, verify=True), b, tol=1e-6, maxiter=200)
    armed = fsolve(_op(part, verify=True), b, tol=1e-6, maxiter=200, checkpoint_every=4)
    _same(armed, clean)
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0,
                                            strategies=("two_step",)),), active_calls=(call,))
    res = fsolve(_op(part, verify=True, faults=fp), b, tol=1e-6, maxiter=200, checkpoint_every=4)
    assert res.status.startswith(clean.status + "+resume:1"), res.status
    assert res.iterations == clean.iterations
    assert res.residuals == clean.residuals
    assert torch.equal(res.x, clean.x)
    assert res.matvecs <= clean.matvecs + 2 * 4 + 1


def test_resume_on_numpy_operator_meets_the_numpy_oracle():
    A, part, b = _system()
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0,
                                            strategies=("two_step",)),), active_calls=(7,))
    op = NumpySpMV(part, strategy="two_step", verify=True, faults=fp)
    res = fused_cg(op, b, tol=1e-6, maxiter=200, checkpoint_every=4, device="cpu")
    oracle = cg(NumpySpMV(part, strategy="two_step"), b, tol=1e-6, maxiter=200)
    assert res.status.startswith("converged+resume:1") and oracle.status == "converged"
    assert res.iterations == oracle.iterations
    # numpy's pairwise row sums and float64 tree vs the kernel's fmaf chain
    assert max(abs(a - c) / c for a, c in zip(res.residuals, oracle.residuals)) < 1e-10
    x = res.x.numpy().reshape(-1).astype(np.float64)
    true = np.linalg.norm(b.reshape(-1) - A.spmv(x)) / np.linalg.norm(b)
    assert true < 1e-5


def test_resume_ladder_exhausted_falls_back_to_host_loop():
    """The fused ladder resumes into the faulted call twice and is out of
    rungs (no fallback); the host loop takes over from the checkpoint, and
    its own exchange ladder retries past the fault."""
    A, part, b = _system()
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),),
                   active_calls=(6,))
    op = NumpySpMV(part, strategy="two_step", verify=True, faults=fp, max_retries=1,
                   fallback=False)
    res = fused_cg(op, b, tol=1e-6, maxiter=200, checkpoint_every=4, device="cpu")
    assert res.status == "converged+resume:1+exchange:retry:two_step/none", res.status
    clean = fused_cg(NumpySpMV(part, strategy="two_step"), b, tol=1e-6, maxiter=200, device="cpu")
    assert abs(res.iterations - clean.iterations) <= 1
    assert res.residuals[:5] == clean.residuals[:5]  # the checkpoint's prefix
    x = res.x.numpy().reshape(-1).astype(np.float64)
    assert np.linalg.norm(b.reshape(-1) - A.spmv(x)) / np.linalg.norm(b) < 1e-5


def test_exhausted_ladder_continues_on_the_solves_device():
    """Every rung resumes into the faulted call, so the ladder is exhausted;
    a ``NumpySpMV`` lowered onto the solve's device goes on there as the
    ``DistributedSpMV`` of its partition and settings, and so equals the
    same solve on a ``DistributedSpMV``, bitwise."""
    A, part, b = _system()
    fp = FaultPlan(seed=5, specs=(FaultSpec(kind="perturb", prob=1.0, frac=1.0),), active_calls=(6,))
    lowered = fused_cg(NumpySpMV(part, strategy="two_step", verify=True, faults=fp), b, tol=1e-6,
                       maxiter=200, checkpoint_every=4, device="cpu")
    dist = _op(part, verify=True, faults=fp)
    own = fused_cg(dist, b, tol=1e-6, maxiter=200, checkpoint_every=4)
    assert lowered.status.startswith("converged+resume:1"), lowered.status
    assert lowered.x.device == torch.device("cpu")
    _same(lowered, own)
    x = lowered.x.numpy().reshape(-1).astype(np.float64)
    assert np.linalg.norm(b.reshape(-1) - A.spmv(x)) / np.linalg.norm(b) < 1e-5
    # the continuation's operator keeps the settings and the ladder
    nop = NumpySpMV(part, strategy="split", overlap=True, wire="int8", verify=True, faults=fp,
                    max_retries=2, fallback=False)
    dop = F._on_device(nop, torch.device("cpu"))
    assert isinstance(dop, DistributedSpMV) and dop.device == torch.device("cpu")
    assert (dop.strategy, dop.overlap, dop.wire, dop.verify, dop.faults, dop.health) == (
        "split", True, "int8", True, fp, nop.health)
    assert (dop.exchange.max_retries, dop.exchange.fallback) == (2, False)
    assert F._on_device(dist, torch.device("cpu")) is dist


def test_fused_cache_pressure_under_skewed_stream():
    """The fused cache under a Zipf-skewed stream, as the reference's
    ``test_perf_smoke.py`` pins it: LRU at capacity, ``evictions == misses -
    live``, an immediate trim on a smaller cap."""
    clear_caches()
    old = comm_strategies.FUSED_CACHE_MAX
    try:
        set_cache_limits(fused=4)
        for req in make_trace(7, 200, [f"fp{i}" for i in range(10)], skew=1.5):
            comm_strategies.fused_cached(("fused", "cg", req.fp), object)
        stats, live = cache_stats(), cache_sizes()
        assert live["fused"] == 4
        assert stats.fused_hits + stats.fused_misses == 200
        assert stats.fused_hits / 200 >= 0.5
        assert stats.fused_evictions == stats.fused_misses - 4 > 0
        assert set_cache_limits(fused=2)["fused"] == 2
        assert cache_sizes()["fused"] == 2
        assert cache_stats().fused_evictions == stats.fused_evictions + 2
        with pytest.raises(ValueError):
            set_cache_limits(fused=0)
    finally:
        set_cache_limits(fused=old)
        clear_caches()
    assert cache_stats().fused_evictions == cache_stats().fused_misses == 0


# ---------------------------------------------------------------------------
# against the reference's fused solvers
# ---------------------------------------------------------------------------

#: (solver, strategy, overlap, seed) -- every case runs in one subprocess
REF_CASES = [
    ("cg", "two_step", False, 0),
    ("cg", "split", True, 1),
    ("bicgstab", "two_step", False, 0),
    ("bicgstab", "three_step", True, 2),
]
#: the reference's own host-vs-fused tolerances (tests/test_fused.py)
REF_TOL = {"cg": 1e-5, "bicgstab": 1e-2}


@pytest.fixture(scope="module")
def reference_runs():
    out = run_devices(
        f"""
        import json
        import numpy as np
        from repro.comm import PodTopology
        from repro.solve import fused_bicgstab, fused_cg, shifted_system, spd_system
        from repro.sparse import build, thermal_like

        topo = PodTopology(npods=2, ppn=4)
        runs = []
        for solver, strategy, overlap, seed in {REF_CASES!r}:
            rng = np.random.default_rng(seed)
            make = spd_system if solver == "cg" else shifted_system
            A = make(thermal_like({N}, rng))
            op = build(A, topo, strategy=strategy, overlap=overlap)
            b = rng.standard_normal((topo.nranks, op.rows_per_rank)).astype(np.float32)
            fused = fused_cg if solver == "cg" else fused_bicgstab
            r = fused(op, b, tol=1e-6, maxiter=200)
            runs.append(dict(status=r.status, iterations=r.iterations, matvecs=r.matvecs,
                             residuals=list(r.residuals), x=np.asarray(r.x).ravel().tolist()))
        print("JSON" + json.dumps(runs))
        """,
        devices=8,
    )
    line = next(ln for ln in out.splitlines() if ln.startswith("JSON"))
    return json.loads(line[4:])


@pytest.mark.parametrize("case", range(len(REF_CASES)),
                         ids=["-".join(map(str, c[:3])) for c in REF_CASES])
def test_fused_matches_reference_fused(reference_runs, case):
    solver, strategy, overlap, seed = REF_CASES[case]
    want = reference_runs[case]
    _, part, b = _system(solver, seed)
    got = FUSED_SOLVERS[solver](_op(part, strategy=strategy, overlap=overlap), b,
                                tol=1e-6, maxiter=200)
    assert got.status == want["status"]
    # the two operators round a row's sum in different orders, so the
    # solves may end one iteration apart (as the host loops do)
    assert abs(got.iterations - want["iterations"]) <= 1
    common = min(len(got.residuals), len(want["residuals"]))
    rel = max(abs(a - c) / max(abs(c), 1e-30)
              for a, c in zip(got.residuals[:common], want["residuals"][:common]))
    assert rel < REF_TOL[solver], rel
    np.testing.assert_allclose(got.x.numpy().ravel(), want["x"], rtol=1e-4, atol=1e-4)
