"""The port's planning and exchange layers against the JAX package's.

Planning must match bitwise: the port's copies of the planners and the
fusion pass give the same stage types, index arrays and fingerprints as
``repro.comm``.  The port's torch executor (on the CPU here) must deliver
exactly what ``repro.comm.execute_numpy`` and ``merge_split_phase``
deliver, for barrier and split-phase calls and for scalar and batched
payloads.
"""

import numpy as np
import pytest
import torch

from repro.comm import exchange as ref_exchange
from repro.comm.fusion import fuse as ref_fuse
from repro.comm.topology import PodTopology as RefTopology
from repro_torch.comm import (
    STRATEGY_NAMES,
    IrregularExchange,
    PodTopology,
    cache_sizes,
    cache_stats,
    clear_caches,
    execute_numpy,
    fuse,
    plan,
    random_pattern,
    set_cache_limits,
    split_phase,
)

TOPO = PodTopology(npods=2, ppn=4)
REF_TOPO = RefTopology(npods=2, ppn=4)
SEEDS = (0, 1, 2)
CAP = 48


def _patterns(seed):
    """The same random pattern built by both packages from one seed."""
    port = random_pattern(np.random.default_rng(seed), TOPO, local_size=7, p_connect=0.6, max_elems=5)
    ref = ref_exchange.random_pattern(
        np.random.default_rng(seed), REF_TOPO, local_size=7, p_connect=0.6, max_elems=5
    )
    return port, ref


def _plan_pair(seed, strategy, fused):
    port, ref = _patterns(seed)
    if strategy == "local":
        port, ref = split_phase(port).local, ref_exchange.split_phase(ref).local
    p = plan(strategy, port, message_cap_bytes=CAP)
    r = ref_exchange.plan(strategy, ref, message_cap_bytes=CAP)
    if fused:
        p, r = fuse(p), ref_fuse(r)
    return p, r


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("strategy", STRATEGY_NAMES + ("local",))
@pytest.mark.parametrize("seed", SEEDS)
def test_plans_match_reference(seed, strategy, fused):
    p, r = _plan_pair(seed, strategy, fused)
    assert p.pattern.fingerprint() == r.pattern.fingerprint()
    for field in (
        "strategy", "out_size", "intra_pod_bytes", "inter_pod_bytes",
        "wire_intra_pod_bytes", "wire_inter_pod_bytes", "fused",
    ):
        assert getattr(p, field) == getattr(r, field), field
    assert [type(s).__name__ for s in p.stages] == [type(s).__name__ for s in r.stages]
    for ps, rs in zip(p.stages, r.stages):
        name = type(ps).__name__
        if name == "Gather":
            assert _same(ps.idx, rs.idx)
        elif name in ("A2ALocal", "A2APod"):
            assert ps.buflen == rs.buflen and _same(ps.idx, rs.idx)
        else:
            assert (ps.rounds, ps.blks, ps.inter) == (rs.rounds, rs.blks, rs.inter)
            assert all(_same(a, b) for a, b in zip(ps.sels, rs.sels))
            assert len(ps.sels) == len(rs.sels)


@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("seed", SEEDS)
def test_vectorized_planner_matches_legacy_planner(seed, strategy):
    """The port's copy of the token-list planner (its plan oracle, as in
    ``tests/test_fusion.py``) builds the vectorized planner's program, and
    the token simulator delivers every rank its canonical receive layout."""
    from repro_torch.comm import _legacy_planner as legacy
    from repro_torch.comm.exchange import simulate

    port, _ = _patterns(seed)
    p = plan(strategy, port, message_cap_bytes=CAP)
    q = legacy.plan(strategy, port, message_cap_bytes=CAP)
    for field in ("out_size", "intra_pod_bytes", "inter_pod_bytes", "wire_intra_pod_bytes",
                  "wire_inter_pod_bytes"):
        assert getattr(p, field) == getattr(q, field), field
    assert [type(s).__name__ for s in p.stages] == [type(s).__name__ for s in q.stages]
    for ps, qs in zip(p.stages, q.stages):
        for name in ("idx", "buflen", "rounds", "blks"):
            if hasattr(ps, name):
                assert _same(getattr(ps, name), getattr(qs, name)) if name == "idx" else (
                    getattr(ps, name) == getattr(qs, name)
                ), name
    got = simulate(p)
    for r in range(TOPO.nranks):
        assert got[r][: len(port.canonical_tokens(r))] == port.canonical_tokens(r)


@pytest.mark.parametrize("feat", [(), (3,)], ids=["vector", "batched"])
@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("seed", SEEDS)
def test_exchange_matches_reference_numpy(seed, strategy, feat):
    port, ref = _patterns(seed)
    local = np.random.default_rng(seed + 100).normal(size=(TOPO.nranks, 7) + feat).astype(np.float32)
    ex = IrregularExchange(port, strategy, device="cpu", message_cap_bytes=CAP)
    ref_plan = ref_fuse(ref_exchange.plan(strategy, ref, message_cap_bytes=CAP))
    want = ref_exchange.execute_numpy(ref_plan, local)
    barrier = ex(local)
    assert barrier.dtype == torch.float32
    np.testing.assert_array_equal(barrier.numpy(), want)
    # the port's own numpy oracle agrees too
    np.testing.assert_array_equal(execute_numpy(ex.plan, local), want)
    # split-phase: the reference merge of the reference phases, bitwise
    sp = ref_exchange.split_phase(ref)
    merged = ref_exchange.merge_split_phase(
        sp,
        ref_exchange.execute_numpy(ref_exchange.plan("local", sp.local), local),
        ref_exchange.execute_numpy(ref_exchange.plan(strategy, sp.remote, message_cap_bytes=CAP), local),
    )
    handle = ex.start(torch.as_tensor(local))
    np.testing.assert_array_equal(handle.finish().numpy(), merged)
    np.testing.assert_array_equal(merged, want)
    H = ref.max_recv_size()
    np.testing.assert_array_equal(barrier.numpy()[:, :H], ref.reference(local))


@pytest.mark.parametrize("unfused", [False, True])
def test_exchange_integer_payload_and_unfused(unfused):
    port, ref = _patterns(5)
    local = np.arange(TOPO.nranks * 7 * 2, dtype=np.int64).reshape(TOPO.nranks, 7, 2)
    for strategy in STRATEGY_NAMES:
        ex = IrregularExchange(port, strategy, device="cpu", fuse_program=not unfused)
        want = ref_exchange.execute_numpy(ref_exchange.plan(strategy, ref), local)
        np.testing.assert_array_equal(ex(local).numpy(), want)


def test_one_plan_per_pattern():
    clear_caches()
    port, _ = _patterns(7)
    local = np.ones((TOPO.nranks, 7), np.float32)
    a = IrregularExchange(port, "split", device="cpu")
    b = IrregularExchange(port, "split", device="cpu")
    for _ in range(3):
        a(local)
        b(local[..., None])  # a new payload width needs no new plan
    s = cache_stats()
    assert (s.plan_misses, s.plan_hits, s.exec_misses, s.exec_hits) == (1, 1, 1, 1), s
    a.start(local).finish()
    a.start(local).finish()
    s = cache_stats()
    # one decomposition, one plan per phase, reused by the second start()
    assert (s.split_misses, s.split_hits, s.plan_misses) == (1, 0, 3), s
    assert cache_sizes()["plan"] == 3
    clear_caches()
    assert cache_stats().plan_misses == 0 and cache_sizes()["plan"] == 0


def test_cache_limits_evict_oldest():
    clear_caches()
    try:
        set_cache_limits(plan=2)
        for seed in (0, 1, 2):
            IrregularExchange(_patterns(seed)[0], "standard", device="cpu")
        s = cache_stats()
        assert s.plan_misses == 3 and s.plan_evictions == 1 and cache_sizes()["plan"] == 2
        with pytest.raises(ValueError):
            set_cache_limits(plan=0)
    finally:
        set_cache_limits(plan=256, exec_=64)
        clear_caches()


@pytest.mark.parametrize(
    "kw", [{"wire": "bf16"}, {"verify": True}, {"faults": "plan"}, {"health": "tracker"}],
    ids=["wire", "verify", "faults", "health"],
)
def test_later_slices_raise(kw):
    """What raised until the faults/verify/codecs slice (ROADMAP A.1) now
    runs, and delivers what the reference's ``execute_numpy`` delivers
    with the same codec, checks and (perturbing) faults, bitwise."""
    from repro.comm import faults as ref_faults
    from repro_torch.comm import FaultPlan, FaultSpec, HealthTracker

    port, ref = _patterns(0)
    ref_kw = dict(kw)
    if "faults" in kw:
        kw = {"faults": FaultPlan(seed=2, specs=(FaultSpec(kind="perturb", prob=0.7),))}
        ref_kw = {"faults": ref_faults.FaultPlan(seed=2, specs=(ref_faults.FaultSpec(kind="perturb", prob=0.7),))}
    if "health" in kw:
        kw = {"health": HealthTracker()}
        ref_kw = {}
    ex = IrregularExchange(port, "two_step", device="cpu", message_cap_bytes=CAP, **kw)
    local = np.random.default_rng(4).normal(size=(TOPO.nranks, 7)).astype(np.float32)
    want = ref_exchange.execute_numpy(
        ref_fuse(ref_exchange.plan("two_step", ref, message_cap_bytes=CAP)), local, **ref_kw
    )
    np.testing.assert_array_equal(ex(local).numpy(), want)
    np.testing.assert_array_equal(execute_numpy(ex.plan, local, **kw if "health" not in kw else {}), want)
    if "health" in kw:
        assert ex.health is kw["health"]


def test_bad_payload_shape_raises():
    port, _ = _patterns(0)
    ex = IrregularExchange(port, "two_step", device="cpu")
    with pytest.raises(ValueError):
        ex(np.ones((TOPO.nranks, 6), np.float32))
