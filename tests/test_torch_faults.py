"""The port's fault injection, wire integrity checks and recovery ladder.

The port's twins of ``tests/test_faults.py``'s numpy and ladder cases, run
through the port's own torch executor on the CPU:

* **Determinism** -- the port compiles a seeded :class:`FaultPlan` to the
  reference's masks bitwise, and injections land only on halo slots that
  crossed pods.
* **Lockstep** -- faulted outputs and :class:`ExchangeIntegrityError`
  diagnostics of ``IrregularExchange(verify=True, faults=...)`` (barrier
  and split-phase) equal ``repro.comm.execute_numpy(faults=, verify=True)``'s
  for every strategy and codec; ``verify=True`` alone changes no bit.
* **Recovery** -- retry / demote / re-advise, exhaustion re-raising, the
  health penalty biasing ``advise``, and a CG solve on
  ``DistributedSpMV(device="cpu")`` that recovers from an injected fault
  and names the recovery in its status.
"""

import gc
import time
import weakref

import numpy as np
import pytest
import torch

from repro.comm import exchange as ref_exchange
from repro.comm import faults as RF
from repro.comm.fusion import fuse as ref_fuse
from repro.comm.topology import PodTopology as RefTopology
from repro_torch.comm import IrregularExchange, PodTopology, execute_numpy, random_pattern, split_phase
from repro_torch.comm import faults as F
from repro_torch.core.advisor import EXECUTABLE_STRATEGY, advise
from repro_torch.solve import cg, spd_system
from repro_torch.sparse import DistributedSpMV, partition_csr, thermal_like

ALL_STRATEGIES = ("standard", "two_step", "three_step", "split")
CODECS = ("none", "bf16", "f16", "int8")
TOPO = PodTopology(npods=4, ppn=2)
REF_TOPO = RefTopology(npods=4, ppn=2)
CAP = 256


def _pattern(seed=3, local_size=24):
    return random_pattern(np.random.default_rng(seed), TOPO, local_size)


def _ref_pattern(seed=3, local_size=24):
    return ref_exchange.random_pattern(np.random.default_rng(seed), REF_TOPO, local_size)


def _payload(pat, seed=0, feat=()):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((pat.topo.nranks, pat.local_size) + feat).astype(np.float32)


def _both(kind="corrupt", seed=7, **kw):
    """The same fault plan in both packages."""
    spec_kw = {k: v for k, v in kw.items() if k != "active_calls"}
    calls = kw.get("active_calls")
    return (
        F.FaultPlan(seed=seed, specs=(F.FaultSpec(kind=kind, **spec_kw),), active_calls=calls),
        RF.FaultPlan(seed=seed, specs=(RF.FaultSpec(kind=kind, **spec_kw),), active_calls=calls),
    )


def _exchange(pat, strategy, **kw):
    return IrregularExchange(pat, strategy, device="cpu", message_cap_bytes=CAP, **kw)


def _ref_plan(strategy, ref_pat):
    return ref_fuse(ref_exchange.plan(strategy, ref_pat, message_cap_bytes=CAP))


def _diagnostics(fn):
    with pytest.raises((F.ExchangeIntegrityError, RF.ExchangeIntegrityError)) as ei:
        fn()
    return ei.value.diagnostics()


# ---------------------------------------------------------------------------
# Determinism + confinement
# ---------------------------------------------------------------------------


def test_compiled_faults_match_reference():
    specs = (("corrupt", dict(prob=0.7, frac=0.3)), ("perturb", dict(prob=0.5)), ("zero", dict(prob=0.4)))
    fp = F.FaultPlan(seed=11, specs=tuple(F.FaultSpec(kind=k, **a) for k, a in specs))
    rfp = RF.FaultPlan(seed=11, specs=tuple(RF.FaultSpec(kind=k, **a) for k, a in specs))
    assert fp.fingerprint() == rfp.fingerprint()
    pat, ref = _pattern(), _ref_pattern()
    for strat in ALL_STRATEGIES:
        a = F.compile_faults(_exchange(pat, strat).plan, "bf16", fp)
        b = RF.compile_faults(_ref_plan(strat, ref), "bf16", rfp)
        assert len(a.injections) == len(b.injections) > 0, strat
        for ia, ib in zip(a.injections, b.injections):
            assert (ia.ordinal, ia.op_index, ia.stage_kind, ia.round_index, ia.kind) == (
                ib.ordinal, ib.op_index, ib.stage_kind, ib.round_index, ib.kind
            )
            np.testing.assert_array_equal(ia.value, ib.value)  # nan for corrupt
            np.testing.assert_array_equal(ia.np_mask, ib.np_mask)
            np.testing.assert_array_equal(ia.dev_mask, ib.dev_mask)


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("kind", ["corrupt", "perturb", "zero"])
def test_injection_confined_to_inter_pod_slots(strategy, kind):
    """The faulted torch exchange equals the faulted numpy oracle and
    differs from the clean one only on halo slots from another pod."""
    pat, ref = _pattern(), _ref_pattern()
    x = _payload(pat)
    fp, rfp = _both(kind, seed=5, prob=1.0, frac=1.0)
    ex = _exchange(pat, strategy, faults=fp)
    clean = execute_numpy(ex.plan, x)
    faulted = ex(x).numpy()  # unverified: the corruption is delivered
    np.testing.assert_array_equal(faulted, execute_numpy(ex.plan, x, faults=fp))
    np.testing.assert_array_equal(faulted, ref_exchange.execute_numpy(_ref_plan(strategy, ref), x, faults=rfp))
    diff = ~((faulted == clean) | (np.isnan(faulted) & np.isnan(clean)))
    assert diff.any(), "fault plan with prob=1 must corrupt something"
    assert not (diff & np.asarray(split_phase(pat).from_local)).any(), "on-pod halo data was corrupted"


def test_fault_plan_call_gating_and_spec_filters():
    fp = F.FaultPlan(seed=1, specs=(F.FaultSpec(),), active_calls=(0, 2))
    assert fp.active(0) and fp.active(2) and not fp.active(1)
    assert F.FaultPlan(seed=1, specs=(F.FaultSpec(),)).active(99)
    spec = F.FaultSpec(strategies=("two_step",), codecs=("lossy",))
    assert spec.matches("two_step", "bf16") and spec.matches("two_step", "int8")
    assert not spec.matches("two_step", "none") and not spec.matches("standard", "bf16")
    with pytest.raises(ValueError, match="unknown fault kind"):
        F.FaultSpec(kind="melt")
    with pytest.raises(ValueError, match="at least one"):
        F.FaultPlan(seed=0, specs=())


# ---------------------------------------------------------------------------
# Verification: invisible when clean, lockstep when faulted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", CODECS)
def test_verify_mode_is_bitwise_invisible(wire):
    pat = _pattern()
    for feat in ((), (2,)):
        x = _payload(pat, feat=feat)
        for strat in ALL_STRATEGIES:
            base = _exchange(pat, strat, wire=wire)
            checked = _exchange(pat, strat, wire=wire, verify=True)
            want = execute_numpy(base.plan, x, wire=wire, verify=True)
            np.testing.assert_array_equal(checked(x).numpy(), want, err_msg=(strat, wire))
            np.testing.assert_array_equal(base(x).numpy(), want, err_msg=(strat, wire))
            np.testing.assert_array_equal(
                checked.start(x).finish().numpy(), base.start(x).finish().numpy()
            )
            assert checked.health.failures == {} and checked.last_recovery is None


def test_inactive_fault_call_is_bitwise_clean():
    """A plan gated to call 0 leaves call 1 bitwise clean -- what the retry
    rung relies on -- in the torch executor as in the oracle."""
    pat = _pattern()
    x = torch.from_numpy(_payload(pat))
    fp, _ = _both(active_calls=(0,))
    ex = _exchange(pat, "two_step", wire="bf16", faults=fp)
    clean = execute_numpy(ex.plan, x.numpy(), wire="bf16")
    np.testing.assert_array_equal(ex._raw_call(x, 1).numpy(), clean)
    np.testing.assert_array_equal(
        ex._raw_call(x, 0).numpy(), execute_numpy(ex.plan, x.numpy(), wire="bf16", faults=fp, fault_call=0)
    )
    assert not np.array_equal(ex._raw_call(x, 0).numpy(), clean, equal_nan=True)


@pytest.mark.parametrize("wire", CODECS)
@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_corruption_detected_for_every_strategy_and_codec(strategy, wire):
    """Barrier and split-phase raise the numpy oracles' diagnostics."""
    pat, ref = _pattern(), _ref_pattern()
    x = _payload(pat)
    fp, rfp = _both("corrupt")
    ex = _exchange(pat, strategy, wire=wire, verify=True, faults=fp, max_retries=0, fallback=False)
    got = _diagnostics(lambda: ex(x))
    assert got == _diagnostics(lambda: execute_numpy(ex.plan, x, wire=wire, faults=fp, verify=True))
    assert got == _diagnostics(
        lambda: ref_exchange.execute_numpy(_ref_plan(strategy, ref), x, wire=wire, faults=rfp, verify=True)
    )
    assert got["strategy"] == strategy and got["codec"] == wire and got["hop_class"] == "inter_pod"
    assert got["stage_kind"] in ("a2a_pod", "permute")
    # split-phase: the inter-pod phase's own program, settled in finish()
    handle = ex.start(x)
    remote = ex._two_phase[0]
    split_got = _diagnostics(handle.finish)
    assert split_got == _diagnostics(
        lambda: execute_numpy(remote.plan, x, wire=wire, faults=fp, verify=True)
    )


def test_zero_and_perturb_detected_nan_counted():
    pat = _pattern()
    x = _payload(pat)
    for kind in ("zero", "perturb"):
        fp, _ = _both(kind, seed=3, frac=1.0)
        ex = _exchange(pat, "standard", wire="bf16", verify=True, faults=fp, max_retries=0, fallback=False)
        with pytest.raises(F.ExchangeIntegrityError):
            ex(x)
    fp, _ = _both("corrupt", seed=3)
    ex = _exchange(pat, "standard", verify=True, faults=fp, max_retries=0, fallback=False)
    with pytest.raises(F.ExchangeIntegrityError) as ei:
        ex(x)
    assert ei.value.violation == np.inf


def test_slow_fault_adds_latency_not_values():
    pat = _pattern()
    x = _payload(pat)
    fp, _ = _both("slow", seed=2, delay_s=0.05)
    ex = _exchange(pat, "two_step", verify=True, faults=fp)
    t0 = time.monotonic()
    out = ex(x)  # no raise
    assert time.monotonic() - t0 >= 0.05
    np.testing.assert_array_equal(out.numpy(), execute_numpy(ex.plan, x))


def test_tolerance_scales_with_codec():
    amax, sum_abs, nelem = np.float32(2.0), np.float32(100.0), 64
    drift_ok = float(F.sum_tolerance("bf16", nelem, amax, sum_abs, True)) * 0.5
    pre = (sum_abs, np.float32(0), amax)
    post = (sum_abs + np.float32(drift_ok), np.float32(0), amax)
    assert F.check_violation(pre, post, nelem, "bf16", True) <= 0.0
    assert F.check_violation(pre, post, nelem, "none", False) > 0.0


# ---------------------------------------------------------------------------
# Recovery ladder + health
# ---------------------------------------------------------------------------


class _Watchdog:
    """The watchdog contract the tracker feeds: ``record_external``."""

    def __init__(self):
        self.events = []

    def record_external(self, kind, info):
        self.events.append({"kind": kind, **info})


def test_ladder_retry_recovers_transient_fault():
    pat = _pattern()
    x = _payload(pat)
    fp, _ = _both(active_calls=(0,))
    health = F.HealthTracker()
    ex = _exchange(pat, "two_step", wire="bf16", verify=True, faults=fp, health=health)
    out = ex(x)
    np.testing.assert_array_equal(out.numpy(), execute_numpy(ex.plan, x, wire="bf16"))
    assert ex.last_recovery == "retry:two_step/bf16"
    assert health.failures == {("two_step", "bf16"): 1}
    assert health.recovery_count == 1 and health.last_recovery == ex.last_recovery


def test_ladder_demotes_lossy_codec():
    pat = _pattern()
    x = _payload(pat)
    fp, _ = _both(codecs=("lossy",))
    ex = _exchange(pat, "two_step", wire="bf16", verify=True, faults=fp)
    out = ex(x)
    np.testing.assert_array_equal(out.numpy(), execute_numpy(ex.plan, x))
    assert ex.last_recovery == "demote:two_step/none"
    assert ex.health.is_degraded("two_step", "bf16") and not ex.health.is_degraded("two_step", "none")


def test_ladder_readvises_strategy_and_feeds_watchdog():
    pat = _pattern()
    x = _payload(pat)
    wd = _Watchdog()
    fp, _ = _both(strategies=("two_step",))
    ex = _exchange(pat, "two_step", wire="bf16", verify=True, faults=fp, health=F.HealthTracker(watchdog=wd))
    out = ex(x)
    action, rest = ex.last_recovery.split(":")
    alt = rest.split("/")[0]
    assert action == "readvise" and alt in ALL_STRATEGIES and alt != "two_step"
    np.testing.assert_array_equal(out.numpy(), execute_numpy(_exchange(pat, alt).plan, x))
    assert ex.health.is_degraded("two_step", "bf16") and ex.health.is_degraded("two_step", "none")
    assert len(wd.events) == 3 and all(e["kind"] == "exchange_integrity" for e in wd.events)


def test_ladder_exhaustion_reraises():
    pat = _pattern()
    x = _payload(pat)
    fp, _ = _both()  # fires everywhere
    ex = _exchange(pat, "two_step", wire="bf16", verify=True, faults=fp, fallback=False)
    with pytest.raises(F.ExchangeIntegrityError):
        ex(x)
    assert ex.health.failures == {("two_step", "bf16"): 2}  # the try and its retry
    with pytest.raises(F.ExchangeIntegrityError):
        ex.start(x).finish()


@pytest.mark.parametrize("fails", [1, 3])  # recovered on the retry; exhausted
def test_ladder_leaves_no_reference_cycle(fails):
    """A caught integrity error must not keep the ladder's callers' locals
    alive: they are freed when the call returns, not when the collector runs."""

    class Sentinel:
        pass

    def attempt(strategy, wire):
        calls.append((strategy, wire))
        if len(calls) <= fails:
            raise F.ExchangeIntegrityError(strategy=strategy, codec=wire, stage_kind="a2a_pod", op_index=0)
        return "ok"

    def caller():
        held = Sentinel()  # a local of a frame above the ladder
        try:
            F.run_ladder(attempt, strategy="two_step", wire="none", max_retries=1, fallback=False)
        except F.ExchangeIntegrityError:
            pass
        return weakref.ref(held)

    calls = []
    gc.collect()
    gc.disable()
    try:
        ref = caller()
        alive = ref() is not None
    finally:
        gc.enable()
    assert len(calls) == min(fails + 1, 2)
    assert not alive


def test_health_penalty_biases_advisor():
    pat = _pattern()
    cp = pat.to_comm_pattern()
    clean = advise(cp, machine="lassen")
    health = F.HealthTracker()
    best_clean = EXECUTABLE_STRATEGY[clean.best.strategy]
    health.failures[(best_clean, "none")] = 1
    biased = advise(cp, machine="lassen", health=health)
    assert EXECUTABLE_STRATEGY[biased.best.strategy] != best_clean
    empty = advise(cp, machine="lassen", health=F.HealthTracker())
    assert [r.key for r in empty.ranked] == [r.key for r in clean.ranked]
    assert health.penalty(best_clean, "none") == F.DEGRADED_PENALTY
    assert health.penalty(best_clean, "bf16") == F.SUSPECT_PENALTY
    other = next(s for s in ALL_STRATEGIES if s != best_clean)
    assert health.penalty(other, "none") == 1.0


def test_circuit_breaker_half_opens_and_closes():
    health = F.HealthTracker(cooldown=2)
    err = F.ExchangeIntegrityError(strategy="split", codec="int8", stage_kind="a2a_pod", op_index=1)
    health.record_failure(err)
    assert health.breaker_state("split", "int8") == "open"
    health.record_call()
    health.record_call()
    assert health.breaker_state("split", "int8") == "half_open"
    assert health.record_success("split", "int8")
    assert health.breaker_state("split", "int8") == "closed" and health.penalty("split", "int8") == 1.0


# ---------------------------------------------------------------------------
# Solver resilience through DistributedSpMV
# ---------------------------------------------------------------------------


def _solver_setup(**op_kw):
    rng = np.random.default_rng(0)
    A = spd_system(thermal_like(145, rng))  # 144 rows -> 18 per rank
    part = partition_csr(A, TOPO)
    b = rng.normal(size=(TOPO.nranks, part.rows_per_rank)).astype(np.float32)
    return DistributedSpMV(part, strategy="two_step", device="cpu", **op_kw), b


def test_guarded_halo_matches_reference_execute_numpy():
    """``DistributedSpMV(wire=, verify=, faults=).halo`` is the reference
    oracle's faulted exchange, bitwise."""
    fp, rfp = _both("perturb", seed=4, prob=0.6)
    op, _ = _solver_setup(wire="int8", faults=fp)
    v = _payload(op.partition.pattern, seed=2)
    ref_pat = ref_exchange.ExchangePattern(
        REF_TOPO, op.partition.pattern.local_size,
        tuple(ref_exchange.Need(n.dst, n.src, n.idx) for n in op.partition.pattern.needs),
    )
    want = ref_exchange.execute_numpy(_ref_plan("two_step", ref_pat), v, wire="int8", faults=rfp)
    np.testing.assert_array_equal(op.halo(v).numpy(), want)


def test_solver_histories_unchanged_by_guard_plumbing():
    op_plain, b = _solver_setup()
    op_checked, _ = _solver_setup(verify=True)
    res = cg(op_plain, b, tol=1e-6)
    assert res.converged and res.status == "converged" and res.restarts == 0
    checked = cg(op_checked, b, tol=1e-6)
    assert checked.residuals == res.residuals and checked.status == "converged"


def test_solver_recovers_from_injected_corruption():
    fp, _ = _both("corrupt", seed=11, active_calls=(0,))
    op, b = _solver_setup(wire="bf16", verify=True, faults=fp)
    clean_op, _ = _solver_setup(wire="bf16")
    res = cg(op, b, tol=1e-6)
    assert res.converged
    assert res.status == "converged+exchange:retry:two_step/bf16"
    assert res.residuals == cg(clean_op, b, tol=1e-6).residuals


def test_solver_demotion_path_converges():
    fp, _ = _both(seed=11, codecs=("lossy",))
    op, b = _solver_setup(wire="bf16", verify=True, faults=fp)
    res = cg(op, b, tol=1e-6)
    assert res.converged and res.status.endswith("+exchange:demote:two_step/none")


def test_overlap_guarded_halo_matches_barrier():
    fp, _ = _both(seed=11, active_calls=(0,))
    op, b = _solver_setup(wire="bf16", verify=True, faults=fp, overlap=True)
    res = cg(op, b, tol=1e-6)
    assert res.converged and "+exchange:retry" in res.status
    barrier, _ = _solver_setup(wire="bf16", verify=True, faults=fp)
    assert cg(barrier, b, tol=1e-6).residuals == res.residuals
