"""Deterministic fault injection, wire integrity checks, and self-healing.

The paper's closing discussion argues strategy *choice* must survive real
machines: inter-node links degrade, lossy wire formats misbehave, and one
corrupted DCI payload can silently poison a whole solve.  This module gives
the exchange stack three things:

* **Injection** -- a seeded :class:`FaultPlan` compiled against a concrete
  :class:`~repro_torch.comm.exchange.StagePlan` into per-hop boolean masks over
  exactly the DCI-crossing wire blocks (``A2APod`` off-diagonal blocks,
  inter-pod ``PermuteWorld`` rounds).  The same compiled masks drive both
  :func:`repro_torch.comm.exchange.execute_numpy` and the torch executor in
  :mod:`repro_torch.comm.strategies`, so the two stay in bitwise lockstep under
  identical injections.  Fault models: non-finite corruption (``corrupt``),
  value perturbation (``perturb``), zeroed/dropped wire blocks (``zero``),
  and injected slow-hop latency (``slow``).
* **Detection** -- cheap per-wire-block check values (finite-|x| sum,
  non-finite count, finite amax) computed before encode and validated after
  decode.  Exact for codec ``none``; tolerance-aware for lossy codecs using
  :data:`repro_torch.comm.wire.REL_ERROR_BOUND` / ``ABS_ERROR_FLOOR``.  A failed
  check raises a structured :class:`ExchangeIntegrityError` naming the
  stage, hop class, and codec.
* **Recovery** -- :func:`run_ladder`, the retry -> codec-demotion ->
  strategy-re-advise policy of
  :class:`repro_torch.comm.strategies.IrregularExchange` (and through it of
  :class:`repro_torch.sparse.spmv.DistributedSpMV`), with a
  :class:`HealthTracker` that marks degraded (strategy, codec) hops, biases
  the advisor (``advise(..., health=...)``) away from them, and feeds an
  optional watchdog's escalation budget (anything with
  ``record_external(kind, diagnostics)``).

Faults model *link* corruption: they are applied to the decoded values of
wire blocks that actually crossed pods, never to on-pod traffic or the
``A2APod`` own-pod (diagonal) blocks.  Everything here is numpy; the
torch twins of the check/injection arithmetic live in
:mod:`repro_torch.comm.strategies` and share the tolerance formula below.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.comm import wire as wire_codec
from repro_torch.comm.exchange import A2APod, PermuteWorld, StagePlan

#: multiplier applied by HealthTracker.penalty to a (strategy, codec) pair
#: that failed integrity verification (effectively excluded from ranking)
DEGRADED_PENALTY = 1e6
#: milder multiplier for a strategy that failed under a *different* codec
SUSPECT_PENALTY = 1e3

FAULT_KINDS = ("corrupt", "perturb", "zero", "slow")

#: expandable codec group accepted in FaultSpec.codecs
LOSSY_CODECS = ("bf16", "f16", "int8")

_EPS32 = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Fault specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault model, applied independently to matching DCI wire blocks.

    ``kind``:

    * ``"corrupt"`` -- hit elements are replaced by ``value`` (default
      ``nan``: non-finite corruption).
    * ``"perturb"`` -- hit elements are scaled by ``1 + scale`` (a silent
      value error, large enough by default for the check values to see).
    * ``"zero"``    -- the whole wire block is zeroed (a dropped block).
    * ``"slow"``    -- no value change; adds ``delay_s`` of host-visible
      latency to the exchange (a slow hop, observable by the watchdog).

    ``prob`` fires each candidate wire block independently; ``frac`` is the
    fraction of elements hit inside a fired block (corrupt/perturb; at
    least one element is always hit).  ``hops`` / ``strategies`` /
    ``codecs`` optionally restrict the spec to specific inter-pod hop
    ordinals, plan strategies, or wire codecs (``"lossy"`` expands to
    ``bf16/f16/int8`` -- the idiom for faults that codec demotion cures).
    """

    kind: str = "corrupt"
    prob: float = 1.0
    frac: float = 0.25
    value: float = float("nan")
    scale: float = 0.5
    delay_s: float = 0.0
    hops: Optional[Tuple[int, ...]] = None
    strategies: Optional[Tuple[str, ...]] = None
    codecs: Optional[Tuple[str, ...]] = None

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"frac must be in [0, 1], got {self.frac}")

    def matches(self, strategy: str, codec: str) -> bool:
        if self.strategies is not None and strategy not in self.strategies:
            return False
        if self.codecs is not None:
            allowed = []
            for c in self.codecs:
                allowed.extend(LOSSY_CODECS if c == "lossy" else (c,))
            if codec not in allowed:
                return False
        return True


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic set of fault specs.

    Stateless: compiling the same plan against the same stage program and
    codec always yields the same masks, which is what keeps the numpy and
    device executors in bitwise lockstep.  ``active_calls`` optionally
    limits injection to specific call indices of the owning exchange
    (``(0,)`` models a transient fault that a retry cures; ``None`` -- the
    default -- models a persistent fault that needs codec demotion or a
    strategy re-advise).
    """

    seed: int
    specs: Tuple[FaultSpec, ...]
    active_calls: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if not self.specs:
            raise ValueError("FaultPlan needs at least one FaultSpec")

    def active(self, call_index: int) -> bool:
        return self.active_calls is None or call_index in self.active_calls

    def fingerprint(self) -> str:
        parts = [f"seed={self.seed}", f"calls={self.active_calls}"]
        for s in self.specs:
            parts.append(
                f"{s.kind}:p{s.prob}:f{s.frac}:v{s.value!r}:s{s.scale}:"
                f"d{s.delay_s}:h{s.hops}:st{s.strategies}:c{s.codecs}"
            )
        return "|".join(parts)


# ---------------------------------------------------------------------------
# Hop enumeration + compilation to masks
# ---------------------------------------------------------------------------


def iter_inter_hops(plan: StagePlan):
    """Yield ``(ordinal, op_index, stage_kind, round_index, stage, perm)``
    for every DCI-crossing hop of ``plan``, in program order.

    ``stage_kind`` is ``"a2a_pod"`` (``round_index`` None) or ``"permute"``
    (one entry per inter-pod round with a non-empty permutation).  The
    ordinal is the stable hop id FaultSpec.hops and the check-value
    metadata key on; both executors enumerate hops with this function.
    """
    ordinal = 0
    for i, st in enumerate(plan.stages):
        if isinstance(st, A2APod):
            yield ordinal, i, "a2a_pod", None, st, None
            ordinal += 1
        elif isinstance(st, PermuteWorld):
            inters = st.inter if st.inter is not None else (False,) * len(st.blks)
            for r, (perm, inter) in enumerate(zip(st.rounds, inters)):
                if inter and perm:
                    yield ordinal, i, "permute", r, st, perm
                    ordinal += 1


@dataclasses.dataclass(frozen=True)
class HopInjection:
    """One fault applied to one DCI hop, in both executor layouts.

    ``np_mask`` is the canonical (sender-side) layout used by
    ``execute_numpy``: ``[npods, ppn, npods, blk]`` for ``a2a_pod`` (the
    pre-transpose buffer view), ``[nranks, blk]`` sender rows for
    ``permute``.  ``dev_mask`` is the receiver layout the device executor
    indexes by its own rank: ``[nranks, npods, blk]`` for ``a2a_pod``
    (row r = the mask over that rank's post-collective ``[npods, blk]``
    result), ``[nranks, blk]`` receiver rows for ``permute``.  ``value``
    is the injected constant (``corrupt``), the ``1 + scale`` factor
    (``perturb``), or unused (``zero``).
    """

    ordinal: int
    op_index: int
    stage_kind: str
    round_index: Optional[int]
    kind: str
    value: float
    np_mask: np.ndarray
    dev_mask: np.ndarray


@dataclasses.dataclass(frozen=True)
class CompiledFaults:
    """A FaultPlan bound to one stage program + codec."""

    strategy: str
    codec: str
    delay_s: float
    injections: Tuple[HopInjection, ...]

    def for_hop(self, op_index: int, round_index: Optional[int]) -> Tuple[HopInjection, ...]:
        return tuple(
            inj
            for inj in self.injections
            if inj.op_index == op_index and inj.round_index == round_index
        )


def _elem_mask(rng: np.random.Generator, fire: np.ndarray, blk: int, frac: float) -> np.ndarray:
    """Per-element hit mask ``fire.shape + (blk,)``; fired blocks hit at
    least one element (the draw's argmin position is forced on)."""
    em = rng.random(fire.shape + (blk,))
    elem = em < frac
    idx = em.argmin(axis=-1)
    np.put_along_axis(elem, idx[..., None], True, axis=-1)
    return elem & fire[..., None]


def compile_faults(plan: StagePlan, codec: str, faults: FaultPlan) -> CompiledFaults:
    """Resolve ``faults`` into concrete masks over ``plan``'s DCI hops.

    Deterministic in ``(faults.seed, hop ordinal, spec index)``: every
    random draw comes from ``np.random.default_rng([seed, ordinal, si])``,
    so numpy and device executors compile identical masks independently.
    """
    wire_codec.check_codec(codec)
    topo = plan.pattern.topo
    nranks, ppn, npods = topo.nranks, topo.ppn, topo.npods
    injections: List[HopInjection] = []
    delay = 0.0
    for ordinal, op_index, stage_kind, round_index, st, perm in iter_inter_hops(plan):
        for si, spec in enumerate(faults.specs):
            if not spec.matches(plan.strategy, codec):
                continue
            if spec.hops is not None and ordinal not in spec.hops:
                continue
            rng = np.random.default_rng([faults.seed, ordinal, si])
            if spec.kind == "slow":
                if rng.random() < spec.prob:
                    delay += spec.delay_s
                continue
            if stage_kind == "a2a_pod":
                blk = st.buflen // npods
                fire = rng.random((npods, ppn, npods)) < spec.prob
                diag = np.arange(npods)
                fire[diag, :, diag] = False  # own-pod blocks never cross DCI
                if not fire.any():
                    continue
                if spec.kind == "zero":
                    np_mask = np.broadcast_to(fire[..., None], fire.shape + (blk,)).copy()
                else:
                    np_mask = _elem_mask(rng, fire, blk, spec.frac)
                # receiver layout: rank (p, l) sees res[q] = b[q, l, p]
                dev_mask = np.ascontiguousarray(
                    np_mask.transpose(2, 1, 0, 3).reshape(nranks, npods, blk)
                )
            else:  # permute round
                blk = st.blks[round_index]
                np_mask = np.zeros((nranks, blk), dtype=bool)
                dev_mask = np.zeros((nranks, blk), dtype=bool)
                fires = rng.random(len(perm)) < spec.prob
                rows = (
                    np.broadcast_to(fires[:, None], (len(perm), blk)).copy()
                    if spec.kind == "zero"
                    else _elem_mask(rng, fires, blk, spec.frac)
                )
                if not rows.any():
                    continue
                for k, (s, d) in enumerate(perm):
                    np_mask[s] = rows[k]
                    dev_mask[d] = rows[k]
            value = spec.value if spec.kind == "corrupt" else 1.0 + spec.scale
            injections.append(
                HopInjection(
                    ordinal=ordinal,
                    op_index=op_index,
                    stage_kind=stage_kind,
                    round_index=round_index,
                    kind=spec.kind,
                    value=float(value),
                    np_mask=np_mask,
                    dev_mask=dev_mask,
                )
            )
    return CompiledFaults(
        strategy=plan.strategy,
        codec=codec,
        delay_s=delay,
        injections=tuple(injections),
    )


def apply_injection_np(x: np.ndarray, mask: np.ndarray, kind: str, value: float) -> np.ndarray:
    """Numpy twin of the device-side injection: broadcast ``mask`` over the
    trailing feature dims of ``x`` and apply the fault.  Arithmetic is kept
    in ``x.dtype`` (constant replacement / one same-dtype multiply) so both
    executors round identically."""
    m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
    if kind == "zero":
        return np.where(m, np.zeros((), dtype=x.dtype), x)
    if kind == "corrupt":
        return np.where(m, np.asarray(value, dtype=x.dtype), x)
    if kind == "perturb":
        return np.where(m, x * np.asarray(value, dtype=x.dtype), x)
    raise ValueError(f"unknown injection kind {kind!r}")


# ---------------------------------------------------------------------------
# Wire integrity checks
# ---------------------------------------------------------------------------


def block_check_np(x: np.ndarray, axes: Tuple[int, ...]):
    """Per-wire-block check triple ``(sum |finite x|, nonfinite count,
    finite amax)`` in float32, reduced over ``axes``.

    These are the sender-side check values shipped alongside the payload in
    ``verify=True`` mode and recomputed on the receiver after decode.  The
    torch executor computes the same triple with torch; each executor only
    ever compares values it computed itself, so cross-library summation
    order differences never enter a comparison.
    """
    f = np.asarray(x).astype(np.float32)
    finite = np.isfinite(f)
    mag = np.where(finite, np.abs(f), np.float32(0.0))
    s = mag.sum(axis=axes, dtype=np.float32)
    c = (~finite).sum(axis=axes).astype(np.float32)
    a = np.max(mag, axis=axes, initial=0.0).astype(np.float32)
    return s, c, a


def sum_tolerance(codec: str, nelem: int, amax, sum_abs, encoded: bool):
    """Allowed |sum drift| of a decoded wire block vs its sender check.

    Exact (0) when the codec did not encode the payload; otherwise the
    per-element bound ``REL_ERROR_BOUND * amax + ABS_ERROR_FLOOR`` summed
    over the block, plus a small float32-accumulation margin.  Pure
    arithmetic over python scalars and the ``amax`` / ``sum_abs`` arrays,
    so the numpy and device executors share this exact formula.
    """
    if not encoded:
        return 0.0 * amax
    rel = wire_codec.REL_ERROR_BOUND[codec]
    floor = wire_codec.ABS_ERROR_FLOOR[codec]
    return nelem * (rel * amax + floor) * 1.0625 + 64.0 * _EPS32 * (sum_abs + 1.0)


def check_violation(pre, post, nelem: int, codec: str, encoded: bool) -> np.ndarray:
    """Per-block violation amount: ``> 0`` means the check failed.

    A non-finite-count mismatch is an unconditional violation (``inf``);
    otherwise the sum drift less its tolerance.
    """
    s0, c0, a0 = pre
    s1, c1, _ = post
    tol = sum_tolerance(codec, nelem, a0, s0, encoded)
    drift = np.abs(s1.astype(np.float64) - s0.astype(np.float64)) - tol
    return np.where(c1 != c0, np.float64(np.inf), drift)


class ExchangeIntegrityError(RuntimeError):
    """A wire integrity check failed on a DCI-crossing hop.

    Structured: ``strategy``, ``stage_kind`` (``a2a_pod`` | ``permute``),
    ``op_index`` (stage index in the plan), ``round_index`` (permute round
    or None), ``hop_class`` (always ``"inter_pod"`` -- on-pod hops are
    never checked because they are never encoded or faulted), ``codec``,
    and the worst ``violation`` amount.  :meth:`diagnostics` returns the
    executor-independent fields -- the numpy and device executors raise
    identical diagnostics for the same injection.
    """

    def __init__(
        self,
        *,
        strategy: str,
        codec: str,
        stage_kind: str,
        op_index: int,
        round_index: Optional[int] = None,
        hop_class: str = "inter_pod",
        violation: Optional[float] = None,
    ) -> None:
        self.strategy = strategy
        self.codec = codec
        self.stage_kind = stage_kind
        self.op_index = op_index
        self.round_index = round_index
        self.hop_class = hop_class
        self.violation = violation
        where = f"stage#{op_index} {stage_kind}"
        if round_index is not None:
            where += f" round {round_index}"
        msg = (
            f"exchange integrity violation: strategy={strategy} {where} "
            f"hop_class={hop_class} codec={codec}"
        )
        if violation is not None:
            msg += f" violation={violation:g}"
        super().__init__(msg)

    def diagnostics(self) -> Dict[str, object]:
        """Executor-independent identity of the failure (no float amounts)."""
        return {
            "strategy": self.strategy,
            "stage_kind": self.stage_kind,
            "op_index": self.op_index,
            "round_index": self.round_index,
            "hop_class": self.hop_class,
            "codec": self.codec,
        }


def raise_if_violated(
    viol: np.ndarray,
    *,
    strategy: str,
    codec: str,
    stage_kind: str,
    op_index: int,
    round_index: Optional[int] = None,
) -> None:
    v = np.asarray(viol)
    if v.size and bool((v > 0.0).any()):
        raise ExchangeIntegrityError(
            strategy=strategy,
            codec=codec,
            stage_kind=stage_kind,
            op_index=op_index,
            round_index=round_index,
            violation=float(v.max()),
        )


# ---------------------------------------------------------------------------
# Health tracking + the recovery ladder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HealthTracker:
    """Per-(strategy, codec) integrity health, shared across the ladder.

    ``record_failure`` marks the offending hop degraded and (optionally)
    feeds ``watchdog.record_external`` (the reference's
    ``StragglerWatchdog``; any object with that method) so integrity failures draw on the same escalation budget as straggler
    steps.  :meth:`penalty` is the multiplier
    ``repro_torch.core.advisor.advise(..., health=...)`` applies to a degraded
    pair's predicted time, which is what steers the re-advise step of the
    ladder away from the offending hop.

    Degradation is a circuit breaker, not a permanent sentence.  A pair
    that crosses ``degrade_after`` failures opens its breaker and, after a
    deterministic call-count cooldown, moves to half-open: the next ladder
    entry on that pair runs as a probe.  A successful probe closes the
    breaker (failure count and penalty reset); a failed probe re-opens it
    with the cooldown doubled.  The clock is :meth:`record_call` ticks --
    one per ladder entry -- so recovery is reproducible under replay.

    ``events`` is a ring buffer capped at ``max_events`` entries; overflow
    increments ``dropped`` instead of leaking memory on long-running
    serves.
    """

    degrade_after: int = 1
    watchdog: Optional[object] = None
    failures: Dict[Tuple[str, str], int] = dataclasses.field(default_factory=dict)
    events: List[dict] = dataclasses.field(default_factory=list)
    recovery_count: int = 0
    last_recovery: Optional[str] = None
    max_events: int = 256
    dropped: int = 0
    cooldown: int = 8
    cooldown_growth: float = 2.0
    calls: int = 0
    probes: int = 0
    probe_recoveries: int = 0
    _opened_at: Dict[Tuple[str, str], int] = dataclasses.field(default_factory=dict)
    _cooldowns: Dict[Tuple[str, str], int] = dataclasses.field(default_factory=dict)

    def _push_event(self, ev: dict) -> None:
        self.events.append(ev)
        over = len(self.events) - self.max_events
        if over > 0:
            del self.events[:over]
            self.dropped += over

    def record_call(self) -> None:
        """Advance the breaker clock by one ladder entry."""
        self.calls += 1

    def breaker_state(self, strategy: str, wire: str) -> str:
        """``"closed"`` (healthy), ``"open"`` (priced out), or
        ``"half_open"`` (cooldown elapsed -- next call probes)."""
        key = (strategy, wire)
        if self.failures.get(key, 0) < self.degrade_after:
            return "closed"
        opened = self._opened_at.get(key)
        if opened is None:
            # degraded without breaker bookkeeping (e.g. failures set
            # directly by a test or imported from a prior run): stay open
            return "open"
        wait = self._cooldowns.get(key, self.cooldown)
        return "half_open" if self.calls - opened >= wait else "open"

    def record_failure(self, err: ExchangeIntegrityError) -> None:
        key = (err.strategy, err.codec)
        was = self.breaker_state(*key)
        self.failures[key] = self.failures.get(key, 0) + 1
        if self.failures[key] >= self.degrade_after:
            if was == "closed":
                self._opened_at[key] = self.calls
                self._cooldowns.setdefault(key, max(1, self.cooldown))
            elif was == "half_open":
                # failed probe: re-open with doubled cooldown
                old = self._cooldowns.get(key, self.cooldown)
                self._opened_at[key] = self.calls
                self._cooldowns[key] = max(1, int(old * self.cooldown_growth))
            # was == "open": a ladder-rung failure while already open does
            # not extend the cooldown clock
        self._push_event({"kind": "integrity_failure", **err.diagnostics()})
        if self.watchdog is not None:
            self.watchdog.record_external("exchange_integrity", err.diagnostics())

    def record_success(self, strategy: str, wire: str) -> bool:
        """Close a half-open breaker after a clean probe exchange.

        No-op unless ``(strategy, wire)`` is half-open; returns whether the
        breaker closed.  Closing resets the pair's failure count (so
        :meth:`penalty` returns 1.0 again and ``advise(health=...)``
        rankings recover) and its cooldown back to the base value.
        """
        key = (strategy, wire)
        if self.breaker_state(strategy, wire) != "half_open":
            return False
        self.failures.pop(key, None)
        self._opened_at.pop(key, None)
        self._cooldowns.pop(key, None)
        self.probe_recoveries += 1
        self._push_event(
            {"kind": "probe_recovery", "strategy": strategy, "wire": wire}
        )
        return True

    def note_probe(self, strategy: str, wire: str) -> None:
        self.probes += 1
        self._push_event({"kind": "probe", "strategy": strategy, "wire": wire})

    def record_recovery(self, action: str, strategy: str, wire: str) -> None:
        self.recovery_count += 1
        self.last_recovery = f"{action}:{strategy}/{wire}"
        self._push_event(
            {"kind": "recovery", "action": action, "strategy": strategy, "wire": wire}
        )

    def is_degraded(self, strategy: str, wire: Optional[str] = None) -> bool:
        if wire is None:
            return any(
                k[0] == strategy and v >= self.degrade_after
                for k, v in self.failures.items()
            )
        return self.failures.get((strategy, wire), 0) >= self.degrade_after

    def degraded(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(
            sorted(k for k, v in self.failures.items() if v >= self.degrade_after)
        )

    def penalty(self, strategy: str, wire: str = "none") -> float:
        if self.is_degraded(strategy, wire):
            return DEGRADED_PENALTY
        if self.is_degraded(strategy):
            return SUSPECT_PENALTY
        return 1.0


@dataclasses.dataclass(frozen=True)
class RecoveryPath:
    """How the ladder recovered: the action taken and what it ran on."""

    action: str  # "retry" | "demote" | "readvise"
    strategy: str
    wire: str

    @property
    def key(self) -> str:
        return f"{self.action}:{self.strategy}/{self.wire}"


def run_ladder(
    attempt: Callable[[str, str], object],
    *,
    strategy: str,
    wire: str,
    health: Optional[HealthTracker] = None,
    max_retries: int = 1,
    fallback: bool = True,
    choose_alternative: Optional[Callable[[HealthTracker, str], Optional[str]]] = None,
):
    """The retry -> demote -> re-advise recovery ladder.

    ``attempt(strategy, wire)`` runs one exchange and raises
    :class:`ExchangeIntegrityError` on a failed check.  The ladder tries
    the configured pair up to ``1 + max_retries`` times (a transient fault
    recovers here), then demotes a lossy codec to ``"none"`` (a
    codec-triggered fault recovers here), then asks ``choose_alternative``
    for a replacement strategy with the offending hops marked degraded in
    ``health``.  Returns ``(value, RecoveryPath | None)``; every failure is
    recorded in ``health`` before the next rung runs, so the re-advise rung
    sees the demotion failure too.  Raises the last integrity error when
    the ladder is exhausted (or ``fallback`` is off).

    Each entry also advances the health tracker's breaker clock: a pair
    whose breaker has cooled to half-open runs its first attempt as a
    probe, and any clean attempt on a half-open pair closes that breaker
    (:meth:`HealthTracker.record_success`) so the advisor's penalties
    recover once the link heals.
    """
    health = health if health is not None else HealthTracker()
    health.record_call()
    last: Optional[ExchangeIntegrityError] = None
    try:
        if health.breaker_state(strategy, wire) == "half_open":
            health.note_probe(strategy, wire)
        for i in range(1 + max(0, max_retries)):
            try:
                out = attempt(strategy, wire)
            except ExchangeIntegrityError as e:
                last = e
                health.record_failure(e)
                continue
            health.record_success(strategy, wire)
            if i == 0:
                return out, None
            health.record_recovery("retry", strategy, wire)
            return out, RecoveryPath("retry", strategy, wire)
        if fallback and wire != "none":
            try:
                out = attempt(strategy, "none")
            except ExchangeIntegrityError as e:
                last = e
                health.record_failure(e)
            else:
                health.record_success(strategy, "none")
                health.record_recovery("demote", strategy, "none")
                return out, RecoveryPath("demote", strategy, "none")
        if fallback and choose_alternative is not None:
            alt = choose_alternative(health, strategy)
            if alt is not None and alt != strategy:
                try:
                    out = attempt(alt, "none")
                except ExchangeIntegrityError as e:
                    health.record_failure(e)
                    raise
                health.record_success(alt, "none")
                health.record_recovery("readvise", alt, "none")
                return out, RecoveryPath("readvise", alt, "none")
        assert last is not None
        raise last
    finally:
        # a caught error's traceback holds this frame, and through it every
        # caller's locals: drop it here, or they live until the collector runs
        last = None


def advise_alternative(
    pattern, elem_bytes: int = 4, machine: str = "lassen"
) -> Callable[[HealthTracker, str], Optional[str]]:
    """Build the ladder's re-advise chooser for one exchange pattern.

    Ranks strategies with :func:`repro_torch.core.advisor.advise` (on the
    port's advisor machine, ``lassen``, as ``DistributedSpMV`` does) under the
    health tracker's degradation penalties (the paper's per-hop-class model
    terms re-ranked with the offending hop priced out) and returns the best
    non-degraded strategy different from the current one; falls back to a
    fixed preference order if the advisor's whole ranking is degraded.
    """

    def choose(health: HealthTracker, current: str) -> Optional[str]:
        # local import: repro_torch.core.advisor -> perfmodel is a heavier
        # import chain and must not be paid at comm-module import time
        from repro_torch.core.advisor import EXECUTABLE_STRATEGY, advise

        adv = advise(
            pattern.to_comm_pattern(elem_bytes), machine=machine, health=health
        )
        for rec in adv.ranked:
            name = EXECUTABLE_STRATEGY[rec.strategy]
            if name != current and not health.is_degraded(name):
                return name
        for name in ("two_step", "three_step", "split", "standard"):
            if name != current and not health.is_degraded(name):
                return name
        return None

    return choose
