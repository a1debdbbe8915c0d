"""Model-driven communication strategy selection (paper §4.6 as a feature).

Given an irregular :class:`~repro_torch.core.patterns.CommPattern` (or raw Table 7
stats) and a machine registry entry, the advisor evaluates every Table 6
composite model and returns the ranked strategies.  This turns the paper's
characterization into the runtime decision procedure behind
``DistributedSpMV(strategy="auto")``.

When a :class:`ComputeProfile` is supplied, every (strategy, transport) pair
is additionally ranked in its *overlapped* (split-phase) variant, where
interior compute hides the inter-node phase
(:func:`repro_torch.core.perfmodel.predict_overlapped`); recommendations carry an
``overlap`` flag and overlapped keys read e.g. ``"split_dd/staged_host+overlap"``.

Example (doctest)::

    >>> from repro_torch.core import advise, figure43_pattern
    >>> pat = figure43_pattern(2048, 256, 16)
    >>> advise(pat, machine="lassen").best.key
    'two_step/device_aware'
    >>> advise(pat, machine="lassen", payload_width=16).best.key
    'three_step/device_aware'
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.hardware import MachineParams, get_machine
from repro_torch.core.patterns import CommPattern
from repro_torch.core.perfmodel import (
    WIRE_MODELS,
    LaunchModel,
    PatternStats,
    Strategy,
    Transport,
    dispatch_stats,
    get_wire,
    modeled_pairs,
    predict,
    predict_overlapped,
    predict_solver,
)


#: model-enum -> executable strategy name (repro_torch.comm.strategies); the
#: mapping the fault ladder uses to translate advisor rankings into
#: runnable exchanges when re-advising around a degraded hop
EXECUTABLE_STRATEGY = {
    Strategy.STANDARD: "standard",
    Strategy.TWO_STEP: "two_step",
    Strategy.TWO_STEP_ONE: "two_step",
    Strategy.THREE_STEP: "three_step",
    Strategy.SPLIT_MD: "split",
    Strategy.SPLIT_DD: "split",
}


@dataclasses.dataclass(frozen=True)
class ComputeProfile:
    """Per-step local compute, split by halo dependence (seconds).

    ``t_interior`` is the compute that needs no halo data (overlappable with
    the inter-node phase); ``t_boundary`` is the halo-dependent remainder.
    Build one from a measured whole-step compute time and the row split's
    interior tile fraction via :meth:`from_fraction`.
    """

    t_interior: float
    t_boundary: float

    @property
    def total(self) -> float:
        return self.t_interior + self.t_boundary

    @staticmethod
    def from_fraction(t_compute: float, interior_fraction: float) -> "ComputeProfile":
        """Split a total compute time by the overlappable fraction.

        >>> ComputeProfile.from_fraction(1.0, 0.75)
        ComputeProfile(t_interior=0.75, t_boundary=0.25)
        """
        if not 0.0 <= interior_fraction <= 1.0:
            raise ValueError(f"interior_fraction must be in [0, 1], got {interior_fraction}")
        return ComputeProfile(
            t_interior=t_compute * interior_fraction,
            t_boundary=t_compute * (1.0 - interior_fraction),
        )


class _StrategyKey:
    """Shared ``key`` spelling for per-call and whole-solve recommendations
    (``strategy/transport`` with ``+overlap`` / ``+wire:<codec>`` suffixes)
    -- one place to keep the format the pinned regression grids assert on."""

    @property
    def key(self) -> str:
        base = f"{self.strategy.value}/{self.transport.value}"
        if self.overlap:
            base += "+overlap"
        if getattr(self, "fused", False):
            base += "+fused"
        if getattr(self, "wire", "none") != "none":
            base += f"+wire:{self.wire}"
        return base


@dataclasses.dataclass(frozen=True)
class Recommendation(_StrategyKey):
    strategy: Strategy
    transport: Transport
    predicted_time: float
    #: True when this entry models the split-phase (overlapped) execution
    overlap: bool = False
    #: inter-pod wire codec this entry models ("none" = full precision)
    wire: str = "none"


@dataclasses.dataclass(frozen=True)
class Advice:
    """Ranked strategy recommendations for one pattern on one machine."""

    machine: str
    stats: PatternStats
    ranked: Tuple[Recommendation, ...]

    @property
    def best(self) -> Recommendation:
        return self.ranked[0]

    def time_for(
        self,
        strategy: Strategy,
        transport: Transport,
        overlap: bool = False,
        wire: str = "none",
    ) -> float:
        for r in self.ranked:
            if (
                r.strategy is strategy
                and r.transport is transport
                and r.overlap == overlap
                and r.wire == wire
            ):
                return r.predicted_time
        raise KeyError((strategy, transport, overlap, wire))

    def table(self) -> str:
        w = max(len(r.key) for r in self.ranked)
        lines = [f"{'strategy':<{w}}  predicted_s"]
        lines += [f"{r.key:<{w}}  {r.predicted_time:.3e}" for r in self.ranked]
        return "\n".join(lines)


def healthy_alternatives(ranked, health, current=None):
    """Executable strategy names from a ranking, best-first, breaker-aware.

    Yields each distinct executable strategy in ranking order, skipping
    ``current`` and any strategy whose :class:`~repro_torch.comm.faults.
    HealthTracker` breaker is OPEN.  A HALF-OPEN pair is yielded -- its
    cooldown has elapsed and it has earned exactly one probe -- which is
    how a re-advised chooser routes the probe through a healing link: if
    the probe succeeds, ``record_success`` closes the breaker, the penalty
    disappears, and subsequent :func:`advise` rankings recover the pair's
    clean position.  With ``health=None`` every strategy passes.
    """
    seen = set()
    for rec in ranked:
        name = EXECUTABLE_STRATEGY[rec.strategy]
        if name == current or name in seen:
            continue
        seen.add(name)
        if health is not None and health.is_degraded(name):
            state_of = getattr(health, "breaker_state", None)
            if state_of is None or state_of(name, rec.wire) != "half_open":
                continue
        yield name


def _wire_codecs(wire) -> Tuple[str, ...]:
    """Normalize the ``wire`` argument of :func:`advise` to codec names.

    ``None`` keeps the paper's full-precision ranking; ``"auto"`` ranks
    every executable codec; a single name or a sequence restricts the
    candidates (``"none"`` is a valid explicit candidate).
    """
    if wire is None:
        return ("none",)
    if isinstance(wire, str):
        codecs = tuple(WIRE_MODELS) if wire == "auto" else (wire,)
    else:
        codecs = tuple(wire)
    if not codecs:
        raise ValueError(
            "wire= must name at least one codec (or None / 'auto'); "
            "an empty sequence would produce an empty ranking"
        )
    for c in codecs:
        get_wire(c)  # raises ValueError on unknown names
    return codecs


def advise_stats(
    stats: PatternStats,
    machine: MachineParams | str = "tpu_v5e_pod",
    include_two_step_one: bool = False,
    duplicate_fraction: float = 0.0,
    exclude: Sequence[Tuple[Strategy, Transport]] = (),
    payload_width: int = 1,
    compute: Optional[ComputeProfile] = None,
    wire: "str | Sequence[str] | None" = None,
    health=None,
) -> Advice:
    """Rank strategies for raw Table 7 stats.

    ``duplicate_fraction`` models §4.6's duplicate-data removal: node-aware
    strategies eliminate that fraction of the standard data volume, standard
    communication does not.

    ``payload_width`` is the batched payload column count ``k`` (multi-vector
    SpMM): byte terms scale by ``k`` while message counts stay fixed (see
    :meth:`~repro_torch.core.perfmodel.PatternStats.widened`), which is what lets
    the ranking flip between message-count-bound and bandwidth-bound winners
    as ``k`` grows.

    ``compute`` switches on overlap-aware ranking: every pair is evaluated
    both as the barrier pipeline (``T_comm + T_compute``) and as the
    split-phase pipeline (:func:`~repro_torch.core.perfmodel.predict_overlapped`),
    and the two variants compete in one ranking.  Without a compute profile
    the ranking is communication-only, as in the paper.

    ``wire`` adds inter-pod codec variants (``+wire:<codec>`` keys, see
    :func:`_wire_codecs`): each candidate codec scales the inter-node byte
    terms by its compression ratio and pays the
    :func:`~repro_torch.core.perfmodel.t_codec` encode+decode term, so
    bandwidth-bound patterns flip to a compressed wire while latency-bound
    patterns keep ``none``.

    ``health`` (a :class:`repro_torch.comm.faults.HealthTracker`, or anything with
    its ``penalty(strategy, wire)`` contract) multiplies each prediction by
    the tracker's degradation penalty for the executable (strategy, codec)
    pair, so variants that failed integrity checks sink in the ranking while
    a ``None`` tracker leaves the paper's rankings untouched.  The penalty
    is not permanent: once the tracker's circuit breaker half-opens and a
    probe succeeds (``record_success``), the pair's failure count clears and
    the next ``advise`` call restores its clean position -- rankings recover
    when a link heals (see :func:`healthy_alternatives`).
    """
    m = get_machine(machine) if isinstance(machine, str) else machine
    stats = stats.widened(payload_width)
    keep = 1.0 - duplicate_fraction
    codecs = _wire_codecs(wire)
    preds = {}
    for strategy, transport in modeled_pairs(include_two_step_one):
        if (strategy, transport) in exclude:
            continue
        stats_eff = stats
        if duplicate_fraction > 0.0 and strategy is not Strategy.STANDARD:
            stats_eff = stats.scaled(keep)
        for codec in codecs:
            wm = get_wire(codec)
            pen = 1.0
            if health is not None:
                pen = health.penalty(EXECUTABLE_STRATEGY[strategy], codec)
            # the penalty orders the ranking but is not wall time, so each
            # entry carries (sort key, physical prediction): a degraded
            # pair sinks without its Recommendation.predicted_time -- what
            # schedulers charge as service time -- leaving the model
            t = predict(m, strategy, transport, stats_eff, wire=wm)
            if compute is None:
                preds[(strategy, transport, False, codec)] = (pen * t, t)
            else:
                preds[(strategy, transport, False, codec)] = (
                    pen * t + compute.total, t + compute.total
                )
                t_ov = predict_overlapped(
                    m, strategy, transport, stats_eff,
                    compute.t_interior, compute.t_boundary, wire=wm,
                )
                preds[(strategy, transport, True, codec)] = (pen * t_ov, t_ov)
    ranked = tuple(
        Recommendation(s, tr, t, overlap=ov, wire=cd)
        for (s, tr, ov, cd), (_, t) in sorted(
            preds.items(), key=lambda kv: kv[1][0]
        )
    )
    return Advice(machine=m.name, stats=stats, ranked=ranked)


def advise_routing(
    counts,
    ppn: int,
    elem_bytes: int = 4,
    payload_width: int = 1,
    machine: MachineParams | str = "tpu_v5e_pod",
    wire: "str | Sequence[str] | None" = None,
    health=None,
    include_two_step_one: bool = False,
) -> Advice:
    """Rank strategies for a measured routing histogram.

    ``counts[s, d]`` is the measured number of routed elements (MoE tokens)
    sent from rank ``s`` to rank ``d`` -- the expert-load histogram the
    router produced, not an assumed-uniform all-to-all.  ``payload_width``
    is the per-element feature width (``d_model`` for token dispatch): byte
    terms scale by it while message counts stay fixed, exactly the batched
    payload lever of :meth:`~repro_torch.core.perfmodel.PatternStats.widened`.

    >>> import numpy as np
    >>> from repro_torch.core import advise_routing
    >>> counts = np.full((8, 8), 64) - 64 * np.eye(8, dtype=int)
    >>> adv = advise_routing(counts, ppn=4, payload_width=32, machine="lassen")
    >>> adv.best.predicted_time < adv.ranked[-1].predicted_time
    True
    """
    return advise_stats(
        dispatch_stats(counts, ppn, elem_bytes=elem_bytes),
        machine=machine,
        payload_width=payload_width,
        wire=wire,
        health=health,
        include_two_step_one=include_two_step_one,
    )


# ---------------------------------------------------------------------------
# Iteration-amortized selection (solver workloads)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolverRecommendation(_StrategyKey):
    """One (strategy, transport, overlap, fused) variant of a whole solve."""

    strategy: Strategy
    transport: Transport
    overlap: bool
    setup_time: float
    iter_time: float
    total_time: float
    #: True when this entry models the fused whole-solve ``lax.while_loop``
    #: front-end (one trace+launch up front, zero per-iteration dispatches);
    #: False covers both the host-driven loop (with per-dispatch launch
    #: overhead when ``fused=`` ranking is on) and the legacy launch-free
    #: accounting (``advise_solver(fused=None)``).
    fused: bool = False


@dataclasses.dataclass(frozen=True)
class SolverAdvice:
    """Ranked whole-solve recommendations for one pattern on one machine."""

    machine: str
    stats: PatternStats
    iters: int
    ranked: Tuple[SolverRecommendation, ...]

    @property
    def best(self) -> SolverRecommendation:
        return self.ranked[0]

    def time_for(
        self,
        strategy: Strategy,
        transport: Transport,
        overlap: bool = False,
        fused: bool = False,
    ) -> float:
        for r in self.ranked:
            if (
                r.strategy is strategy
                and r.transport is transport
                and r.overlap == overlap
                and r.fused == fused
            ):
                return r.total_time
        raise KeyError((strategy, transport, overlap, fused))

    def table(self) -> str:
        w = max(len(r.key) for r in self.ranked)
        lines = [f"{'strategy':<{w}}  setup_s    per_iter_s  total_s"]
        lines += [
            f"{r.key:<{w}}  {r.setup_time:.3e}  {r.iter_time:.3e}  {r.total_time:.3e}"
            for r in self.ranked
        ]
        return "\n".join(lines)


def advise_solver(
    stats: PatternStats | CommPattern,
    iters: int,
    machine: MachineParams | str = "tpu_v5e_pod",
    reductions_per_iter: float = 2.0,
    payload_width: int = 1,
    compute: Optional[ComputeProfile] = None,
    include_two_step_one: bool = False,
    exclude: Sequence[Tuple[Strategy, Transport]] = (),
    fused: "bool | str | None" = None,
    launch: Optional[LaunchModel] = None,
    matvecs_per_iter: float = 1.0,
) -> SolverAdvice:
    """Rank strategies for a whole ``iters``-iteration Krylov solve.

    The per-call ranking of :func:`advise` answers "which strategy moves one
    halo fastest"; a solver re-runs the SAME exchange ``iters`` times, so the
    question becomes amortized (paper §4.6 closing discussion):

        ``T_total = T_setup + iters * (T_step + reductions_per_iter * T_red)``

    * ``T_setup`` -- :func:`~repro_torch.core.perfmodel.predict_setup`, paid once:
      node-aware communicator construction is several metadata rounds while
      standard communication starts almost free, so at small ``iters`` the
      standard strategy wins patterns it loses per-call;
    * ``T_step`` -- the Table 6 composite on payload-widened stats, plus the
      compute profile; with ``compute`` supplied every pair also competes as
      its split-phase ``+overlap`` variant
      (:func:`~repro_torch.core.perfmodel.predict_overlapped`);
    * ``T_red`` -- :func:`~repro_torch.core.perfmodel.predict_reduction`, the
      node-aware hierarchical scalar all-reduce each dot product costs
      (``reductions_per_iter``: 2 for CG, 6 for BiCGStab --
      :data:`repro_torch.solve.krylov.REDUCTIONS_PER_ITER`).

    ``fused`` brings the execution front-end into the ranking via
    :class:`~repro_torch.core.perfmodel.LaunchModel` (``launch``, default
    constants): ``None`` keeps the legacy launch-overhead-free accounting
    byte-identical; ``False`` / ``True`` model the host-driven loop
    (``t_launch`` per dispatch,
    :func:`~repro_torch.core.perfmodel.launches_per_iter` dispatches per
    iteration) / the fused whole-solve ``lax.while_loop``
    (:mod:`repro_torch.solve.fused`: one ``t_trace + t_launch`` up front, zero
    per-iteration dispatches); ``"auto"`` ranks both so short solves keep
    the host loop and long solves flip to ``+fused`` once the trace cost
    amortizes.  ``matvecs_per_iter`` follows
    :data:`repro_torch.solve.krylov.MATVECS_PER_ITER` (1 for CG, 2 for BiCGStab).

    Doctest (the amortization flip this function exists for)::

        >>> from repro_torch.core import advise_solver, figure43_pattern
        >>> pat = figure43_pattern(2048, 256, 16)
        >>> advise_solver(pat, iters=1, machine="lassen").best.key
        'standard/staged_host'
        >>> advise_solver(pat, iters=500, machine="lassen").best.key
        'two_step/device_aware'
    """
    if isinstance(stats, CommPattern):
        stats = stats.stats()
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if fused is None:
        fused_variants: Tuple[Optional[bool], ...] = (None,)
    elif fused == "auto":
        fused_variants = (False, True)
    elif isinstance(fused, bool):
        fused_variants = (fused,)
    else:
        raise ValueError(
            f"fused= must be None, True, False or 'auto', got {fused!r}"
        )
    m = get_machine(machine) if isinstance(machine, str) else machine
    wide = stats.widened(payload_width)
    recs = []
    for strategy, transport in modeled_pairs(include_two_step_one):
        if (strategy, transport) in exclude:
            continue
        variants = [(False, 0.0, 0.0)]
        if compute is not None:
            variants = [
                (False, compute.t_interior, compute.t_boundary),
                (True, compute.t_interior, compute.t_boundary),
            ]
        for overlap, t_int, t_bnd in variants:
            for fv in fused_variants:
                setup, per_iter, total = predict_solver(
                    m,
                    strategy,
                    transport,
                    wide,
                    iters,
                    reductions_per_iter=reductions_per_iter,
                    t_interior=t_int,
                    t_boundary=t_bnd,
                    overlap=overlap,
                    setup_stats=stats,
                    fused=fv,
                    launch=launch,
                    matvecs_per_iter=matvecs_per_iter,
                )
                recs.append(
                    SolverRecommendation(
                        strategy=strategy,
                        transport=transport,
                        overlap=overlap,
                        setup_time=setup,
                        iter_time=per_iter,
                        total_time=total,
                        fused=bool(fv),
                    )
                )
    ranked = tuple(sorted(recs, key=lambda r: r.total_time))
    return SolverAdvice(machine=m.name, stats=wide, iters=iters, ranked=ranked)


def advise(
    pattern: CommPattern,
    machine: MachineParams | str = "tpu_v5e_pod",
    include_two_step_one: bool = False,
    duplicate_fraction: float = 0.0,
    payload_width: int = 1,
    compute: Optional[ComputeProfile] = None,
    wire: "str | Sequence[str] | None" = None,
    health=None,
) -> Advice:
    """Rank strategies for a concrete communication pattern.

    ``payload_width`` is the batched-payload column count ``k``,
    ``compute`` enables overlap-aware ranking, ``wire`` adds inter-pod
    codec variants with ``+wire:<codec>`` keys, and ``health`` sinks
    degraded (strategy, codec) pairs in the ranking (see
    :func:`advise_stats`).

    >>> from repro_torch.core import figure43_pattern
    >>> adv = advise(figure43_pattern(2048, 256, 16), machine="lassen")
    >>> adv.best.key
    'two_step/device_aware'
    >>> adv.best.predicted_time < adv.ranked[-1].predicted_time
    True
    """
    return advise_stats(
        pattern.stats(),
        machine=machine,
        include_two_step_one=include_two_step_one,
        duplicate_fraction=duplicate_fraction,
        payload_width=payload_width,
        compute=compute,
        wire=wire,
        health=health,
    )
