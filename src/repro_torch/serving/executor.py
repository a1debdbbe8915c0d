"""Executor loop: drain batches through the real exchange stack.

The simulator (:mod:`repro_torch.serving.sim`) decides *what* to coalesce;
the executor proves those decisions run -- and pay off -- on the card.
:class:`BatchExecutor` maps each fingerprint class to a handler (a
:class:`repro_torch.sparse.spmv.DistributedSpMV` for solves: one fused SpMM,
kernel B2, per batch) and replays a batch schedule in dispatch order.
:func:`measure_spmv_replay` is the benchmark primitive behind the serving
claim: the same right-hand sides run once coalesced (``ceil(n/k)``
fused-SpMM exchanges at width ``k``) and once sequentially (``n``
single-column exchanges), with a numerical parity check between the two
paths.

Fault tolerance: each batch drains through the recovery ladder
(:func:`repro_torch.comm.faults.run_ladder` -- retry, demote the wire codec,
re-advise the strategy under health penalties) with a per-batch deadline
and bounded exponential backoff between attempts.  An exhausted ladder
sheds only that batch (a failed :class:`BatchOutcome`; completed work is
preserved) and feeds the shared
:class:`repro_torch.runtime.watchdog.StragglerWatchdog` /
:class:`~repro_torch.runtime.watchdog.AdmissionController` escalation
budget, so fault pressure and overload reach the control plane through one
path.  MoE dispatch batches (``register_moe``) run one
``MoELayer(dispatch="exchange")`` call over the coalesced token batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.comm.faults import ExchangeIntegrityError, HealthTracker, run_ladder
from repro_torch.core.errors import detached

from .batcher import Batch


@dataclasses.dataclass(frozen=True)
class BatchOutcome:
    """One batch's fate through the resilient drain.

    ``ok`` batches carry the handler's return in ``value``; failed batches
    carry the terminal exception in ``error`` and the shed request ids in
    ``shed_rids`` (the batch's whole FIFO prefix -- partial batches are
    never delivered).  ``recovery`` is the ladder's
    :class:`repro_torch.comm.faults.RecoveryPath` key (``"retry:..."``,
    ``"demote:..."``, ``"readvise:..."``) when a rung below the first had
    to run, ``None`` on a clean first attempt.
    """

    batch: Batch
    ok: bool
    value: object = None
    error: Optional[BaseException] = None
    recovery: Optional[str] = None
    attempts: int = 1
    shed_rids: Tuple[int, ...] = ()
    deadline_missed: bool = False
    elapsed_s: float = 0.0
    backoff_s: float = 0.0


class _DeadlineExceeded(Exception):
    """Internal: aborts the ladder once the per-batch deadline is spent.

    Deliberately NOT an :class:`ExchangeIntegrityError` subclass, so it
    escapes ``run_ladder`` (which only catches integrity errors) instead
    of consuming further rungs."""


class BatchExecutor:
    """Per-fingerprint handlers, drained in dispatch order.

    Construction is backwards compatible: ``BatchExecutor()`` behaves as
    before for :meth:`execute`.  The resilience knobs opt the *drain*
    (:meth:`run_schedule` / :meth:`execute_resilient`) into the recovery
    ladder:

    * ``health`` -- shared :class:`~repro_torch.comm.faults.HealthTracker`
      (circuit breaker + advisor penalties); created on demand if absent.
    * ``watchdog`` / ``admission`` -- shed batches are charged against the
      same escalation budget as straggler steps and queue overload.
    * ``deadline_s`` -- wall budget per batch; once spent, no further
      ladder attempts run and the batch is shed with
      ``deadline_missed=True``.
    * ``backoff_base_s`` / ``backoff_max_s`` -- bounded exponential pause
      before each non-first attempt (``base * 2**failures``, capped).
    * ``batcher`` -- a :class:`~repro_torch.serving.batcher.ContinuousBatcher`
      whose advice memo the re-advise rung refreshes
      (:meth:`~repro_torch.serving.batcher.ContinuousBatcher.readvise`).
    * ``clock`` / ``sleep`` -- injectable for deterministic tests.
    """

    def __init__(
        self,
        *,
        health: Optional[HealthTracker] = None,
        watchdog=None,
        admission=None,
        max_retries: int = 1,
        fallback: bool = True,
        deadline_s: Optional[float] = None,
        backoff_base_s: float = 0.0,
        backoff_max_s: float = 1.0,
        batcher=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self._handlers: Dict[str, Callable] = {}
        self._variant_makers: Dict[str, Callable[[str, str], Callable]] = {}
        self.executed = 0
        self.health = health if health is not None else HealthTracker(
            watchdog=watchdog
        )
        self.watchdog = watchdog
        self.admission = admission
        self.max_retries = int(max_retries)
        self.fallback = bool(fallback)
        self.deadline_s = deadline_s
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.batcher = batcher
        self._clock = clock
        self._sleep = sleep
        self.shed_batches = 0
        self.shed_requests = 0
        self.recovered_batches = 0
        self.deadline_misses = 0

    def register(self, fp: str, handler: Callable) -> None:
        """``handler(payload)`` runs one coalesced batch of class ``fp``."""
        self._handlers[fp] = handler

    def register_variants(
        self, fp: str, make: Callable[[str, str], Callable]
    ) -> None:
        """Register a handler *family*: ``make(strategy, wire)`` returns the
        handler for one (strategy, codec) pair, which is what lets the
        demote and re-advise rungs of the ladder actually run on a
        different wire or strategy.  The batch's own (strategy, wire) pair
        serves the first rung."""
        self._variant_makers[fp] = make

    def register_spmv(self, fp: str, sp) -> None:
        """Solve batches execute as one fused SpMM over the coalesced
        columns (:meth:`repro_torch.sparse.spmv.DistributedSpMV.matmat`)."""
        self.register(fp, sp.matmat)

    def register_moe(self, fp: str, layer, params, topo) -> None:
        """MoE batches execute one exchange-dispatch layer call
        (:class:`repro_torch.models.moe.MoELayer` on the stacked ranks of
        ``topo``, the reference's mesh); coalesced requests arrive stacked on
        the batch axis, so wider batches route more tokens through the same
        planned exchange."""
        self.register(fp, lambda x: layer(params, x, topo))

    def execute(self, batch: Batch, payload):
        handler = self._handlers.get(batch.fp)
        if handler is None:
            maker = self._variant_makers.get(batch.fp)
            if maker is None:
                raise KeyError(f"no handler registered for class {batch.fp!r}")
            handler = maker(batch.strategy, batch.wire)
        self.executed += 1
        return handler(payload)

    # -- resilient drain ---------------------------------------------------

    def _choose_alternative(self, batch: Batch):
        """Re-advise chooser for one batch: refresh the batcher's advice
        memo under the current health penalties and return the best
        non-degraded executable strategy different from the batch's."""

        def choose(health: HealthTracker, current: str) -> Optional[str]:
            if self.batcher is not None:
                from repro_torch.core.advisor import healthy_alternatives

                adv = self.batcher.readvise(batch.fp, batch.width)
                for name in healthy_alternatives(adv.ranked, health, current):
                    return name
            for name in ("two_step", "three_step", "split", "standard"):
                if name != current and not health.is_degraded(name):
                    return name
            return None

        return choose

    def execute_resilient(self, batch: Batch, payload) -> BatchOutcome:
        """Run one batch through the recovery ladder; never raises on an
        integrity failure -- an exhausted ladder becomes a failed outcome
        that sheds exactly this batch's requests."""
        with tracing.span("repro_torch.serve.execute"):
            return self._execute_resilient(batch, payload)

    def _execute_resilient(self, batch: Batch, payload) -> BatchOutcome:
        maker = self._variant_makers.get(batch.fp)
        plain = self._handlers.get(batch.fp)
        if maker is None and plain is None:
            return self._shed(
                batch,
                KeyError(f"no handler registered for class {batch.fp!r}"),
                attempts=0,
                elapsed_s=0.0,
                backoff_s=0.0,
            )
        t0 = self._clock()
        state = {"attempts": 0, "failed": 0, "backoff": 0.0}

        def attempt(strategy: str, wire: str):
            if state["attempts"] > 0:
                if (
                    self.deadline_s is not None
                    and self._clock() - t0 > self.deadline_s
                ):
                    raise _DeadlineExceeded(
                        f"batch {batch.fp!r} out of deadline budget "
                        f"({self.deadline_s}s) after {state['attempts']} attempts"
                    )
                pause = min(
                    self.backoff_max_s,
                    self.backoff_base_s * (2.0 ** state["failed"]),
                )
                if pause > 0.0:
                    state["backoff"] += pause
                    self._sleep(pause)
            state["attempts"] += 1
            handler = maker(strategy, wire) if maker is not None else plain
            try:
                out = handler(payload)
            except ExchangeIntegrityError:
                state["failed"] += 1
                raise
            return out

        try:
            value, path = run_ladder(
                attempt,
                strategy=batch.strategy,
                wire=batch.wire,
                health=self.health,
                max_retries=self.max_retries,
                # plain handlers cannot change (strategy, wire): retry only
                fallback=self.fallback and maker is not None,
                choose_alternative=self._choose_alternative(batch),
            )
        except (ExchangeIntegrityError, _DeadlineExceeded) as e:
            missed = isinstance(e, _DeadlineExceeded)
            return self._shed(
                batch,
                e,
                attempts=state["attempts"],
                elapsed_s=self._clock() - t0,
                backoff_s=state["backoff"],
                deadline_missed=missed,
            )
        self.executed += 1
        if path is not None:
            self.recovered_batches += 1
        return BatchOutcome(
            batch=batch,
            ok=True,
            value=value,
            recovery=None if path is None else path.key,
            attempts=max(1, state["attempts"]),
            elapsed_s=self._clock() - t0,
            backoff_s=state["backoff"],
        )

    def _shed(
        self,
        batch: Batch,
        error: BaseException,
        *,
        attempts: int,
        elapsed_s: float,
        backoff_s: float,
        deadline_missed: bool = False,
    ) -> BatchOutcome:
        rids = tuple(r.rid for r in batch.requests)
        self.shed_batches += 1
        self.shed_requests += len(rids)
        if deadline_missed:
            self.deadline_misses += 1
        info = {
            "fp": batch.fp,
            "requests": len(rids),
            "attempts": attempts,
            "deadline_missed": deadline_missed,
        }
        if self.watchdog is not None:
            self.watchdog.record_external("batch_shed", info)
        if self.admission is not None and hasattr(self.admission, "record_shed"):
            self.admission.record_shed(len(rids), info)
        return BatchOutcome(
            batch=batch,
            ok=False,
            error=detached(error),
            attempts=attempts,
            shed_rids=rids,
            deadline_missed=deadline_missed,
            elapsed_s=elapsed_s,
            backoff_s=backoff_s,
        )

    def run_schedule(
        self, batches: Sequence[Batch], payloads: Sequence
    ) -> List[BatchOutcome]:
        """Execute ``batches[i]`` on ``payloads[i]``, preserving order.

        Returns one :class:`BatchOutcome` per batch.  A handler failure --
        including the pre-existing ``KeyError`` on an unregistered
        fingerprint -- no longer discards the schedule's completed work: the
        failing batch's outcome carries the error (and, for integrity
        errors, the exhausted ladder's shed bookkeeping) while every other
        batch's result is preserved.
        """
        if len(batches) != len(payloads):
            raise ValueError(
                f"{len(batches)} batches but {len(payloads)} payloads"
            )
        outcomes: List[BatchOutcome] = []
        for b, p in zip(batches, payloads):
            try:
                outcomes.append(self.execute_resilient(b, p))
            except Exception as e:  # non-integrity handler bug: attach, keep going
                outcomes.append(
                    self._shed(b, e, attempts=1, elapsed_s=0.0, backoff_s=0.0)
                )
        return outcomes


def _timed(fn: Callable[[], object]) -> float:
    """Wall seconds of ``fn()`` up to the end of its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def measure_spmv_replay(
    sp,
    n_requests: int,
    width: int,
    rng: np.random.Generator,
    repeats: int = 1,
) -> Dict[str, float]:
    """Coalesced vs. sequential dispatch of ``n_requests`` solves on the card.

    ``sp`` is a CUDA :class:`~repro_torch.sparse.spmv.DistributedSpMV`.  The
    right-hand sides go to the device once, as contiguous column slices of
    ``width`` (coalesced) and of one (sequential).  Returns wall seconds per
    path (best of ``repeats``, after one warm-up run of each), the realized
    throughput speedup, and the max absolute difference between the
    coalesced and per-request results (``parity``).
    """
    if n_requests < 1 or width < 1:
        raise ValueError("n_requests and width must be >= 1")
    if sp.device.type != "cuda":
        raise ValueError(f"measure_spmv_replay times the card; the operator is on {sp.device}")
    topo = sp.topo
    L = sp.rows_per_rank
    V = torch.as_tensor(
        rng.standard_normal((topo.nranks, L, n_requests)).astype(np.float32), device=sp.device
    )
    wide = [V[:, :, a : min(a + width, n_requests)].contiguous()
            for a in range(0, n_requests, width)]
    single = [V[:, :, i : i + 1].contiguous() for i in range(n_requests)]

    def coalesced() -> List[torch.Tensor]:
        return [sp.matmat(x) for x in wide]

    def sequential() -> List[torch.Tensor]:
        return [sp.matmat(x) for x in single]

    co = torch.cat(coalesced(), dim=-1)
    seq = torch.cat(sequential(), dim=-1)
    parity = float((co - seq).abs().max())

    t_co = min(_timed(coalesced) for _ in range(repeats))
    t_seq = min(_timed(sequential) for _ in range(repeats))
    return {
        "coalesced_s": t_co,
        "sequential_s": t_seq,
        "speedup": t_seq / t_co if t_co > 0 else 0.0,
        "parity": parity,
        "n_requests": float(n_requests),
        "width": float(width),
    }
