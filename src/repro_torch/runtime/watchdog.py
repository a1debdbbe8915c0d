"""Straggler detection and admission control for the step and serving loops.

Synchronous steps make a slow host show up as a slow *step*.  The watchdog
keeps an EMA of step wall-time and flags steps beyond ``factor x EMA`` as
straggler events; after ``budget`` consecutive events (straggler steps,
integrity failures from :class:`repro_torch.comm.faults.HealthTracker`, or
admission overload) it reports the escalation budget exhausted, which is
the trainer's cue to checkpoint and restart
(:class:`repro_torch.runtime.trainer.Trainer`).  A copy of the reference's
``runtime/watchdog.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    factor: float = 3.0
    budget: int = 3  # consecutive straggler steps before escalation
    decay: float = 0.9

    ema: Optional[float] = None
    consecutive: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> bool:
        """Returns True if the escalation budget is exhausted.

        Raises :class:`RuntimeError` if no step is open (``start_step`` was
        never called, or this is the second ``end_step`` in a row) instead of
        crashing with ``TypeError`` on the ``None`` timestamp.
        """
        if self._t0 is None:
            raise RuntimeError(
                "StragglerWatchdog.end_step called with no open step; "
                "call start_step() first"
            )
        dt = time.monotonic() - self._t0
        self._t0 = None
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = dt > self.factor * self.ema
        if is_straggler:
            self.consecutive += 1
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        else:
            self.consecutive = 0
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return self.consecutive >= self.budget

    def record_external(self, kind: str, info: Optional[dict] = None) -> bool:
        """Record a non-timing health event (e.g. an exchange integrity
        failure from :class:`repro_torch.comm.faults.HealthTracker`) against the
        same escalation budget as straggler steps.

        Returns True if the budget is exhausted, mirroring ``end_step``.
        """
        self.consecutive += 1
        self.events.append({"kind": kind, **(info or {})})
        return self.consecutive >= self.budget


@dataclasses.dataclass
class AdmissionController:
    """Queue-depth admission control for the serving front-end.

    The multi-tenant batcher (:mod:`repro_torch.serving`) calls :meth:`admit`
    before enqueueing each request; past ``max_queue_depth`` the request is
    rejected (shed) instead of growing an unbounded backlog.  Sustained
    rejection pressure escalates through the SAME control plane as
    straggler steps: every ``reject_burst`` *consecutive* rejections records
    one external event against the shared :class:`StragglerWatchdog` budget,
    so an overload and a slow host reach the trainer's restart policy
    through one code path.

    Purely counter-based (no wall clock): admission decisions are a
    deterministic function of the call sequence, which the seeded traffic
    simulator relies on for bit-reproducible event traces.
    """

    max_queue_depth: int = 1024
    watchdog: Optional["StragglerWatchdog"] = None
    #: consecutive rejections per escalation event (debounce: one burst of
    #: shed requests is one control-plane event, not hundreds)
    reject_burst: int = 32

    admitted: int = 0
    rejected: int = 0
    shed: int = 0
    escalations: int = 0
    _consecutive_rejects: int = 0

    def __post_init__(self) -> None:
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}"
            )
        if self.reject_burst < 1:
            raise ValueError(f"reject_burst must be >= 1, got {self.reject_burst}")

    def admit(self, queue_depth: int) -> bool:
        """True iff a request may enter a queue currently ``queue_depth`` deep."""
        if queue_depth >= self.max_queue_depth:
            self.rejected += 1
            self._consecutive_rejects += 1
            if (
                self.watchdog is not None
                and self._consecutive_rejects % self.reject_burst == 0
            ):
                exhausted = self.watchdog.record_external(
                    "admission_overload",
                    {"rejected": self.rejected, "depth": queue_depth},
                )
                if exhausted:
                    self.escalations += 1
            return False
        self._consecutive_rejects = 0
        self.admitted += 1
        return True

    def record_shed(self, n_requests: int, info: Optional[dict] = None) -> None:
        """Count ``n_requests`` shed by an exhausted executor ladder.

        Fault-pressure sheds share the overload escalation budget: each
        shed batch is one external event against the watchdog, so a fault
        storm and a queue overload reach the trainer's restart policy
        through the same counter (``escalations``).
        """
        self.shed += int(n_requests)
        if self.watchdog is not None:
            if self.watchdog.record_external("batch_shed", info or {}):
                self.escalations += 1
