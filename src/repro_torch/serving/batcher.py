"""Continuous batching over cached plans.

The batcher turns per-fingerprint FIFO lanes into *batches*: contiguous
prefixes of one lane, coalesced up to a per-class width cap and dispatched
either when the lane is full or when its oldest request has waited the
coalescing ``window``.  Each batch is advised as ONE exchange at the
combined payload width (``base_width * n_requests``), so the strategy/codec
choice sees the batched byte terms the paper's model flips on -- coalescing
trades per-request latency (bounded by the window) for fewer, larger
messages, which is exactly the message-count vs. message-size axis of
Table 7.

Scheduling invariants (property-tested in ``tests/test_serving.py``):

* width never exceeds ``max_width`` or the memory budget
  (``n * bytes_per_request <= memory_budget``);
* FIFO within a fingerprint class (batches are lane prefixes);
* no request waits past its coalescing deadline once the executor keeps up
  (a ripe lane is always preferred over an unripe one, oldest deadline
  first);
* all decisions are pure functions of (queue contents, virtual now), so a
  seeded simulation replays bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch import tracing
from repro_torch.core.advisor import EXECUTABLE_STRATEGY, Advice, advise_stats

from .queue import RequestQueue
from .request import Request, WorkloadClass


@dataclasses.dataclass(frozen=True)
class Batch:
    """One coalesced dispatch: a FIFO prefix of a single fingerprint lane."""

    fp: str
    requests: Tuple[Request, ...]
    payload_width: int  # base_width * len(requests): the advisor/executor k
    resident_bytes: int
    strategy: str  # executable strategy name ("standard", "two_step", ...)
    wire: str  # wire codec name ("none" = full precision)
    key: str  # full recommendation key, e.g. "two_step/device_aware+wire:bf16"
    predicted_time: float  # advisor-modeled exchange seconds at payload_width
    kind: str

    @property
    def width(self) -> int:
        """Number of coalesced requests."""
        return len(self.requests)


class ContinuousBatcher:
    """Coalesce same-fingerprint requests under a window and memory budget."""

    def __init__(
        self,
        classes: Dict[str, WorkloadClass],
        queue: Optional[RequestQueue] = None,
        *,
        window: float = 1e-3,
        max_width: int = 8,
        memory_budget: Optional[int] = None,
        machine: str = "tpu_v5e_pod",
        wire=None,
        health=None,
        strategy: Optional[str] = None,
    ) -> None:
        if not classes:
            raise ValueError("ContinuousBatcher needs at least one WorkloadClass")
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if max_width < 1:
            raise ValueError(f"max_width must be >= 1, got {max_width}")
        executable = set(EXECUTABLE_STRATEGY.values())
        if strategy is not None and strategy not in executable:
            raise ValueError(
                f"unknown strategy {strategy!r}; known: {sorted(executable)}"
            )
        self.classes = dict(classes)
        self.queue = queue if queue is not None else RequestQueue()
        self.window = float(window)
        self.max_width = int(max_width)
        self.memory_budget = None if memory_budget is None else int(memory_budget)
        self.machine = machine
        self.wire = wire
        self.health = health
        #: None lets the advisor pick per batch; an executable strategy name
        #: pins it (the ranking still chooses codec/transport within it)
        self.strategy = strategy
        self.batches = 0
        self.coalesced = 0  # requests dispatched in batches of width >= 2
        self._advice: Dict[Tuple[str, int], Advice] = {}
        self.advice_hits = 0
        self.advice_misses = 0
        for fp, cls in self.classes.items():
            if cls.fp != fp:
                raise ValueError(f"class key {fp!r} != class fingerprint {cls.fp!r}")
            if self.width_cap(fp) < 1:
                raise ValueError(
                    f"memory budget {self.memory_budget} cannot hold one "
                    f"request of class {fp!r} ({cls.bytes_per_request} bytes)"
                )

    def width_cap(self, fp: str) -> int:
        """Max requests one batch of class ``fp`` may coalesce."""
        cap = self.max_width
        if self.memory_budget is not None:
            cap = min(cap, self.memory_budget // self.classes[fp].bytes_per_request)
        return cap

    def submit(self, req: Request) -> bool:
        if req.fp not in self.classes:
            raise KeyError(f"unknown fingerprint class {req.fp!r}")
        return self.queue.submit(req)

    def advise(self, fp: str, n_requests: int) -> Advice:
        """Advisor ranking for a batch of ``n_requests`` of class ``fp``,
        memoized per (fp, width) -- the serving analogue of the plan cache."""
        key = (fp, n_requests)
        cached = self._advice.get(key)
        if cached is not None:
            self.advice_hits += 1
            return cached
        self.advice_misses += 1
        cls = self.classes[fp]
        adv = advise_stats(
            cls.stats,
            machine=self.machine,
            payload_width=cls.base_width * n_requests,
            wire=self.wire,
            health=self.health,
        )
        self._advice[key] = adv
        return adv

    def readvise(self, fp: str, n_requests: int) -> Advice:
        """Recompute a lane's advice under the CURRENT health penalties and
        overwrite the memo -- the executor's re-advise rung calls this after
        an integrity failure so subsequent batches of the class inherit the
        re-ranked (strategy, codec) instead of the pre-fault choice."""
        self._advice.pop((fp, n_requests), None)
        return self.advise(fp, n_requests)

    def next_deadline(self, now: float) -> Optional[float]:
        """Earliest instant at which some queued lane becomes ripe, or None
        if the queue is empty.  Lanes already ripe return ``now``."""
        best = None
        for fp, depth, oldest in self.queue.lanes():
            t = oldest + self.window if depth < self.width_cap(fp) else now
            if best is None or t < best:
                best = t
        return None if best is None else max(best, now)

    def next_batch(self, now: float) -> Optional[Batch]:
        """Dispatch the ripest lane, or None if nothing is ripe at ``now``.

        A lane is ripe when its oldest request has aged past the coalescing
        window or the lane already fills a whole batch.  Among ripe lanes
        the oldest deadline wins (fingerprint breaks ties), which is what
        bounds per-class waiting: a lane at its deadline can be overtaken
        only by lanes with even older deadlines.
        """
        ripe = []  # (deadline, fp)
        for fp, depth, oldest in self.queue.lanes():
            deadline = oldest + self.window
            if deadline <= now or depth >= self.width_cap(fp):
                ripe.append((deadline, fp))
        if not ripe:
            return None
        _, fp = min(ripe)
        with tracing.span("repro_torch.serve.batch"):
            return self._take(fp, now)

    def _take(self, fp: str, now: float) -> Batch:
        """Take lane ``fp``'s batch at ``now``: its FIFO prefix, advised."""
        cls = self.classes[fp]
        reqs = tuple(self.queue.take(fp, self.width_cap(fp)))
        adv = self.advise(fp, len(reqs))
        best = adv.best
        if self.strategy is not None:
            # pinned strategy: fastest variant (transport/codec) within it
            best = next(
                r for r in adv.ranked
                if EXECUTABLE_STRATEGY[r.strategy] == self.strategy
            )
        self.batches += 1
        if len(reqs) >= 2:
            self.coalesced += len(reqs)
        if tracing.active():
            tracing.count("serve.queue_wait_s", sum(now - r.arrival for r in reqs))
        return Batch(
            fp=fp,
            requests=reqs,
            payload_width=cls.base_width * len(reqs),
            resident_bytes=cls.bytes_per_request * len(reqs),
            strategy=EXECUTABLE_STRATEGY[best.strategy],
            wire=best.wire,
            key=best.key,
            predicted_time=best.predicted_time,
            kind=cls.kind,
        )
