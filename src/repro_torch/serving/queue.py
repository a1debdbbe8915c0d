"""Fingerprint-keyed request queue with admission control.

Requests enter through :meth:`RequestQueue.submit`, which consults an
:class:`repro_torch.runtime.AdmissionController` against the *total* backlog --
overload sheds load instead of growing an unbounded queue, and sustained
shedding escalates through the straggler watchdog's control plane.  Admitted
requests land in per-fingerprint FIFO lanes, which is the invariant the
batcher's coalescing relies on: a batch is always a contiguous FIFO prefix
of one lane, so requests within a class complete in arrival order.
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.runtime import AdmissionController

from .request import Request


class RequestQueue:
    """Per-fingerprint FIFO lanes behind one admission gate."""

    def __init__(self, admission: Optional[AdmissionController] = None) -> None:
        self.admission = admission if admission is not None else AdmissionController()
        self._lanes: Dict[str, Deque[Request]] = {}
        self._depth = 0

    def __len__(self) -> int:
        return self._depth

    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; False means the admission controller shed it."""
        if not self.admission.admit(self._depth):
            return False
        self._lanes.setdefault(req.fp, collections.deque()).append(req)
        self._depth += 1
        return True

    def lanes(self) -> List[Tuple[str, int, float]]:
        """Non-empty lanes as ``(fp, depth, oldest_arrival)``, sorted by
        fingerprint so iteration order never depends on dict history."""
        return sorted(
            (fp, len(lane), lane[0].arrival)
            for fp, lane in self._lanes.items()
            if lane
        )

    def peek_oldest(self, fp: str) -> Optional[Request]:
        lane = self._lanes.get(fp)
        return lane[0] if lane else None

    def take(self, fp: str, n: int) -> List[Request]:
        """Dequeue up to ``n`` requests from the front of lane ``fp``."""
        lane = self._lanes.get(fp)
        if not lane:
            return []
        out = []
        while lane and len(out) < n:
            out.append(lane.popleft())
        self._depth -= len(out)
        if not lane:
            del self._lanes[fp]
        return out
