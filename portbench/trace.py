"""Reading a ``torch.profiler`` session of a short stretch of the timed path.

The stretch is one ``record_function`` span (:data:`STRETCH`) around the
work.  Device events are read straight from the profiler's kineto results,
as ``key_averages()`` reads them (hidden and asynchronous events left out)
but without building its tree of host ops, which takes tens of seconds on
long traces.  Busy time is the union of the device events' intervals
inside the stretch, so overlapping kernels count once; the host's
``record_function`` spans that the profiler mirrors onto the device's
timeline are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

#: the host span that bounds the profiled stretch
STRETCH = "portbench.stretch"

Interval = Tuple[int, int]


@dataclasses.dataclass
class Profile:
    """What one profiled stretch recorded: device events as ``(name, start
    ns, end ns)``, host events likewise, the stretch's bounds, and what the
    driver counted while it ran (``extra``)."""

    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    stretch: Interval
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.stretch[1] - self.stretch[0]) / 1e9

    def busy_s(self) -> float:
        lo, hi = self.stretch
        return sum(min(e, hi) - max(s, lo) for s, e in merged(self.device) if e > lo and s < hi) / 1e9

    def idle_share(self) -> Optional[float]:
        """Share of the stretch in which no device event ran (None when the
        stretch holds no device event)."""
        if not self.device or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s() / self.window_s

    def kernel(self, pattern: str) -> Tuple[int, float]:
        """Count and total seconds of the device events whose name holds
        ``pattern``."""
        hits = [(s, e) for name, s, e in self.device if pattern in name]
        return len(hits), sum(e - s for s, e in hits) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds inside the stretch, summed by the innermost host
        event under each gap's midpoint (what the host was doing)."""
        lo, hi = self.stretch
        edges = [(s, e) for s, e in merged(self.device) if e > lo and s < hi]
        gaps, at = [], lo
        for s, e in edges:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        by: Dict[str, float] = {}
        for s, e in gaps:
            mid = (s + e) // 2
            under = [(he - hs, name) for name, hs, he in self.host if hs <= mid < he]
            name = min(under)[1] if under else "outside any host event"
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def merged(events) -> List[Interval]:
    """The union of the events' ``[start, end)`` intervals, sorted."""
    out: List[list] = []
    for s, e in sorted((ev[-2], ev[-1]) for ev in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def user_annotation(e) -> bool:
    """A ``record_function`` span mirrored onto the device's timeline: it
    spans the kernels launched inside it, and is no device work itself."""
    return bool(getattr(e, "is_user_annotation", lambda: False)()) or e.name().startswith("portbench.")


def read_profile(prof, extra: Optional[dict] = None) -> Profile:
    """The :class:`Profile` of a finished ``torch.profiler`` session that
    recorded one :data:`STRETCH` span.  A session with no device event
    raises: a traced run reports nothing rather than a zero."""
    from torch.autograd import DeviceType

    device, host, stretch = [], [], None
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)() or e.is_async():
            continue
        s, t = int(e.start_ns()), int(e.end_ns())
        if e.device_type() == DeviceType.CPU:
            if e.name() == STRETCH:
                stretch = (s, t)
            elif t > s:
                host.append((e.name(), s, t))
        elif (e.start_thread_id() == e.end_thread_id() and t > s and not user_annotation(e)):
            device.append((e.name(), s, t))
    if stretch is None:
        raise RuntimeError(f"the profile holds no {STRETCH!r} span")
    if not device:
        raise RuntimeError("torch.profiler recorded no device event in the traced stretch")
    return Profile(device=device, host=host, stretch=stretch, extra=dict(extra or {}))
