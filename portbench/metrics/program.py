"""What the program itself recorded in the profiled stretch: its spans
(``repro_torch.`` host events of the profile) and its counters and stream
intervals (``repro_torch.tracing``, which keeps those of the last profiler
session, and the profiled stretch is the run's only one).  A
program without that module or without the span reads as nothing: every
function here then returns an empty result rather than raising."""

from typing import Dict, List, Tuple

from portbench.trace import merged


def counters() -> Dict[str, float]:
    try:
        from repro_torch import tracing
    except ImportError:
        return {}
    return tracing.counters()


def stream_ms(name: str) -> List[float]:
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    return tracing.stream_ms(name)


def spans(run, name: str) -> List[Tuple[int, int]]:
    """``(start ns, end ns)`` of each host span ``name`` in the profiled
    stretch (none untraced)."""
    if run.profile is None:
        return []
    return [(s, e) for n, s, e in run.profile.host if n == name]


def idle_ns(run, spans: List[Tuple[int, int]]) -> List[int]:
    """Nanoseconds of each span in which no device event ran."""
    busy = merged(run.profile.device)
    return [(hi - lo) - sum(min(e, hi) - max(s, lo) for s, e in busy if e > lo and s < hi)
            for lo, hi in spans]
