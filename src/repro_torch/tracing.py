"""Spans and counters inside the port, on the profiler's clock.

Run the code under ``torch.profiler.profile(activities=[CPU, CUDA])``. The
spans then appear by name on the timeline beside the kernels they launch,
and :func:`counters` and :func:`stream_ms` hold the session's counts.

Tracing is on exactly while a profiler session records, and at no other
time: no option or environment variable turns it on.  Off, a span costs
one bool check and returns a shared no-op context; a counter and a stream
interval record nothing.  On:

* :func:`span` is a ``torch.profiler.record_function`` range.  Kineto
  stamps it on the same clock as the device's events, so an idle gap of the
  card sits under the innermost span the host was in.  Every span name
  starts with ``repro_torch.``.
* :func:`count` adds to an in-memory counter (names without the prefix).
* :func:`stream_interval` records a pair of timing CUDA events on the
  current stream around its body (not while the stream captures a graph:
  a captured body replays without its Python, so the port's graph replays
  hold no interval).  It times the stream from its first op to its last:
  where the stream has caught up with the host when the body starts, that
  includes the host's time enqueuing the body.  Finished intervals are
  read back as the session goes on, without waiting; the rest when
  :func:`stream_ms` asks.

The counts and intervals are those of the current session, or of the last
one once it has ended: a session's first record forgets what an earlier
session left, provided the module has seen the profiler off since (a read
of :func:`counters` or :func:`stream_ms`, or a count, with no session
recording).  Between two sessions that follow each other with none of
these in between, the counts run on.

The spans and counters of the port:

========================== ===========================================
``solve.fused``            a fused CG / BiCGStab solve, whole
``solve.rhs_norm``         the rhs norm's dot and its host read
``solve.entry``            the cached solve's key, lookup or build
``solve.init``             the init section (one replay on CUDA)
``solve.blocks``           the block replays and their flag reads
``solve.unpack``           the final read of the solver's state
(no span)                  counter ``solve.host_reads``: every read of
                           device state by a fused solve
``serve.batch``            ``ContinuousBatcher.next_batch`` once a lane is
                           ripe; counter ``serve.queue_wait_s`` (arrival
                           to dispatch, on the caller's clock)
``serve.execute``          ``BatchExecutor.execute_resilient``, whole
``spmv.matvec``,           ``DistributedSpMV`` products
``spmv.matmat``
``spmv.compute``           their local compute (kernels B1 / B2)
``exchange.run``           ``IrregularExchange`` calls; stream interval
                           ``exchange``
========================== ===========================================
"""

from __future__ import annotations

import collections
import contextlib
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
#: intervals left unread past which a new one reads back those finished
_HARVEST = 64
_counters: Dict[str, float] = {}
#: recorded intervals not read back yet, oldest first: (name, start, end)
_pending: Deque[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = collections.deque()
_resolved: Dict[str, List[float]] = {}
_pool: List[torch.cuda.Event] = []
#: whether the records belong to a session the module last saw recording
_open = False


def active() -> bool:
    """Whether a profiler session is recording."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a session records, else a
    shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def _recording() -> bool:
    """Whether a session records; its first record forgets an earlier
    session's counts and intervals."""
    global _open
    if not _profiler._is_profiler_enabled:
        _open = False
        return False
    if not _open:
        reset()
        _open = True
    return True


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` while a session records."""
    if _recording():
        _counters[name] = _counters.get(name, 0) + n


class _Interval:
    """Timing events around a body, recorded on ``device``'s current stream."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.stream = name, torch.cuda.current_stream(device)
        self.start, self.end = _event(), _event()

    def __enter__(self):
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc) -> None:
        self.end.record(self.stream)
        _pending.append((self.name, self.start, self.end))
        if len(_pending) > _HARVEST:
            _settle(wait=False)


def _event() -> torch.cuda.Event:
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


def _settle(wait: bool) -> None:
    """Read back the pending intervals, oldest first, and return their
    events to the pool: all of them, waiting for the stream (``wait``), or
    those finished so far."""
    while _pending:
        key, start, end = _pending[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        _resolved.setdefault(key, []).append(start.elapsed_time(end))
        _pool.extend((start, end))
        _pending.popleft()


def stream_interval(name: str, device: Optional[torch.device]):
    """Stream time of the body on ``device``'s current stream, kept under
    ``name`` while a session records (a no-op off the card, and while the
    stream captures a graph)."""
    if (not _recording() or device is None or device.type != "cuda"
            or torch.cuda.is_current_stream_capturing()):
        return _OFF
    return _Interval(name, device)


def counters() -> Dict[str, float]:
    """The counters of the current or last session."""
    _recording()
    return dict(_counters)


def stream_ms(name: str) -> List[float]:
    """The milliseconds of each interval recorded under ``name`` in the
    current or last session, in order.  Waits for the intervals not yet
    read back (their streams' work up to them)."""
    _recording()
    _settle(wait=True)
    return list(_resolved.get(name, ()))


def reset() -> None:
    """Forget every counter and interval."""
    _pool.extend(ev for _, start, end in _pending for ev in (start, end))
    _counters.clear()
    _pending.clear()
    _resolved.clear()
