"""Errors kept past the frame that caught them."""

from __future__ import annotations

import traceback


def detached(error: BaseException) -> BaseException:
    """``error``, and the errors it was raised from or while handling, with
    each traceback's text kept as a note and the traceback itself dropped.
    A traceback holds the frame that caught the error and, through
    ``f_back``, every frame above it: an object that kept one would keep
    those frames' locals alive (a schedule's payloads, a checkpoint's host
    snapshot), in a reference cycle freed only when the collector ran."""
    pending, seen = [error], set()
    while pending:
        e = pending.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        if e.__traceback__ is not None:
            e.add_note("".join(traceback.format_tb(e.__traceback__)).rstrip())
            e.__traceback__ = None
        pending += [e.__cause__, e.__context__]
    return error
