"""Requests per dispatched batch over the window, from the batcher's batch
counter and the requests its batches carried."""


def read(run):
    batches = run.window.get("batches", 0)
    return run.window["dispatched"] / batches if batches else None
