"""Host ms to enqueue one batch through the executor's ladder, the
exchange and kernel B2: the mean length of the ``repro_torch.serve.execute``
spans of the profiled stretch."""

from portbench.metrics import program

SPAN = "repro_torch.serve.execute"


def read(run):
    spans = program.spans(run, SPAN)
    return sum(e - s for s, e in spans) / len(spans) / 1e6 if spans else None
