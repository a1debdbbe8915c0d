"""Card idle ms per solve while the host is inside the fused solver: for
each ``repro_torch.solve.fused`` span of the profiled stretch, its length
less the union of the device events inside it; the mean over the spans."""

from portbench.metrics import program

SPAN = "repro_torch.solve.fused"


def read(run):
    spans = program.spans(run, SPAN)
    if not spans:
        return None
    return sum(program.idle_ns(run, spans)) / len(spans) / 1e6
