"""Stream ms per batch from the exchange's first op to its last: the
program's ``exchange`` stream intervals of the profiled stretch summed,
over the stretch's batches (``Profile.extra``).  An interval that
starts while the stream has caught up with the host also holds the
host's time enqueuing the exchange, so this bounds the exchange's device
time from above."""

from portbench.metrics import program


def read(run):
    if run.profile is None:
        return None
    batches = len(run.profile.extra.get("batch_widths", ()))
    ms = program.stream_ms("exchange")
    return sum(ms) / batches if batches and ms else None
