"""Reads of device state per fused solve in the profiled stretch: the
program's counter ``solve.host_reads`` over the stretch's solves
(``Profile.extra``)."""

from portbench.metrics import program


def read(run):
    if run.profile is None:
        return None
    reads, solves = program.counters().get("solve.host_reads"), run.profile.extra.get("solves")
    return reads / solves if reads and solves else None
