"""Share of the profiled stretch in which no device event ran (the union
of the kernels' and copies' intervals).  One reader for every cell: a
metric named ``idle_share.<suffix>`` is read here."""


def read(run):
    share = None if run.profile is None else run.profile.idle_share()
    return None if share is None else 100.0 * share
