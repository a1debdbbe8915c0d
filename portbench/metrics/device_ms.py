"""Device ms per unit of work (a solve, a request) in the profiled stretch:
the card's busy time (the union of its device events) over the units the
driver counted there.  The host's pacing, which moves the end-to-end time
from run to run, does not enter it; a metric named ``device_ms.<suffix>``
is read here."""


def read(run):
    if run.profile is None or not run.profile.extra.get("units"):
        return None
    return 1e3 * run.profile.busy_s() / run.profile.extra["units"]
