"""Mean ms a request waited in the batcher's queue, from its arrival to
its batch's dispatch, in the profiled stretch: the program's counter
``serve.queue_wait_s`` over the requests dispatched in the stretch
(``Profile.extra``)."""

from portbench.metrics import program


def read(run):
    if run.profile is None:
        return None
    wait_s, requests = program.counters().get("serve.queue_wait_s"), run.profile.extra.get("units")
    return 1e3 * wait_s / requests if wait_s is not None and requests else None
