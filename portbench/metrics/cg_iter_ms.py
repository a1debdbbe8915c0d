"""Wall ms per CG iteration: the window's wall time over the iterations of
all the solves it completed."""


def read(run):
    it = run.window.get("iterations", 0)
    return run.window["elapsed_s"] * 1e3 / it if it else None
