"""Wall ms per solve: the window's wall time, up to the end of its last
solve, over the solves completed in it (a rate over the whole window, not
a median of solves)."""


def read(run):
    n = run.window.get("solves", 0)
    return run.window["elapsed_s"] * 1e3 / n if n else None
