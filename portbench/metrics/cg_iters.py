"""Mean iterations per solve, from the window's ``SolveResult``s."""


def read(run):
    n = run.window.get("solves", 0)
    return run.window["iterations"] / n if n else None
