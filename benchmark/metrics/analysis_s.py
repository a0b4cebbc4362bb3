"""analysis_s: the whole window over the analyses completed in it, each
from its load points to its reactions (mesh, assembly, supports and loads,
preconditioner set-up, solve, reactions). Host clock."""

from harness import readers


def read(run, reg, name):
    n = readers.completed(run)
    if run.mix["kind"] != "analyses" or not n:
        return None
    return run.window_s / n
