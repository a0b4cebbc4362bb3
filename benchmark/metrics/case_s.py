"""case_s: the whole window over the load cases completed in it. Host
clock; the window ends when the last case started in it is answered."""

from harness import readers


def read(run, reg, name):
    n = readers.completed(run)
    if run.mix["kind"] != "cases" or not n:
        return None
    return run.window_s / n
