"""precond_setup_s.*: seconds of the program's `solid.precond_setup` span
(the preconditioner's set-up inside solve(), ending on a synchronization
of the card) in the analysis of the run's program trace
(harness/program_trace.py)."""

from harness import program_trace

FROM_TRACE = True


def read(run, reg, name):
    d = program_trace.durations(program_trace.read(run), "solid.precond_setup")
    return sum(d) if d else None
