"""solve_stage_s.*: mean seconds of solve() per analysis of a traced
window: preconditioner set-up, the float64 operator, CG and reactions; it
ends in a host read of the answer."""

from harness.readers import mean_span


def read(run, reg, name):
    return mean_span(run, "solve")
