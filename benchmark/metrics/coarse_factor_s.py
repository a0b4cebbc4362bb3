"""coarse_factor_s.*: seconds of the program's `mg.coarse_factor` spans
(the multigrid set-up's Cholesky of the coarsest matrix on the host, its
inverse and the inverse's upload) in the analysis of the run's program
trace (harness/program_trace.py)."""

from harness import program_trace

FROM_TRACE = True


def read(run, reg, name):
    d = program_trace.durations(program_trace.read(run), "mg.coarse_factor")
    return sum(d) if d else None
