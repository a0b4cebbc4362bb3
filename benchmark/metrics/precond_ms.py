"""precond_ms.*: milliseconds of the preconditioner per CG iteration: the
program's `cg.precond` spans (the f32 V-cycle of StructuredMultigrid or the
LatticePreconditioner, with the casts to and from float32, as the CG
applies it), each timed on the card's stream from its start event to its
end event, summed over the load case of the run's program trace
(harness/program_trace.py) and divided by the program's `cg.iterations`
counter. While the card waits for the host this is the host's time in the
call; once the host runs ahead it is the card's time for the call's work,
never the cost of its launches alone."""

from harness import program_trace

FROM_TRACE = True


def read(run, reg, name):
    trace = program_trace.read(run)
    d = program_trace.stream_durations(trace, "cg.precond")
    iters = trace["counters"].get("cg.iterations") if trace is not None else None
    return 1e3 * sum(d) / iters if d and iters else None
