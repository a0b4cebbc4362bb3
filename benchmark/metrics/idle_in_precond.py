"""idle_in_precond.*: the device's idle time inside the program's
`cg.precond` span or its descendants, over all its idle time in the load
case that the run's program trace sends under the profiler
(harness/program_trace.py), in %: how much of the card's idling the
preconditioner's host work accounts for."""

from harness import program_trace

FROM_TRACE = True


def read(run, reg, name):
    trace = program_trace.read(run)
    if trace is None or not trace["idle"]["idle_s"] or "cg.precond" not in trace["idle"]["under"]:
        return None
    return 100.0 * trace["idle"]["under"]["cg.precond"] / trace["idle"]["idle_s"]
