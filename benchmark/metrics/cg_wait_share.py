"""cg_wait_share.*: the share of a load case (`solid.case` span) that the
host spends in `cg.wait`, blocked on the host read of the CG's stopping
test, in %, over the load case of the run's program trace
(harness/program_trace.py). Declared better higher: while the card waits
for the host, as in every cell so far (idle 84-96 %), the wait is near 0
and a faster host raises it as case_s falls. Once the card sets the pace
the sense reverses (a faster card lowers it with case_s), so read it
beside idle_share.*."""

from harness import program_trace

FROM_TRACE = True


def read(run, reg, name):
    trace = program_trace.read(run)
    case = sum(program_trace.durations(trace, "solid.case"))
    if not case:
        return None
    return 100.0 * sum(program_trace.durations(trace, "cg.wait")) / case
