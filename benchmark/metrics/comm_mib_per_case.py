"""comm_mib_per_case.*: the bytes this rank hands to the collectives in a
load case, in MiB: the program's `comm.bytes` counter (femx_torch.parallel
.comm: the tensor each all_reduce and all_gather is given) over the
`solid.case` spans of the run's program trace (harness/program_trace.py),
on the rank that reads it (rank 0 in the result line). A program without
the counter or the spans reads nothing."""

from harness import program_trace

FROM_TRACE = True


def read(run, reg, name):
    trace = program_trace.read(run)
    if trace is None:
        return None
    cases = len(program_trace.durations(trace, "solid.case"))
    sent = trace["counters"].get("comm.bytes")
    if not cases or sent is None:
        return None
    return sent / 2 ** 20 / cases
