"""vcycle_replay_share.*: the share of the V-cycle calls that replayed the
hierarchy's CUDA graph, in the load case of the run's program trace
(harness/program_trace.py), in %: the program's `mg.graph_replays` counter
over its `mg.vcycle_calls` (StructuredMultigrid's calls, both routes; the
lattice preconditioner makes two a call). A program without the counters
reads nothing."""

from harness import program_trace

FROM_TRACE = True


def read(run, reg, name):
    trace = program_trace.read(run)
    calls = trace["counters"].get("mg.vcycle_calls") if trace is not None else None
    if not calls:
        return None
    return 100.0 * trace["counters"].get("mg.graph_replays", 0) / calls
