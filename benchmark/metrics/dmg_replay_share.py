"""dmg_replay_share.*: the share of the distributed V-cycle's calls that
replayed its CUDA graph, in the load case of the run's program trace
(harness/program_trace.py), in %: the program's `dmg.graph_replays`
counter over its `dmg.vcycle_calls` (DistributedMultigrid's calls on the
trace's rank). A program without the replay counter (one that never
replays the distributed V-cycle, or runs it under gloo) reads nothing."""

from harness import program_trace

FROM_TRACE = True


def read(run, reg, name):
    trace = program_trace.read(run)
    if trace is None:
        return None
    calls = trace["counters"].get("dmg.vcycle_calls")
    replays = trace["counters"].get("dmg.graph_replays")
    if not calls or replays is None:
        return None
    return 100.0 * replays / calls
