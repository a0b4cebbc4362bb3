"""collective_share.*: the share of a load case that the collectives take
on the card's stream, in %: the stream time of the program's `comm.*`
spans (femx_torch.parallel.comm's all_reduce, all_gather and exchange)
that no other `comm.*` span holds, over the stream time of its
`solid.case` spans, in the load case of the run's program trace
(harness/program_trace.py), on the rank that reads it (rank 0 in the
result line). Under NCCL torch makes the rank's stream wait for each
collective, so a span holds the wait for the other ranks and the
transfer; under gloo the host blocks in the collective, and the span
holds the host's time. A program without the spans, or a run without the
spans' stream times, reads nothing."""

from harness import program_trace

FROM_TRACE = True
PREFIX = "comm."


def _outermost(span, by_id) -> bool:
    """Whether no comm.* span holds `span`."""
    up = by_id.get(span["parent"])
    while up is not None:
        if up["name"].startswith(PREFIX):
            return False
        up = by_id.get(up["parent"])
    return True


def read(run, reg, name):
    trace = program_trace.read(run)
    if trace is None:
        return None
    spans = trace["spans"]
    by_id = {s["id"]: s for s in spans}
    case = [s["device_ns"] for s in spans if s["name"] == "solid.case"]
    comm = [s["device_ns"] for s in spans
            if s["name"].startswith(PREFIX) and _outermost(s, by_id)]
    if not case or not comm or None in case or None in comm or not sum(case):
        return None
    return 100.0 * sum(comm) / sum(case)
