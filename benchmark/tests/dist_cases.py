"""Shared by the tests of the multi-card cell (not a test file): a rank
function that runs a devices=N cell of the small copy traced on the CPU,
with the program trace taken there too."""

from bench_cases import small_rank


def _take_on_cpu(run):
    """harness.program_trace's two passes without a card: pass 1 on the
    host clock, each span's host time standing in for its stream time
    (the CPU has no stream), and pass 2 under torch.profiler on rank 0."""
    from harness import program_trace

    prof = program_trace._recorder()
    serve = program_trace._request(run)
    if prof is None or serve is None:
        return None
    prof.enable()
    try:
        info = serve()
        rec = prof.collect()
        if run.leads:
            info2, idle = program_trace._profiled(serve, run.device, prof)
        else:
            info2, idle = serve(), program_trace.idle_by_span([], [], (0.0, 0.0))
    finally:
        prof.disable()
        prof.collect()
    for s in rec["spans"]:
        s["device_ns"] = s["end_ns"] - s["start_ns"]
    return {"spans": rec["spans"], "counters": rec["counters"], "idle": idle,
            "info": [info, info2], "request_s": None}


def traced_cpu_rank(*args):
    """bench_cases.small_rank, its program trace taken on the CPU."""
    from harness import program_trace

    program_trace._take = _take_on_cpu
    return small_rank(*args)
