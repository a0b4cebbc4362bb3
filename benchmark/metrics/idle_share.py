"""idle_share.*: 1 - (union of the intervals in which an operation ran
on the device) / (the traced window), in %. The busy intervals come from
the profiler's trace of the request a traced run sends after its window;
the window is the host-clock span of the same request sent just before
without the profiler, the card synchronized at both ends, so the
profiler's own host work does not count as idle."""


FROM_TRACE = True


def read(run, reg, name):
    p = run.profile
    if p is None or not p["window_s"] or run.device.type != "cuda":
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
