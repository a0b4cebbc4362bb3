"""The program's own spans and counters (femx_torch.profiling) in a traced
run, taken once and kept on the run as `run.program_trace`.

After the traced requests of `cells._traced`, the run's traced request goes
twice more, the program's tracing on:

1. without the profiler: `collect()` gives the spans and counters on the
   host clock, and each span's time on the card's stream (two CUDA events,
   `enable(device)`): the per-layer readers' numbers;
2. under torch.profiler (host and device): each device idle gap inside the
   request is put down to the program spans open at its middle, read from
   the spans' own record_function ranges on the profiler's clock, beside
   the kernels.

A cases cell sends its request through the analysis of set-up
(`solve_cases`); an analyses cell builds a new model (seed 0: the seed only
draws the node order of a relabelling route) and runs `run_simulation()`.
Neither touches `run.profile`, `run.spans` or `run.answers`, and tracing
is off again before it returns. On the ranks of a devices=N cell past
rank 0, pass 2 sends its request without torch.profiler. On a run without
a card, or with a program that has no recorder, it is None and sends
nothing.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from harness import cells
from harness import device as dev_mod

LABEL = "benchmark.program_traced"
OUTSIDE = "(outside every span)"


def read(run) -> Optional[dict]:
    """{"spans", "counters" (pass 1), "idle" (pass 2, idle_by_span's),
    "info" (the program's record of each pass' solve), "request_s" (pass 1
    on the host clock, the card synchronized)} or None."""
    if not hasattr(run, "program_trace"):
        run.program_trace = _take(run)
    return run.program_trace


def durations(trace: Optional[dict], name: str) -> List[float]:
    """Seconds of each span `name` of pass 1, on the host clock."""
    if trace is None:
        return []
    return [(s["end_ns"] - s["start_ns"]) * 1e-9 for s in trace["spans"] if s["name"] == name]


def stream_durations(trace: Optional[dict], name: str) -> List[float]:
    """Seconds of each span `name` of pass 1 on the card's stream (from its
    start event to its end event), where the program gives them."""
    if trace is None:
        return []
    return [s["device_ns"] * 1e-9 for s in trace["spans"]
            if s["name"] == name and s.get("device_ns") is not None]


def _recorder():
    try:
        from femx_torch import profiling
    except ImportError:
        return None
    have = all(hasattr(profiling, n) for n in ("enable", "disable", "collect", "span"))
    return profiling if have else None


def _request(run):
    """A function that sends the cell's traced request once and returns the
    program's record of its solve, or None."""
    if not run.answers:
        return None
    req = run.answers[-1].loads
    if run.mix["kind"] == "cases":
        fa = run.analysis
        if fa is None:
            return None

        def serve():
            fa.solve_cases([cells.program_loads(req)])
            return dict(fa.case_solve_info[0])

        return serve
    model = cells.Model(run.config, 0, run.device)

    def serve():
        fa = model.analysis(model.mesh([(p["x"], p["y"], p["z"]) for p in req]), req)
        fa.run_simulation()
        return dict(fa.solve_info)

    return serve


def _take(run) -> Optional[dict]:
    if run.device.type != "cuda":
        return None
    prof = _recorder()
    serve = _request(run) if prof is not None else None
    if serve is None:
        return None
    dev_mod.sync(run.device)
    prof.enable(run.device)
    try:
        t0 = time.perf_counter()
        info = serve()
        dev_mod.sync(run.device)
        request_s = time.perf_counter() - t0
        rec = prof.collect()
        if run.leads:
            info2, idle = _profiled(serve, run.device, prof)
        else:  # another rank of N: the same request, bare
            info2, idle = serve(), idle_by_span([], [], (0.0, 0.0))
    finally:
        prof.disable()
        prof.collect()
    out = {"spans": rec["spans"], "counters": rec["counters"], "idle": idle,
           "info": [info, info2], "request_s": request_s}
    if run.leads:
        _report(run, out)
    return out


def _profiled(serve, device, prof):
    """The request under torch.profiler, tracing on without CUDA events (the
    trace holds the program's work alone): (its record, the idle
    attribution)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    prof.enable()
    dev_mod.sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        with record_function(LABEL):
            info = serve()
            dev_mod.sync(device)
    names = {s["name"] for s in prof.collect()["spans"]}
    events = p.profiler.kineto_results.events()
    mark = next(e for e in events if e.name() == LABEL and e.device_type() == DeviceType.CPU)
    thread = mark.start_thread_id()
    spans, dev = [], []
    for e in events:
        if e.name() == LABEL:
            continue
        if e.is_user_annotation():
            if (e.device_type() == DeviceType.CPU and e.start_thread_id() == thread
                    and e.name() in names):
                spans.append((e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3))
    window = (mark.start_ns() * 1e-3, mark.end_ns() * 1e-3)
    del events, p
    return info, idle_by_span(spans, dev, window)


def idle_by_span(spans: Sequence[Tuple[str, float, float]],
                 device: Sequence[Tuple[float, float]],
                 window: Tuple[float, float]) -> dict:
    """Device idle time inside `window` by program span, all in us in and
    seconds out. `spans` are (name, start, end) host ranges that nest;
    `device` the (start, end) of the device's operations. Each gap between
    the union of the device intervals is put down to the spans open at its
    middle: "innermost" sums it under the innermost one (OUTSIDE where none
    is open), "under" under every distinct name open (a span and its
    descendants). Returns {"idle_s", "innermost", "under"}."""
    w0, w1 = window
    merged = dev_mod._union([(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1])
    gaps, prev = [], w0
    for s, e in merged + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    innermost: Dict[str, float] = defaultdict(float)
    under: Dict[str, float] = defaultdict(float)
    for (s, e), names in zip(gaps, _open_at(spans, [0.5 * (s + e) for s, e in gaps])):
        dt = (e - s) * 1e-6
        innermost[names[-1] if names else OUTSIDE] += dt
        for n in set(names):
            under[n] += dt
    return {"idle_s": sum((e - s) for s, e in gaps) * 1e-6, "innermost": dict(innermost),
            "under": dict(under)}


def _open_at(spans, points) -> List[Tuple[str, ...]]:
    """For each time point, the names of the spans open at it, outermost
    first (the spans nest)."""
    evs = sorted(spans, key=lambda x: (x[1], -x[2]))
    out: List[Tuple[str, ...]] = [()] * len(points)
    stack: list = []
    i = 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        t = points[j]
        while i < len(evs) and evs[i][1] <= t:
            while stack and stack[-1][2] <= evs[i][1]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[j] = tuple(ev[0] for ev in stack)
    return out


def _report(run, out) -> None:
    """The program trace's summary on standard error: each pass' iterations
    and residual beside the window's, the request's seconds traced and
    untraced, the spans recorded, and the idle time by span."""
    def solve(i):
        return {k: i.get(k) for k in ("iterations", "residual", "precond_setup_s", "solve_s")
                if k in i}

    window = sorted({(a.info.get("iterations"), a.info.get("residual"))
                     for a in run.answers if "iterations" in a.info})
    idle = out["idle"]
    host, stream = durations(out, "cg.precond"), stream_durations(out, "cg.precond")
    line = {"passes": [solve(i) for i in out["info"]], "window_solves": window[:8],
            "precond_calls": len(host),
            "precond_host_ms_per_call": 1e3 * sum(host) / len(host) if host else None,
            "precond_stream_ms_per_call": 1e3 * sum(stream) / len(stream) if stream else None,
            "request_s_traced": out["request_s"],
            "request_s_untraced": (run.profile or {}).get("window_s"),
            "spans": len(out["spans"]), "counters": out["counters"], "idle_s": idle["idle_s"],
            "idle_innermost": dict(sorted(idle["innermost"].items(), key=lambda kv: -kv[1])),
            "idle_under": dict(sorted(idle["under"].items(), key=lambda kv: -kv[1]))}
    print("program trace " + json.dumps(line), file=sys.stderr)
