"""The card: its name and power limit, its published peaks, clocks that
wait for it, and the reading of a profiler trace.

The peaks table and the card reader are frozen copies of the repository's
bring-up arithmetic, kept here so that no later change to the program moves
the yardstick. Device busy time is the union of the intervals in which any
operation ran on the device, so overlapping operations count once.
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

# Published peaks (NVIDIA data sheets, dense): FP32 TFLOP/s outside the
# tensor cores, FP64 TFLOP/s on the tensor cores (DMMA, full IEEE FP64, the
# card's highest FP64 rate), memory TB/s.
PEAKS = {
    "H100 SXM": {"fp32_tflops": 67.0, "fp64_tflops": 67.0, "tb_per_s": 3.35},
    "H100 PCIe": {"fp32_tflops": 51.2, "fp64_tflops": 51.2, "tb_per_s": 2.0},
}


def peaks_for(name: str) -> Dict[str, float]:
    """The data-sheet peaks of the card torch names; raises for any other
    card ("NVIDIA H100 80GB HBM3" is the SXM part)."""
    if "H100" in name and "PCIe" in name:
        return PEAKS["H100 PCIe"]
    if "H100" in name and ("SXM" in name or "HBM3" in name):
        return PEAKS["H100 SXM"]
    raise ValueError(f"no published peaks for {name!r}; add its row to PEAKS")


def card_power_limit(index: int = 0):
    """(name, power limit) as nvidia-smi reports them, or (None, None)."""
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", f"--id={index}"],
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[0]
        name, power = (s.strip() for s in line.rsplit(",", 1))
        return name, power
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None, None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn: Callable[[], object], device: torch.device, calls: int) -> float:
    """Mean device milliseconds of one call of fn over `calls` back-to-back
    calls, between CUDA events, after 3 warm calls; None off CUDA."""
    if device.type != "cuda":
        return None
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / calls


def host_ms(fn: Callable[[], object], device: torch.device, calls: int) -> float:
    """Mean host milliseconds of one call of fn over `calls` calls, the
    device synchronized before the first and after the last."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / calls


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def read_trace(cpu: List[Tuple[str, float, float]], dev: List[Tuple[str, float, float]],
               window: Tuple[float, float]) -> dict:
    """What a trace says, from (name, start us, end us) of the host thread's
    operations and of the device's, inside `window` (start, end us):
    busy seconds (union of the device intervals), the window's seconds, the
    number of kernels (copies and fills left out), the 10 device operations
    with the most time, and the 10 names under which the device idled
    longest, each idle gap named by the innermost host operation running at
    its middle (a CUDA runtime call joined to the operation that made it)."""
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    merged = _union([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in merged)
    by_op: Dict[str, float] = defaultdict(float)
    for n, s, e in dev:
        by_op[n] += (e - s) * 1e-6
    gaps = []
    prev = w0
    for s, e in merged + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    by_host: Dict[str, float] = defaultdict(float)
    names = _innermost(cpu, [0.5 * (s + e) for s, e in gaps])
    for (s, e), n in zip(gaps, names):
        by_host[n] += (e - s) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "kernels": sum(1 for n, _, _ in dev if not _is_copy(n)),
            "device_ops": [[n, t] for n, t in top], "idle_gaps": [[n, t] for n, t in idle]}


def _innermost(cpu: List[Tuple[str, float, float]], points: List[float]) -> List[str]:
    """For each time point, the name of the innermost host operation that
    spans it (the host thread's operations nest)."""
    evs = sorted(cpu, key=lambda x: (x[1], -x[2]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    out = [""] * len(points)
    stack: List[Tuple[str, float, float]] = []
    i = 0
    for j in order:
        t = points[j]
        while i < len(evs) and evs[i][1] <= t:
            while stack and stack[-1][2] <= evs[i][1]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        live = [ev for ev in stack if ev[2] >= t]
        if not live:
            out[j] = "(host outside any operation)"
            continue
        inner = live[-1][0]
        if inner.startswith(("cuda", "cu")) and len(live) > 1:
            inner = f"{live[-2][0]} > {inner}"
        out[j] = inner
    return out


def profile(fn: Callable[[], object], device: torch.device, label: str = "benchmark.traced"):
    """Run fn once under torch.profiler (host and device activity); return
    (fn's result, read_trace's summary). The window is the host span of a
    record_function around fn, which ends after the device is synchronized.
    The trace is read from the profiler's raw events (building its
    FunctionEvent tree takes minutes at a case's 10^5 kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as tprofile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with tprofile(activities=acts) as prof:
        with record_function(label):
            out = fn()
            sync(device)
    events = prof.profiler.kineto_results.events()
    mark = next(e for e in events if e.name() == label and e.device_type() == DeviceType.CPU)
    thread = mark.start_thread_id()
    cpu, dev = [], []
    for e in events:
        if e.is_user_annotation() or e.name() == label:
            continue
        rng = (e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
        if e.device_type() == DeviceType.CUDA:
            dev.append(rng)
        elif e.start_thread_id() == thread:
            cpu.append(rng)
    window = (mark.start_ns() * 1e-3, mark.end_ns() * 1e-3)
    del events, prof
    return out, read_trace(cpu, dev, window)
