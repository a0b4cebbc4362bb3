"""Tracing and profiling utilities (port of femx/profiling.py).

- `stage(name)`: wall-time context manager accumulating into a registry;
- `profile_trace(dir)`: a torch.profiler trace of the host and the card,
  written as a Chrome trace into `log_dir`;
- `timeit(fn, *args)`: first-call against best warm-call timing, waiting
  for the device of the output before each clock read.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch

_STAGE_TIMES: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def stage(name: str, registry: Optional[Dict[str, list]] = None, verbose: bool = False):
    """Accumulating wall-time stage timer."""
    reg = _STAGE_TIMES if registry is None else registry
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        reg[name].append(dt)
        if verbose:
            print(f"[femx_torch] {name}: {dt:.3f}s")


def stage_report(registry: Optional[Dict[str, list]] = None) -> Dict[str, dict]:
    reg = _STAGE_TIMES if registry is None else registry
    return {
        k: {"calls": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
        for k, v in reg.items()
        if v
    }


def reset_stages(registry: Optional[Dict[str, list]] = None) -> None:
    (_STAGE_TIMES if registry is None else registry).clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Host and CUDA activity of the block, written to
    `log_dir`/trace.json (chrome://tracing or Perfetto) on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    """Wait for every CUDA device that holds a tensor of `out`."""
    tensors = out if isinstance(out, (tuple, list)) else [out]
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def timeit(fn: Callable, *args, reps: int = 5, **kwargs) -> dict:
    """{'first_s': first call, 'steady_s': best of `reps` warm calls,
    'output': the last output}; each time ends when the output's device is
    done."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return {"first_s": first, "steady_s": best, "output": out}
