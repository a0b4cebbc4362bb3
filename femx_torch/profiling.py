"""Tracing and profiling utilities.

- The recorder: `span(name, **attrs)` and `count(name, n=1)` at the
  program's layer boundaries, `enable()`, `disable()` and `collect()`.
  Tracing is off by default; off, `span` returns one shared no-op context
  and `count` returns at once. On, each span records its name, id, parent
  id, request id (a span without a parent is a request; its descendants
  share its id), host start and end (`time.perf_counter_ns`) and its
  attributes; while a profiler runs (`profile_trace` too) it also opens
  `torch.profiler.record_function(name)`, so it sits on the trace beside
  the kernels (outside a profiler that range would cost ~10 us a span and
  show nowhere). `collect()` also gives each span on the profiler's clock
  (Unix epoch ns). `enable(device)` with a CUDA device also records a CUDA
  event on that device's current stream at each span's start and end, and
  `collect()` gives the stream's time between the two (`device_ns`): the
  span's work as the card runs it, which does not fall to the launch cost
  when the host runs ahead of the card.
- `timed(name, device, **attrs)`: a span that times itself whether tracing
  is on or off, and ends on `torch.cuda.synchronize(device)` on a CUDA
  device; its `seconds` are the analyses' `stage_times`.
- `profile_trace(dir)`: a torch.profiler trace of the host and the card,
  written as a Chrome trace into `log_dir`;
- `timeit(fn, *args)`: first-call against best warm-call timing, waiting
  for the device of the output before each clock read.

The spans of the solid route (`SolidReactionAnalysis`):

  solid.run_simulation, solid.case    requests: one analysis, one load case
                                      of solve_cases
  solid.read_mesh, solid.assemble,    the stages (timed, synced)
  solid.bc, solid.solve
  solid.precond_setup (timed, synced), solid.op64 (the float64 operator
  build), solid.cg, solid.reactions   inside solve; solid.cg also around
                                      each case's CG
  cg.apply, cg.precond, cg.wait       A(p), M^-1 r and the stopping test's
                                      host read of each pcg iteration
  mg.replay                           a V-cycle replayed as a CUDA graph
                                      (the slot kernel and the replay)
  mg.level (level=k), mg.smooth,      an eager V-cycle by level (a replay
  mg.restrict, mg.prolong,            has none); mg.restrict holds the
  mg.coarse_solve                     level's residual
  mg.coarse_factor                    the set-up's coarse Cholesky, inverse
                                      and upload
  lattice.bj, lattice.transfer        the lattice preconditioner's
                                      block-Jacobi and its transfers

and the counters cg.iterations (pcg iterations; the benchmark's
precond_ms divides the preconditioner's time by it), mg.vcycle_calls,
mg.graph_captures and mg.graph_replays (StructuredMultigrid's calls, the
CUDA graphs it captured and the calls that replayed one).

The multi-rank solid route (devices=N, femx_torch.parallel) keeps these
names where it does the same work, so readers of the single-device route
apply: solid.case and solid.cg around each load case of solve_cases and its
solve; cg.apply, cg.precond, cg.wait and cg.iterations in pcg_dist. Its
own:

  dist.rhs, dist.gather               a structured solve's right-hand side
                                      (host pad and permutation, upload,
                                      this rank's slab) and its answer
                                      (all_gather of x, copy to the host,
                                      inverse permutation and unpadding)
  halo.exchange                       the plane exchange of a halo apply
  dmg.replay                          a distributed V-cycle replayed as a
                                      CUDA graph (under NCCL; the slot
                                      kernel and the replay)
  dmg.level (level=k), dmg.handoff    an eager distributed V-cycle by level
                                      (a replay has none); the hand-off's
                                      all_gather, the replicated levels
                                      (their mg.* spans) and the slice back
  comm.all_reduce, comm.all_gather,   each collective of a group of two or
  comm.exchange                       more ranks (an exchange is one
                                      all_gather, spanned inside it)

and the counters dmg.vcycle_calls, dmg.graph_captures and
dmg.graph_replays (DistributedMultigrid's calls, its captures and the calls
that replayed its graph) and comm.bytes (the bytes of the tensors this rank
handed to collectives; a replay adds what its captured collectives hand
over).

While the current CUDA stream captures a graph, `span` and `count` do
nothing, tracing on or off: no CUDA event or profiler range enters a graph,
and a captured V-cycle is counted once, as a capture.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

_ON = False  # the one check a span or count makes with tracing off
_LOCK = threading.Lock()
_LOCAL = threading.local()  # per thread: the stack of open spans
_SPANS: List["_Span"] = []
_COUNTS: Dict[str, int] = defaultdict(int)
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)
_CLOCK = (0, 0)  # (time.time_ns(), time.perf_counter_ns()) at enable()
_STREAM = None  # the CUDA stream that times each span, from enable(device)


class _NoSpan:
    """The shared context of a span with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    s = getattr(_LOCAL, "stack", None)
    if s is None:
        s = _LOCAL.stack = []
    return s


class _Span:
    """One span; recorded (stack, ids, under a profiler a record_function
    range, and with enable(device) two CUDA events) only when `record`;
    `sync` is a CUDA device to synchronize before the span ends."""

    __slots__ = ("name", "attrs", "record", "sync", "id", "parent", "request", "start_ns",
                 "end_ns", "_fn", "_events")

    def __init__(self, name: str, attrs: dict, record: bool, sync=None):
        self.name, self.attrs, self.record, self.sync = name, attrs, record, sync
        self.id = self.parent = self.request = self._fn = self._events = None
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        if self.record:
            stack = _stack()
            up = stack[-1] if stack else None
            self.id = next(_IDS)
            self.parent = None if up is None else up.id
            self.request = next(_REQUESTS) if up is None else up.request
            stack.append(self)
            if torch._C._autograd._profiler_enabled():
                self._fn = torch.profiler.record_function(self.name)
                self._fn.__enter__()
            if _STREAM is not None:
                self._events = (_STREAM, torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[1].record(_STREAM)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.sync is not None and exc_type is None:
            torch.cuda.synchronize(self.sync)
        if self._events is not None:
            self._events[2].record(self._events[0])
        self.end_ns = time.perf_counter_ns()
        if self.record:
            if self._fn is not None:
                self._fn.__exit__(exc_type, exc, tb)
                self._fn = None
            _stack().pop()
            with _LOCK:
                _SPANS.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False on a
    build of torch without CUDA)."""
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:
        return False


def span(name: str, **attrs):
    """A span around the block (a context manager); with tracing off, or
    while the current CUDA stream captures a graph, the shared no-op
    context."""
    if not _ON or _capturing():
        return _NO_SPAN
    return _Span(name, attrs, True)


def timed(name: str, device=None, **attrs) -> _Span:
    """A span that times the block whether tracing is on or off (read its
    `seconds` after the block), ending on torch.cuda.synchronize(device)
    when `device` is a CUDA device; recorded only with tracing on."""
    dev = torch.device(device) if device is not None else None
    sync = dev if dev is not None and dev.type == "cuda" else None
    return _Span(name, attrs, _ON, sync)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (nothing with tracing off, or while the
    current CUDA stream captures a graph)."""
    if not _ON or _capturing():
        return
    with _LOCK:
        _COUNTS[name] += n


def enable(device=None) -> None:
    """Turn tracing on, dropping what an earlier enable() recorded. With a
    CUDA `device`, each span also times itself on that device's current
    stream (two CUDA events; collect() gives `device_ns`)."""
    global _ON, _CLOCK, _STREAM
    dev = torch.device(device) if device is not None else None
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()
        _CLOCK = (time.time_ns(), time.perf_counter_ns())
        cuda = dev is not None and dev.type == "cuda"
        _STREAM = torch.cuda.current_stream(dev) if cuda else None
    _ON = True


def disable() -> None:
    """Turn tracing off; what was recorded stays for collect()."""
    global _ON
    _ON = False


def collect() -> dict:
    """The spans and counters recorded since enable() or the last collect(),
    which it clears: {"spans": [...], "counters": {name: n}}. Each span is a
    dict: name, id, parent, request, start_ns, end_ns (perf_counter ns),
    epoch_start_ns, epoch_end_ns (the profiler's clock, Unix epoch ns),
    device_ns (the CUDA stream's time from the span's start to its end, or
    None without enable(device); collect() waits for the stream) and attrs;
    spans are in the order they ended."""
    with _LOCK:
        spans, counts = list(_SPANS), dict(_COUNTS)
        _SPANS.clear()
        _COUNTS.clear()
        off = _CLOCK[0] - _CLOCK[1]
    for stream in {s._events[0] for s in spans if s._events is not None}:
        stream.synchronize()
    return {"spans": [{"name": s.name, "id": s.id, "parent": s.parent, "request": s.request,
                       "start_ns": s.start_ns, "end_ns": s.end_ns,
                       "epoch_start_ns": s.start_ns + off, "epoch_end_ns": s.end_ns + off,
                       "device_ns": (None if s._events is None else
                                     round(s._events[1].elapsed_time(s._events[2]) * 1e6)),
                       "attrs": dict(s.attrs)} for s in spans],
            "counters": counts}


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
