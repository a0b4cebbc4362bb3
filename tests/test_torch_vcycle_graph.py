"""The V-cycle's CUDA-graph route (multigrid._VcycleRoute) on the CPU: a
CPU call of StructuredMultigrid is the eager V-cycle bit for bit and counts
no graph; for StructuredMultigrid and DistributedMultigrid alike (one rank,
no process group), the route (an eager call, capture, replay) and its
counters with the graph stubbed, an input unlike the captured one taking
the eager path, and a CPU tensor never taking the graph; the capture's
sequence with torch.cuda stubbed; span and count do nothing while a stream
captures; and the benchmark's vcycle_replay_share reader on a synthetic
trace. The card's own checks are in tests/test_torch_cuda.py. No jax
here."""

import sys
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from femx_torch import profiling
from femx_torch.parallel import halo
from femx_torch.parallel.halo import DistributedMultigrid
from femx_torch.profiling import collect, count, disable, enable, span
from femx_torch.solve import multigrid
from femx_torch.solve.multigrid import StructuredMultigrid

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _tracing_off_after(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    yield
    disable()
    collect()


def _mg(smoother="jacobi", n=(8, 8, 8)):
    """A three-level hierarchy of a box clamped at x = 0, on the CPU."""
    nd = 3 * int(np.prod([2 * c + 1 for c in n]))
    mask = np.ones(nd)
    mask[:3 * (2 * n[1] + 1) * (2 * n[2] + 1)] = 0
    return StructuredMultigrid((0.4, 0.4, 0.4), n, 2e11, 0.3, mask, device="cpu",
                               smoother=smoother, coarse_dof_limit=200)


def _dmg():
    """A DistributedMultigrid of one rank (no process group) on the CPU: one
    distributed level, the hand-off to a replicated level that smooths, and
    the dense coarse solve."""
    n = (8, 8, 12)
    m3 = np.ones((2 * n[0] + 1, 2 * n[1] + 1, 2 * n[2] + 1, 3))
    m3[:, :, 0] = 0.0
    mg = StructuredMultigrid(None, n, 2e11, 0.3, m3.reshape(-1), spacing=(0.05, 0.05, 0.05),
                             dtype=np.float32, device="cpu")
    return DistributedMultigrid(mg)


def _residual(n, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def _hierarchy(kind):
    """(hierarchy, a residual of its finest level, the name of its eager
    V-cycle method, the spans one eager call records by name)."""
    if kind == "mg":
        mg = _mg()
        return mg, _residual(mg.fine_op.ndof), "_vcycle", {"mg.level": len(mg.levels)}
    dmg = _dmg()
    return (dmg, _residual(dmg.halo.local.ndof), "_vcycle_local",
            {"dmg.level": dmg.n_dist, "dmg.handoff": 1})


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_cpu_call_is_the_eager_vcycle_and_counts_no_graph(smoother):
    mg = _mg(smoother)
    assert len(mg.levels) == 3
    rs = [_residual(mg.fine_op.ndof, s) for s in range(3)]
    enable()
    got = [mg(r) for r in rs]
    rec = collect()
    for g, r in zip(got, rs):
        assert torch.equal(g, mg._vcycle(0, r))
    assert rec["counters"] == {"mg.vcycle_calls": 3}
    assert mg._route.graph is None
    assert "mg.replay" not in {s["name"] for s in rec["spans"]}


class _FakeGraph:
    """Stands in for _VcycleGraph: records what the route asks of it."""

    def __init__(self, r):
        self.key = multigrid._graph_key(r)
        self.captured = False
        self.calls = []

    def capture(self, vcycle):
        self.calls.append("capture")
        self.captured = True

    def replay(self, r, out):
        self.calls.append("replay")
        out.copy_(-r)


@pytest.fixture
def graphed(monkeypatch):
    """Every contiguous input may take the graph, under either hierarchy's
    rule; the graph is faked."""
    monkeypatch.setattr(multigrid, "_graphable", lambda r: r.is_contiguous())
    monkeypatch.setattr(halo, "_replayable", lambda r: r.is_contiguous())
    monkeypatch.setattr(multigrid, "_VcycleGraph", _FakeGraph)


KINDS = ["mg", "dmg"]


@pytest.mark.parametrize("kind", KINDS)
def test_route_runs_eagerly_captures_once_then_replays(graphed, kind):
    h, r, eager, eager_spans = _hierarchy(kind)
    want = getattr(h, eager)(0, r)
    enable()
    assert torch.equal(h(r), want)  # the first call: eager, and the graph made
    assert h._route.graph.calls == []
    outs = [h(r) for _ in range(4)]
    rec = collect()
    assert h._route.graph.calls == ["capture"] + ["replay"] * 4
    assert all(torch.equal(o, -r) for o in outs)  # what the fake replay wrote
    # one rank: no collective, and the fake capture counted nothing to count again
    assert rec["counters"] == {f"{kind}.vcycle_calls": 5, f"{kind}.graph_captures": 1,
                               f"{kind}.graph_replays": 4}
    names = Counter(s["name"] for s in rec["spans"])
    assert names[f"{kind}.replay"] == 4
    # only the first call ran the V-cycle eagerly
    assert {n: names[n] for n in eager_spans} == eager_spans


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("unlike", ["shape", "dtype", "device", "contiguity"])
def test_an_input_unlike_the_captured_one_takes_the_eager_path(graphed, unlike, kind):
    h, r, eager, _ = _hierarchy(kind)
    h(r)
    h(r)  # eager; then captured, and replayed once
    seen = []
    setattr(h, eager, lambda k, x: seen.append((k, x)) or x)  # the eager path, recorded
    other = {"shape": lambda: torch.zeros(r.numel() + 3),
             "dtype": lambda: r.double(),
             "device": lambda: r.to("meta"),
             "contiguity": lambda: torch.zeros(2 * r.numel())[::2]}[unlike]()
    enable()
    assert h(other) is other
    assert seen == [(0, other)]
    assert h._route.graph.calls == ["capture", "replay"]
    assert collect()["counters"] == {f"{kind}.vcycle_calls": 1}
    h(r)  # the captured input still replays
    assert h._route.graph.calls[-1] == "replay" and len(seen) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_a_cpu_tensor_is_never_graphable(kind):
    eligible = {"mg": multigrid._graphable, "dmg": halo._replayable}[kind]
    assert not eligible(torch.zeros(8))
    assert not eligible(torch.zeros(16)[::2])


@pytest.mark.parametrize("fails", [False, True])
def test_capture_records_into_the_shared_pool_and_empties_no_cache(monkeypatch, fails):
    """_VcycleGraph with torch.cuda stubbed: the capture stream waits on
    the caller's, cuBLAS's workspaces are cleared around a capture (CUDA's
    thread-local capture mode) into the shared pool of slot_copy_in, the
    V-cycle and slot_copy_out, which ends
    even when the V-cycle raises; nothing synchronizes the card, empties the
    allocator's cache or collects garbage; a replay sets the two addresses,
    then replays."""
    import contextlib
    import gc

    log = []

    class Stream:
        def wait_stream(self, other):
            log.append(("wait", other))

    class Graph:
        def capture_begin(self, pool=None, capture_error_mode="global"):
            log.append(("begin", pool, capture_error_mode))

        def capture_end(self):
            log.append("end")

        def replay(self):
            log.append("replay")

    def forbidden(name):
        return lambda *a, **k: pytest.fail(f"{name} called")

    stream = Stream()
    monkeypatch.setattr(multigrid, "_capture_place", lambda device: (stream, (7, 0)))
    monkeypatch.setattr(multigrid, "_clear_cublas_workspaces", lambda: log.append("clear"))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "caller")
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: log.append(("stream", s)) or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden("synchronize"))
    monkeypatch.setattr(torch.cuda, "empty_cache", forbidden("empty_cache"))
    monkeypatch.setattr(gc, "collect", forbidden("gc.collect"))
    gather = multigrid.gather
    monkeypatch.setattr(gather, "slot_copy_in", lambda slots, buf: log.append(("in", buf.numel())))
    monkeypatch.setattr(gather, "slot_copy_out",
                        lambda slots, buf: log.append(("out", buf.numel())))
    monkeypatch.setattr(gather, "slot_set", lambda slots, a, b: log.append(("set", a, b)))

    def vcycle(x):
        log.append(("vcycle", x.numel()))
        if fails:
            raise ValueError("the V-cycle failed")
        return 2 * x

    r = torch.zeros(12)
    g = multigrid._VcycleGraph(r)
    assert g.slots.dtype == torch.int64 and g.slots.numel() == 2
    with pytest.raises(ValueError) if fails else contextlib.nullcontext():
        g.capture(vcycle)
    assert log == [("wait", "caller"), "clear", ("stream", stream),
                   ("begin", (7, 0), "thread_local"), ("in", 12), ("vcycle", 12)] + (
                       [] if fails else [("out", 12)]) + [
                       "end", "clear"]
    assert g.captured is not fails
    if not fails:
        log.clear()
        out = torch.empty_like(r)
        g.replay(r, out)
        assert log == [("set", r.data_ptr(), out.data_ptr()), "replay"]


def test_span_and_count_do_nothing_while_a_stream_captures(monkeypatch):
    enable()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert span("inside") is span("other")
    with span("inside"):
        count("n", 3)
    assert collect() == {"spans": [], "counters": {}}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with span("outside"):
        count("n")
    rec = collect()
    assert [s["name"] for s in rec["spans"]] == ["outside"] and rec["counters"] == {"n": 1}


def test_capturing_is_false_without_cuda(monkeypatch):
    def no_cuda():
        raise RuntimeError("Tried to instantiate dummy base class")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", no_cuda)
    assert profiling._capturing() is False
    enable()
    with span("a"):
        count("b")
    rec = collect()
    assert [s["name"] for s in rec["spans"]] == ["a"] and rec["counters"] == {"b": 1}


def _replay_share_reader():
    bench = str(ROOT / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness.registry import Registry

    reg = Registry(ROOT)
    return reg, reg.reader("vcycle_replay_share.struct")


def test_replay_share_reader_on_a_synthetic_trace():
    reg, mod = _replay_share_reader()
    assert mod.FROM_TRACE is True

    def share(counters, device="cuda"):
        run = types.SimpleNamespace(device=torch.device(device), program_trace={
            "spans": [], "counters": counters, "idle": {"idle_s": 0.0, "innermost": {},
                                                        "under": {}}})
        return mod.read(run, reg, "vcycle_replay_share.struct")

    assert share({"mg.vcycle_calls": 33, "mg.graph_replays": 33}) == pytest.approx(100.0)
    assert share({"mg.vcycle_calls": 88, "mg.graph_replays": 66,
                  "cg.iterations": 43}) == pytest.approx(75.0)
    assert share({"mg.vcycle_calls": 4}) == 0.0  # every call eager
    # a program without the counters (the parent's), or no trace: nothing
    assert share({"cg.iterations": 32}) is None
    assert share({"mg.vcycle_calls": 0}) is None
    run = types.SimpleNamespace(device=torch.device("cuda"), program_trace=None)
    assert mod.read(run, reg, "vcycle_replay_share.msh") is None
    for m in reg.spec["per_layer"]:
        if m["name"].startswith("vcycle_replay_share."):
            assert (m["layer"], m["source"], m["moves"]) == (
                "Preconditioners", "program_counter", "case_s")
