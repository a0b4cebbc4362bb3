"""DistributedMultigrid's CUDA-graph route on the CPU: on two gloo ranks
its calls stay the eager V-cycle bit for bit and count no graph; the rule
that decides the route (NCCL or one rank, read alike on every rank); the
route (an eager call, a capture in the thread-local mode, replays) and its
counters with the graph stubbed, and an input unlike the captured one
taking the eager path; on two gloo ranks with a stand-in graph that runs
the V-cycle as a capture and a replay would see it, comm.bytes of the
replayed solves against the hand count of
tests/test_torch_parallel_tracing.py; comm.bytes_sent; and the
benchmark's dmg_replay_share reader on a synthetic trace. Every route that
calls a DistributedMultigrid is in tests/test_torch_dist_vcycle_routes.py;
the card's own checks (two NCCL ranks) are in tests/test_torch_cuda.py.
No jax here."""

import contextlib
import sys
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from femx_torch import profiling
from femx_torch.parallel import comm, halo, launch, rank_checks
from femx_torch.parallel.halo import DistributedMultigrid
from femx_torch.solve import multigrid
from femx_torch.solve.multigrid import StructuredMultigrid
from torch_parallel_counts import bytes_of_one_solve, traced_cases_args

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 240.0
# one distributed level over two ranks (12 % 4 = 0, 6 % 4 != 0), then the
# hand-off to a replicated level that smooths, and the dense coarse solve
CELLS, SPACING = (8, 8, 12), (0.05, 0.05, 0.05)


@pytest.fixture(autouse=True)
def _tracing_off_after(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    yield
    profiling.disable()
    profiling.collect()


def _clamped_mask(n):
    """Global raster mask of a box fixed at z = 0."""
    m3 = np.ones((2 * n[0] + 1, 2 * n[1] + 1, 2 * n[2] + 1, 3))
    m3[:, :, 0] = 0.0
    return m3.reshape(-1)


def test_gloo_ranks_run_the_vcycle_eagerly_bit_for_bit():
    calls = 5
    ranks = launch(rank_checks.dist_vcycle_graph, 2, CELLS, SPACING, _clamped_mask(CELLS),
                   calls, 1e-8, "cpu", device="cpu", timeout=TIMEOUT, all_ranks=True)
    for rk in ranks:
        out = rk.result
        assert out["backend"] == "gloo" and out["distributed_levels"] == 1
        assert out["levels"] == 3
        assert out["bitwise"] == [True] * calls
        assert not out["captured"]
        assert out["eager_bytes"] > 0
        assert out["counters"] == {"dmg.vcycle_calls": calls,
                                   "comm.bytes": calls * out["eager_bytes"]}
        assert out["spans"]["dmg.level"] == calls and "dmg.replay" not in out["spans"]
        rep, eag = out["solves"]["replayed"], out["solves"]["eager"]
        assert rep["converged"] and rep["iterations"] == eag["iterations"]
        assert np.array_equal(rep["x"], eag["x"])


@pytest.mark.parametrize("world,backend,graphable,want", [
    (1, None, True, True), (2, "nccl", True, True), (4, "nccl", True, True),
    (2, "gloo", True, False), (4, "gloo", True, False), (2, "nccl", False, False),
    (1, None, False, False)])
def test_the_route_is_decided_by_the_backend_alike_on_every_rank(monkeypatch, world, backend,
                                                                 graphable, want):
    monkeypatch.setattr(halo, "_graphable", lambda r: graphable)
    monkeypatch.setattr(comm, "world_size", lambda: world)
    monkeypatch.setattr(comm, "backend", lambda: backend)
    assert halo._replayable(torch.zeros(4)) is want


def test_a_cpu_tensor_never_replays():
    assert not halo._replayable(torch.zeros(8))


def _dmg():
    """A DistributedMultigrid of one rank (no process group) on the CPU."""
    n = CELLS
    mg = StructuredMultigrid(None, n, 2e11, 0.3, _clamped_mask(n), spacing=SPACING,
                             dtype=np.float32, device="cpu")
    return DistributedMultigrid(mg)


def _residual(dmg, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(dmg.halo.local.ndof)
                           .astype(np.float32))


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
    """Every contiguous input may replay; the graph is faked."""
    monkeypatch.setattr(halo, "_replayable", lambda r: r.is_contiguous())
    monkeypatch.setattr(halo, "_VcycleGraph", _FakeGraph)


def test_route_runs_eagerly_captures_once_then_replays(graphed):
    dmg = _dmg()
    r = _residual(dmg)
    want = dmg._vcycle_local(0, r)
    profiling.enable()
    assert torch.equal(dmg(r), want)  # the first call: eager, and the graph made
    assert dmg._graph.calls == []
    outs = [dmg(r) for _ in range(4)]
    rec = profiling.collect()
    assert dmg._graph.calls == ["capture"] + ["replay"] * 4
    assert all(torch.equal(o, -r) for o in outs)  # what the fake replay wrote
    # one rank: no collective, so the replays hand over nothing
    assert rec["counters"] == {"dmg.vcycle_calls": 5, "dmg.graph_captures": 1,
                               "dmg.graph_replays": 4, "comm.bytes": 0}
    names = Counter(s["name"] for s in rec["spans"])
    assert names["dmg.replay"] == 4
    # only the first call ran the V-cycle eagerly: one dmg.level a distributed level
    assert names["dmg.level"] == dmg.n_dist and names["dmg.handoff"] == 1


@pytest.mark.parametrize("unlike", ["shape", "dtype", "device", "contiguity"])
def test_an_input_unlike_the_captured_one_takes_the_eager_path(graphed, unlike):
    dmg = _dmg()
    r = _residual(dmg)
    dmg(r)
    dmg(r)  # eager; then captured, and replayed once
    seen = []
    dmg._vcycle_local = lambda k, x: seen.append((k, x)) or x  # the eager path, recorded
    other = {"shape": lambda: torch.zeros(r.numel() + 3),
             "dtype": lambda: r.double(),
             "device": lambda: r.to("meta"),
             "contiguity": lambda: torch.zeros(2 * r.numel())[::2]}[unlike]()
    profiling.enable()
    assert dmg(other) is other
    assert seen == [(0, other)]
    assert dmg._graph.calls == ["capture", "replay"]
    assert profiling.collect()["counters"] == {"dmg.vcycle_calls": 1}
    dmg(r)  # the captured input still replays
    assert dmg._graph.calls[-1] == "replay" and len(seen) == 1


def test_every_payload_adds_to_the_bytes_sent(monkeypatch):
    monkeypatch.setattr(comm, "bytes_sent", 5)
    t = torch.zeros(10, dtype=torch.float64)
    assert comm._payload(t) == 80 and comm.bytes_sent == 85
    profiling.enable()  # tracing on or off alike
    assert comm._payload(t[:3].float()) == 12 and comm.bytes_sent == 97


@contextlib.contextmanager
def _as_if_capturing():
    """The recorder as a capturing stream sees it: no span, no count."""
    real = profiling._capturing
    profiling._capturing = lambda: True
    try:
        yield
    finally:
        profiling._capturing = real


class _MutedGraph:
    """Stands in for _VcycleGraph on CPU ranks: `capture` runs the V-cycle
    once, as a capture would record it (the collectives really run, the
    recorder records nothing), `replay` runs it again so into `out`."""

    def __init__(self, r):
        self.key = multigrid._graph_key(r)
        self.captured = False

    def capture(self, vcycle):
        self.vcycle = vcycle
        with _as_if_capturing():
            vcycle(torch.zeros(self.key[0], dtype=self.key[1]))
        self.captured = True

    def replay(self, r, out):
        with _as_if_capturing():
            out.copy_(self.vcycle(r))


def replayed_traced_cases(*args):
    """rank_checks.traced_cases with every distributed V-cycle past the
    first call replayed through _MutedGraph."""
    halo._replayable = lambda r: r.is_contiguous()
    halo._VcycleGraph = _MutedGraph
    return rank_checks.traced_cases(*args)


def test_replays_count_in_comm_bytes_what_eager_calls_do():
    args = traced_cases_args()
    got = launch(replayed_traced_cases, 2, *args, device="cpu", timeout=TIMEOUT)
    eager = launch(rank_checks.traced_cases, 2, *args, device="cpu", timeout=TIMEOUT)
    its = [i["iterations"] for i in got["case_solve_info"]]
    assert its == [i["iterations"] for i in eager["case_solve_info"]]
    calls = sum(its) + len(its)
    on = got["on"]["counters"]
    assert on["dmg.vcycle_calls"] == on["dmg.graph_replays"] == calls
    assert "dmg.graph_captures" not in on  # captured in run_simulation's solve
    assert on["comm.bytes"] == sum(bytes_of_one_solve(got, i) for i in its)
    assert on["comm.bytes"] == eager["on"]["counters"]["comm.bytes"]
    names = Counter(s["name"] for s in got["on"]["spans"])
    assert names["dmg.replay"] == calls and names["dmg.level"] == 0
    assert np.array_equal(got["u_on"], eager["u_on"])
    assert np.array_equal(got["u_off"], eager["u_off"])


def _replay_share_reader():
    bench = str(ROOT / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness.registry import Registry

    reg = Registry(ROOT)
    return reg, reg.reader("dmg_replay_share.dist")


def test_dmg_replay_share_reader_on_a_synthetic_trace():
    reg, mod = _replay_share_reader()
    assert mod.FROM_TRACE is True

    def share(counters):
        run = types.SimpleNamespace(device=torch.device("cuda"), program_trace={
            "spans": [], "counters": counters, "idle": {"idle_s": 0.0, "innermost": {},
                                                        "under": {}}})
        return mod.read(run, reg, "dmg_replay_share.dist")

    assert share({"dmg.vcycle_calls": 37, "dmg.graph_replays": 37,
                  "cg.iterations": 36}) == pytest.approx(100.0)
    assert share({"dmg.vcycle_calls": 40, "dmg.graph_replays": 30}) == pytest.approx(75.0)
    # the one-card V-cycle's counters are not the distributed one's
    assert share({"mg.vcycle_calls": 33, "mg.graph_replays": 33}) is None
    # a program that never replays it (the parent, or gloo), or no trace: nothing
    assert share({"dmg.vcycle_calls": 37, "cg.iterations": 36}) is None
    assert share({"dmg.vcycle_calls": 0, "dmg.graph_replays": 0}) is None
    run = types.SimpleNamespace(device=torch.device("cuda"), program_trace=None)
    assert mod.read(run, reg, "dmg_replay_share.dist") is None
    entry, = [m for m in reg.spec["per_layer"] if m["name"] == "dmg_replay_share.dist"]
    assert entry == {"name": "dmg_replay_share.dist", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "Preconditioners",
                     "moves": "case_s", "workloads": ["box13m-struct-cases-4gpu"]}
    assert reg.spec["per_layer"][-1] == entry
