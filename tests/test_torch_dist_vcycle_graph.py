"""DistributedMultigrid's CUDA-graph route on the CPU: on two gloo ranks
its calls stay the eager V-cycle bit for bit and count no graph; the rule
that decides the route (NCCL or one rank, read alike on every rank); a
replay counting what its capture counted, the capture tallied with tracing
on or off; on two gloo ranks with a stand-in graph that runs the V-cycle
as a capture and a replay would see it, comm.bytes of the replayed solves
against the hand count of tests/test_torch_parallel_tracing.py; and the
benchmark's dmg_replay_share reader on a synthetic trace. The route itself
(multigrid._VcycleRoute, StructuredMultigrid's too) is tested for both
hierarchies in tests/test_torch_vcycle_graph.py; every route that calls a
DistributedMultigrid is in tests/test_torch_dist_vcycle_routes.py; the
card's own checks (two NCCL ranks) are in tests/test_torch_cuda.py. No jax
here."""

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
from femx_torch.solve import multigrid
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


@pytest.mark.parametrize("traced_capture", [False, True])
def test_a_replay_counts_what_its_capture_counted(monkeypatch, traced_capture):
    """The route tallies its capture, tracing on or off, records nothing of
    it globally, and hands the tally to count at each replay."""
    monkeypatch.setattr(multigrid, "_VcycleGraph", _MutedGraph)

    def vcycle(x):
        profiling.count("comm.bytes", 80)
        profiling.count("comm.bytes", 12)
        profiling.count("other")
        return -x

    route = multigrid._VcycleRoute("dmg", lambda r: True)
    r = torch.ones(4)
    if traced_capture:
        profiling.enable()
    assert torch.equal(route(r, vcycle), -r)  # eager
    assert torch.equal(route(r, vcycle), -r)  # captured and replayed
    assert route.graph.captured and route.tally == {"comm.bytes": 92, "other": 1}
    if traced_capture:  # the eager call and the replay, not the capture
        assert profiling.collect()["counters"] == {
            "dmg.vcycle_calls": 2, "dmg.graph_captures": 1, "dmg.graph_replays": 1,
            "comm.bytes": 184, "other": 2}
    profiling.enable()
    assert torch.equal(route(r, vcycle), -r)
    assert torch.equal(route(r, vcycle), -r)
    assert profiling.collect()["counters"] == {
        "dmg.vcycle_calls": 2, "dmg.graph_replays": 2, "comm.bytes": 184, "other": 2}


def replayed_traced_cases(*args):
    """rank_checks.traced_cases with every distributed V-cycle past the
    first call replayed through _MutedGraph."""
    halo._replayable = lambda r: r.is_contiguous()
    multigrid._VcycleGraph = _MutedGraph
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
