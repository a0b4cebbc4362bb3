"""Every route that calls a DistributedMultigrid, on two CPU ranks: the
float32 structured devices=2 solve checkpointed, its load cases and modal
with refine (DistributedStructuredSolver, and modal's own hierarchy through
pcg_halo), and the unstructured devices=2 solve (DistributedUnstructured-
Solver's lattice coarse correction, two calls a preconditioner call). Each
runs twice in one launch, first as the program runs it, then with every
DistributedMultigrid call eager: under gloo both runs are eager (no
capture, no replay); with the stand-in graph of
tests/test_torch_dist_vcycle_graph.py every hierarchy captures at its
second call and replays after, to the same bits and iterations. The card's
check of the same routes on two NCCL ranks is in tests/test_torch_cuda.py.
No jax here."""

import pytest
import torch

from femx_torch.parallel import halo, launch, rank_checks
from test_torch_dist_vcycle_graph import _MutedGraph
from torch_parallel_counts import check_routes, routes_args

torch.set_num_threads(2)

TIMEOUT = 240.0


@pytest.fixture(autouse=True)
def _no_mg_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


def replayed_and_eager_stubbed(*args):
    """rank_checks.replayed_and_eager with every DistributedMultigrid past
    its first call replayed through _MutedGraph."""
    halo._replayable = lambda r: r.is_contiguous()
    halo._VcycleGraph = _MutedGraph
    return rank_checks.replayed_and_eager(*args)


@pytest.mark.parametrize("graph", ["gloo", "stand-in"])
@pytest.mark.parametrize("route", ["structured", "unstructured"])
def test_every_route_gives_the_same_bits_replayed_and_eager(tmp_path, route, graph):
    fn = rank_checks.replayed_and_eager if graph == "gloo" else replayed_and_eager_stubbed
    out = launch(fn, 2, *routes_args(route, "cpu", str(tmp_path)), device="cpu",
                 timeout=TIMEOUT)
    assert out["backend"] == "gloo"
    captures = check_routes(out, replayed=graph != "gloo")
    # the structured solve's and modal's hierarchies; the unstructured solver's one
    assert captures == {"gloo": 0, "stand-in": {"structured": 2, "unstructured": 1}[route]}[graph]
