"""The four-card cell, box13m-struct-cases-4gpu: found by name in
BENCHMARK.json, its entries at the end of their lists; at the small
copy's size on four gloo ranks on the CPU, traced, correct, on four ranks,
its Collectives, Krylov and Preconditioners metrics read; and the two
Collectives readers on a program trace made by hand."""

import json
import types

import pytest
import torch

from bench_cases import ROOT, run_small_ranks, small_copy
from dist_cases import traced_cpu_rank

from harness.registry import Registry

CELL = "box13m-struct-cases-4gpu"
NEW = ["collective_share.dist", "comm_mib_per_case.dist"]


def test_the_cell_is_the_configuration_on_four_cards():
    reg = Registry(ROOT)
    spec = reg.spec
    w = reg.workload(CELL)
    # new entries come last in their lists
    assert spec["workloads"][-1] == w and spec["configs"][-1]["name"] == w["config"]
    dist = [m["name"] for m in spec["per_layer"] if m["name"].endswith(".dist")]
    assert [m["name"] for m in spec["per_layer"][-len(dist):]] == dist
    for m in spec["end_to_end"]:
        listed = m.get("workloads", [])
        assert CELL not in listed or listed[-1] == CELL, m["name"]
    cfg = reg.config(w["config"])
    assert w["chips"] == 4 and cfg["devices"] == 4 and w["traffic"] == "cases"
    assert cfg["mesh_size_m"] == 0.00625 and cfg["reduced"] == ["mesh_size_m"]
    assert cfg["assumed"]["cells"] == [128, 32, 128] and cfg["assumed"]["dofs"] == 12879555
    assert reg.traffic(w["traffic"])["kind"] == "cases"
    assert callable(reg.roofline(cfg["route"]["operator"]).count)
    e2e, layer = reg.metrics(CELL)
    assert {m["name"] for m in e2e} == {"setup_s", "case_s", "case_p95_s", "peak_device_mib"}
    assert {m["name"] for m in layer} == {
        "cg_iterations.dist", "precond_ms.dist", "cg_wait_share.dist", "collective_share.dist",
        "comm_mib_per_case.dist", "idle_share.dist", "idle_in_precond.dist",
        "kernels_per_case.dist"}
    for m in e2e + layer:
        assert callable(reg.reader(m["name"]).read)
    layers = {m["name"]: m["layer"] for m in reg.spec["per_layer"]}
    assert layers["idle_in_precond.dist"] == layers["idle_in_precond.struct"]
    assert reg.limits(w["config"])["support"]["limit"] == 0.0


def test_the_cell_on_four_ranks_traced(tmp_path):
    """16 x 4 x 16 cells (the source's own 0.05 m): 16 % (2 x 4) = 0, the
    first coarsening uniform, as at 128 x 32 x 128."""
    root = small_copy(tmp_path, mesh_size=0.05)
    recs = run_small_ranks(root, CELL, n=4, seed=2 ** 31 + 13, seconds=0.5, trace=True,
                           fn=traced_cpu_rank)
    line = recs[0]["line"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["count"] == 1  # four ranks on the CPU
    assert len(line["device"]["memory_peak_bytes_by_rank"]) == 4
    for r in recs:
        assert r["devices"] == [4] * r["attempted"] and r["forbidden"] == []
    m = line["metrics"]
    for name in ("collective_share.dist", "comm_mib_per_case.dist", "precond_ms.dist",
                 "cg_wait_share.dist", "cg_iterations.dist", "idle_in_precond.dist"):
        assert isinstance(m[name]["value"], float) and m[name]["value"] > 0, name
    assert 0 < m["collective_share.dist"]["value"] < 100
    assert list(line)[-1] == "compared"
    json.dumps(line)


def _span(id_, name, parent, ms):
    return {"id": id_, "name": name, "parent": parent, "start_ns": 0, "end_ns": int(ms * 1e6),
            "device_ns": int(ms * 1e6)}


def _run(trace):
    return types.SimpleNamespace(device=torch.device("cuda"), mix={"kind": "cases"},
                                 program_trace=trace)


def test_collective_readers_on_a_trace():
    reg = Registry(ROOT)
    readers = {n: reg.reader(n) for n in NEW}
    # two load cases of 100 and 300 ms; collectives: an all_reduce (5 ms),
    # an exchange (20 ms) holding its all_gather (18 ms), an all_gather of
    # the hand-off (10 ms) inside a V-cycle level, and one all_reduce (7 ms)
    spans = [_span(1, "solid.case", None, 100.0), _span(2, "solid.cg", 1, 90.0),
             _span(3, "comm.all_reduce", 2, 5.0), _span(4, "halo.exchange", 2, 25.0),
             _span(5, "comm.exchange", 4, 20.0), _span(6, "comm.all_gather", 5, 18.0),
             _span(7, "solid.case", None, 300.0), _span(8, "dmg.level", 7, 50.0),
             _span(9, "dmg.handoff", 8, 30.0), _span(10, "comm.all_gather", 9, 10.0),
             _span(11, "comm.all_reduce", 7, 7.0)]
    # bytes handed over: all_reduce 16 + 8, all_gather 2 x 3 MiB, hand-off 1 MiB
    sent = 16 + 8 + 6 * 2 ** 20 + 2 ** 20
    trace = {"spans": spans, "counters": {"comm.bytes": sent, "cg.iterations": 3}}
    run = _run(trace)
    got = {n: mod.read(run, reg, n) for n, mod in readers.items()}
    assert got["collective_share.dist"] == pytest.approx(100.0 * (5 + 20 + 10 + 7) / 400)
    assert got["comm_mib_per_case.dist"] == pytest.approx((7 * 2 ** 20 + 24) / 2 ** 20 / 2)
    # a program without the spans or the counter (the parent of the
    # multi-rank tracing), a trace without stream times, no trace: nothing
    bare = [s for s in spans if not s["name"].startswith("comm.")]
    for t in (dict(trace, spans=bare, counters={"cg.iterations": 3}),
              dict(trace, spans=[dict(s, device_ns=None) for s in spans], counters={}),
              None):
        for n, mod in readers.items():
            assert mod.read(_run(t), reg, n) is None, (n, t)
    cpu = types.SimpleNamespace(device=torch.device("cpu"), mix={"kind": "cases"}, answers=[])
    for n, mod in readers.items():
        assert mod.read(cpu, reg, n) is None
