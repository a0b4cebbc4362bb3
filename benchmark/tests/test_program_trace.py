"""The program trace on the CPU: idle gaps put down to the innermost
program span (and to every span open), a gap outside every span, the
readers' None without a card, without a recorder or without spans, their
values on a given trace, and the two passes over a small cell's request."""

import types

import pytest
import torch

from bench_cases import ROOT, small_copy

from harness import cells, program_trace
from harness.registry import Registry

NEW = ["precond_ms", "cg_wait_share", "idle_in_precond", "precond_setup_s", "coarse_factor_s"]


def test_idle_gaps_go_to_the_innermost_open_span():
    # host spans (us): case [0, 100] > cg [10, 90] > precond [20, 50] > level [25, 45]
    spans = [("solid.case", 0.0, 100.0), ("solid.cg", 10.0, 90.0),
             ("cg.precond", 20.0, 50.0), ("mg.level", 25.0, 45.0), ("cg.wait", 60.0, 70.0)]
    # device busy: [0, 5], [22, 30], [40, 41], [60, 62], [69, 80], [95, 120]
    device = [(0.0, 5.0), (22.0, 30.0), (29.0, 30.0), (40.0, 41.0), (60.0, 62.0),
              (69.0, 80.0), (95.0, 120.0)]
    got = program_trace.idle_by_span(spans, device, (-10.0, 110.0))
    # gaps: [-10, 0] outside; [5, 22] mid 13.5 cg; [30, 40] mid 35 level;
    # [41, 60] mid 50.5 cg; [62, 69] mid 65.5 wait; [80, 95] mid 87.5 cg
    assert got["idle_s"] == pytest.approx(78e-6)
    assert got["innermost"] == pytest.approx({
        program_trace.OUTSIDE: 10e-6, "solid.cg": 17e-6 + 19e-6 + 15e-6, "mg.level": 10e-6,
        "cg.wait": 7e-6})
    assert got["under"] == pytest.approx({
        "solid.case": 68e-6, "solid.cg": 68e-6, "cg.precond": 10e-6, "mg.level": 10e-6,
        "cg.wait": 7e-6})
    # no device work at all: the window is one gap
    assert program_trace.idle_by_span(spans, [], (0.0, 110.0))["innermost"] == {
        "solid.cg": pytest.approx(110e-6)}


def test_open_spans_nest_and_close():
    spans = [("a", 0.0, 10.0), ("b", 1.0, 4.0), ("c", 2.0, 3.0), ("b", 5.0, 9.0),
             ("d", 20.0, 30.0), ("e", 20.0, 25.0)]
    points = [2.5, 3.5, 4.5, 6.0, 15.0, 20.0, 26.0, 31.0, -1.0]
    assert program_trace._open_at(spans, points) == [
        ("a", "b", "c"), ("a", "b"), ("a",), ("a", "b"), (), ("d", "e"), ("d",), (), ()]


def _run(device="cuda", kind="cases", trace=None):
    run = types.SimpleNamespace(device=torch.device(device), mix={"kind": kind}, answers=[],
                                analysis=None, profile=None)
    if trace is not None:
        run.program_trace = trace
    return run


def _readers():
    reg = Registry(ROOT)
    return reg, {m: reg.reader(m + ".x") for m in NEW}


def _span(name, ms, stream_ms=None):
    return {"name": name, "start_ns": 0, "end_ns": int(ms * 1e6),
            "device_ns": None if stream_ms is None else int(stream_ms * 1e6)}


def test_readers_read_nothing_without_a_card_a_recorder_or_spans(monkeypatch):
    reg, readers = _readers()
    for mod in readers.values():
        assert mod.FROM_TRACE is True
    for kind in ("cases", "analyses"):
        # no card; a card, but no request to trace
        for run in (_run("cpu", kind), _run("cuda", kind)):
            for name, mod in readers.items():
                assert mod.read(run, reg, name + ".x") is None
            assert run.program_trace is None
        empty = {"spans": [], "counters": {}, "idle": {"idle_s": 0.0, "innermost": {},
                                                       "under": {}}}
        for name, mod in readers.items():
            assert mod.read(_run("cuda", kind, trace=dict(empty)), reg, name + ".x") is None
    # a program without the recorder (femx_torch before it): None, and no request sent
    from femx_torch import profiling

    monkeypatch.delattr(profiling, "enable")
    run = _run("cuda", "cases")
    run.answers = [cells.Answer([{"x": 0}], None, None)]
    run.analysis = types.SimpleNamespace(solve_cases=lambda *a: pytest.fail("sent"))
    assert program_trace.read(run) is None and run.program_trace is None
    for name, mod in readers.items():
        assert mod.read(run, reg, name + ".x") is None


def test_readers_on_a_trace():
    reg, readers = _readers()
    # precond_ms: the cg.precond spans' time on the card's stream per CG
    # iteration (the counter), not their host time
    spans = ([_span("cg.precond", 30.0, 31.0), _span("cg.precond", 40.0, 41.0),
              _span("cg.precond", 20.0, 18.0), _span("cg.wait", 1.0), _span("cg.wait", 2.0),
              _span("solid.case", 600.0), _span("solid.precond_setup", 1500.0),
              _span("mg.coarse_factor", 1250.0)])
    trace = {"spans": spans, "counters": {"cg.iterations": 2},
             "idle": {"idle_s": 2.0, "innermost": {}, "under": {"cg.precond": 1.5}}}
    run = _run("cuda", trace=trace)
    got = {name: mod.read(run, reg, name + ".x") for name, mod in readers.items()}
    assert got == pytest.approx({"precond_ms": 45.0, "cg_wait_share": 0.5,
                                 "idle_in_precond": 75.0, "precond_setup_s": 1.5,
                                 "coarse_factor_s": 1.25})
    # spans without their stream's time, or no iteration counted: no precond_ms
    for sp, counters in ((spans, {}), ([_span("cg.precond", 30.0)], {"cg.iterations": 1})):
        run = _run("cuda", trace=dict(trace, spans=sp, counters=counters))
        assert readers["precond_ms"].read(run, reg, "precond_ms.x") is None


@pytest.mark.parametrize("workload", ["box1m-struct-cases", "box1m-msh-cases",
                                      "box1m-struct-analysis"])
def test_both_passes_on_a_small_cell(tmp_path, monkeypatch, workload):
    """A small copy's cell on the CPU: after its traced requests, the
    program trace's request gives the window's iterations; pass 1 records
    the spans its readers need, pass 2 puts the (here unbroken) idle time
    down to the spans open."""
    from femx_torch import SolidReactionAnalysis, profiling

    torch.set_num_threads(2)
    monkeypatch.setenv("FEMX_MG_CACHE", "0")  # as benchmark/run.py sets it
    root = small_copy(tmp_path)
    reg = Registry(root, root / "benchmark")
    w = reg.workload(workload)
    run = cells.Run(reg.config(w["config"]), reg.traffic(w["traffic"]), torch.device("cpu"),
                    True)
    old = SolidReactionAnalysis.MG_DOF_THRESHOLD, SolidReactionAnalysis.DENSE_DOF_LIMIT
    # the multigrid and lattice routes, as at full size
    SolidReactionAnalysis.MG_DOF_THRESHOLD = SolidReactionAnalysis.DENSE_DOF_LIMIT = 1000
    try:
        cells.KINDS[run.mix["kind"]](run, 2 ** 31 + 5, 0.3, 0.0)
        run.take_trace()
        assert program_trace.read(run) is None  # no card
        serve = program_trace._request(run)
        profiling.enable()
        try:
            info = serve()
            rec = profiling.collect()
            info2, idle = program_trace._profiled(serve, run.device, profiling)
        finally:
            profiling.disable()
            profiling.collect()
    finally:
        SolidReactionAnalysis.MG_DOF_THRESHOLD, SolidReactionAnalysis.DENSE_DOF_LIMIT = old
    assert info["iterations"] == info2["iterations"] == run.answers[-1].info["iterations"]
    assert info["residual"] == info2["residual"] == run.answers[-1].info["residual"]
    names = {s["name"] for s in rec["spans"]}
    assert {"solid.cg", "cg.apply", "cg.precond", "cg.wait", "mg.level"} <= names
    if run.mix["kind"] == "cases":
        assert "solid.case" in names
        assert ("lattice.bj" in names) == (workload == "box1m-msh-cases")
    else:
        assert {"solid.run_simulation", "solid.precond_setup", "mg.coarse_factor"} <= names
    assert rec["counters"]["cg.iterations"] == info["iterations"]
    assert all(s["device_ns"] is None for s in rec["spans"])  # no card's stream here
    assert idle["idle_s"] > 0
    assert sum(idle["innermost"].values()) == pytest.approx(idle["idle_s"])
