"""femx_torch.profiling's recorder on the CPU: spans nest, with parent and
request ids; counters; off, one shared no-op context and nothing recorded;
each span on the profiler's clock under torch.profiler; pcg's spans and
iteration counter, with the same answer traced or not; and the spans of the
solid route (stage_times, solve_info, the V-cycle by level, the lattice
preconditioner, load cases). No jax here: the file also runs on the card's
machine (`python -m pytest --noconftest tests/test_torch_profiling.py`)."""

import time
from collections import Counter

import numpy as np
import pytest
import torch

import femx_torch
from femx_torch import profiling
from femx_torch.mesh import relabel_nodes
from femx_torch.profiling import collect, count, disable, enable, span, timed
from femx_torch.solve.cg import pcg, pcg_mixed

torch.set_num_threads(2)

E, NU = 2e11, 0.3


@pytest.fixture(autouse=True)
def _tracing_off_after(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    yield
    disable()
    collect()


def _by_name(rec):
    out = {}
    for s in rec["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_spans_nest_with_parent_and_request_ids():
    enable()
    with span("a", tag=1):
        with span("b"):
            with span("c"):
                pass
        with span("b"):
            pass
    with span("a"):
        pass
    rec = collect()
    assert [s["name"] for s in rec["spans"]] == ["c", "b", "b", "a", "a"]
    c, b1, b2, a1, a2 = rec["spans"]
    assert a1["parent"] is None and a2["parent"] is None
    assert b1["parent"] == b2["parent"] == a1["id"] and c["parent"] == b1["id"]
    assert c["request"] == b1["request"] == b2["request"] == a1["request"] != a2["request"]
    assert len({s["id"] for s in rec["spans"]}) == 5
    assert a1["attrs"] == {"tag": 1} and c["attrs"] == {}
    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
        assert s["epoch_end_ns"] - s["epoch_start_ns"] == s["end_ns"] - s["start_ns"]
    assert a1["start_ns"] <= b1["start_ns"] <= c["start_ns"] <= c["end_ns"] <= b1["end_ns"]
    assert b1["end_ns"] <= b2["start_ns"] and b2["end_ns"] <= a1["end_ns"] <= a2["start_ns"]
    # no stream to time them on: enable() without a CUDA device
    assert all(s["device_ns"] is None for s in rec["spans"])
    assert collect() == {"spans": [], "counters": {}}
    enable("cpu")
    with span("a"):
        pass
    assert [s["device_ns"] for s in collect()["spans"]] == [None]


def test_counters():
    enable()
    count("x")
    count("x", 4)
    count("y", 0)
    assert collect()["counters"] == {"x": 5, "y": 0}
    count("x")
    disable()
    count("x", 10)
    assert collect()["counters"] == {"x": 1}


def test_off_records_nothing():
    disable()
    first = span("a")
    assert span("b", k=2) is first
    with first:
        with span("c"):
            count("n", 3)
    assert collect() == {"spans": [], "counters": {}}
    # a timed span times itself off too, and records nothing
    with timed("t", "cpu") as t:
        time.sleep(0.002)
    assert t.seconds >= 0.002
    assert collect()["spans"] == []


def test_enable_drops_what_was_recorded():
    enable()
    with span("old"):
        count("n")
    enable()
    with span("new"):
        pass
    rec = collect()
    assert [s["name"] for s in rec["spans"]] == ["new"] and rec["counters"] == {}


def test_spans_sit_on_the_profiler_clock():
    """Under a CPU torch.profiler each span is a record_function event of
    its name, whose start agrees with the span's epoch-clock start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enable()
        with span("outer.span"):
            torch.ones(64).sum()
            with timed("inner.timed", "cpu"):
                torch.ones(64) @ torch.ones(64)
        rec = collect()
        disable()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    assert len(rec["spans"]) == 2
    for s in rec["spans"]:
        e = events[s["name"]]
        assert abs(e.start_ns() - s["epoch_start_ns"]) < 1e6, (s["name"], e.start_ns(),
                                                               s["epoch_start_ns"])
        assert e.end_ns() >= e.start_ns()


@pytest.mark.cuda
def test_spans_time_the_cards_stream():
    """With enable(cuda), a span that only launches work reads the card's
    time for it, not the launch's; a span in which the card waits for the
    host reads the host's time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA events have no CPU mode")
    torch.cuda._sleep(1000)  # the kernel's first launch loads it
    torch.cuda.synchronize()
    enable("cuda")
    with span("launch"):
        torch.cuda._sleep(50_000_000)  # ~25 ms of the card's clock
    torch.cuda.synchronize()
    with span("host"):
        time.sleep(0.01)
    rec = collect()
    launch, host = rec["spans"]
    assert launch["device_ns"] > 10e6 > launch["end_ns"] - launch["start_ns"]
    assert host["device_ns"] == pytest.approx(host["end_ns"] - host["start_ns"], rel=0.1)


def _spd(n=120, seed=0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    A = torch.as_tensor(Q @ np.diag(np.linspace(1.0, 300.0, n)) @ Q.T)
    return A, torch.as_tensor(rng.normal(size=n)), torch.as_tensor(1.0 / np.diag(A.numpy()))


@pytest.mark.parametrize("mixed", [False, True])
def test_pcg_spans_and_counter_change_no_number(mixed):
    """Traced or not, pcg gives the bitwise-same x and iteration count; traced,
    one cg.apply, cg.precond and cg.wait per iteration, one more of each
    for the initial residual and preconditioning and for the test that stops
    it, and cg.iterations equal to the result's."""
    A, b, dinv = _spd()

    def solve():
        if mixed:
            return pcg_mixed(lambda v: A @ v, b, lambda r: dinv.to(r.dtype) * r, tol=1e-9)
        return pcg(lambda v: A @ v, b, M_inv_diag=dinv, tol=1e-9)

    off = solve()
    enable()
    on = solve()
    rec = collect()
    disable()
    assert on.iterations == off.iterations > 5
    assert torch.equal(on.x, off.x) and on.residual_norm == off.residual_norm
    names = Counter(s["name"] for s in rec["spans"])
    k = on.iterations
    assert names == {"cg.apply": k + 1, "cg.precond": k + 1, "cg.wait": k + 1}
    assert rec["counters"] == {"cg.iterations": k}
    # every cg span is a request of its own here: pcg opens none around them
    assert all(s["parent"] is None for s in rec["spans"])


def _box(cells, h=0.05):
    X, Y, Z = (c * h for c in cells)
    corners = [(0, 0, 0), (X, 0, 0), (0, 0, Z), (X, 0, Z)]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]

    def force(fy, at=0.5):
        return [{"force_x": 0.0, "force_y": fy, "force_z": 0.0, "force_x_pstn": X * at,
                 "force_y_pstn": Y, "force_z_pstn": Z / 2}]

    mesh = femx_torch.box_tet10(X, Y, Z, h, fix_points=corners,
                                force_points=[(X / 2, Y, Z / 2), (X / 4, Y, Z / 2)])
    return mesh, fix, force


def _analysis(mesh, fix, force, **limits):
    fa = femx_torch.SolidReactionAnalysis(mesh, force(-500.0), fix, E=E, v=NU,
                                          verbose=False, dtype=np.float32, cg_tol=1e-8,
                                          device="cpu")
    for k, v in limits.items():
        setattr(fa, k, v)
    return fa


def test_structured_analysis_keeps_its_records_and_handles():
    """A small structured float32 MG analysis: every stage_times key, the
    solve_info times, _precond and _op64 kept (the benchmark's vcycle_ms and
    apply_roofline read them); traced, the stages of run_simulation share
    its request, the V-cycle is split by level, and solve_cases gives one
    solid.case request per case; the answers traced and not are the same."""
    mesh, fix, force = _box((8, 4, 8))  # 7,803 DOF, two MG levels
    fa = _analysis(mesh, fix, force, MG_DOF_THRESHOLD=600).run_simulation()
    assert fa.solve_info["method"] == "structured_multigrid_pcg_mixed"
    assert set(fa.stage_times) == {"read_mesh", "assemble", "bc", "solve"}
    assert all(v >= 0 for v in fa.stage_times.values())
    info = fa.solve_info
    assert 0 <= info["precond_setup_s"] and 0 <= info["solve_s"]
    assert info["precond_setup_s"] + info["solve_s"] <= fa.stage_times["solve"] + 2e-3
    assert fa._precond is not None and fa._op64 is not None
    assert callable(fa._precond) and callable(fa._op64.apply_constrained)
    off = fa.solve_cases([force(-500.0), force(300.0, at=0.25)])

    enable()
    tr = _analysis(mesh, fix, force, MG_DOF_THRESHOLD=600)
    tr.run_simulation()
    cases = tr.solve_cases([force(-500.0), force(300.0, at=0.25)])
    rec = collect()
    disable()
    np.testing.assert_array_equal(tr.u, fa.u)
    np.testing.assert_array_equal(cases, off)
    assert tr.case_solve_info == fa.case_solve_info
    by = _by_name(rec)
    (run,) = by["solid.run_simulation"]
    assert run["parent"] is None
    for name in ("solid.assemble", "solid.bc", "solid.solve"):
        (s,) = by[name]
        assert s["parent"] == run["id"] and s["request"] == run["request"]
    (solve,) = by["solid.solve"]
    for name in ("solid.precond_setup", "solid.op64", "solid.cg", "solid.reactions"):
        assert [s["parent"] for s in by[name] if s["request"] == run["request"]] == [solve["id"]]
    (read,) = by["solid.read_mesh"]
    assert read["parent"] is None and read["request"] != run["request"]
    (factor,) = by["mg.coarse_factor"]
    assert factor["request"] == run["request"]
    # the V-cycle: one mg.level per level per call, nested level in level
    ids = {s["id"]: s for s in rec["spans"]}
    n_levels = len(tr._precond.levels)
    assert {s["attrs"]["level"] for s in by["mg.level"]} == set(range(n_levels))
    for s in by["mg.level"]:
        up = ids[s["parent"]]
        if s["attrs"]["level"] == 0:
            assert up["name"] == "cg.precond"
        else:
            assert up["name"] == "mg.level" and up["attrs"]["level"] == s["attrs"]["level"] - 1
    for name in ("mg.smooth", "mg.restrict", "mg.prolong", "mg.coarse_solve"):
        assert by[name] and all(ids[s["parent"]]["name"] == "mg.level" for s in by[name])
    n_pre = len(by["cg.precond"])
    assert len(by["mg.coarse_solve"]) == n_pre and len(by["mg.level"]) == n_levels * n_pre
    assert n_pre == info["iterations"] + 1 + sum(i["iterations"] + 1
                                                 for i in tr.case_solve_info)
    # the load cases: a request each, its CG inside, its iterations counted
    case_spans = by["solid.case"]
    assert len(case_spans) == 2 and all(s["parent"] is None for s in case_spans)
    for s, i in zip(case_spans, tr.case_solve_info):
        (cg,) = [c for c in by["solid.cg"] if c["parent"] == s["id"]]
        waits = [w for w in by["cg.wait"] if w["parent"] == cg["id"]]
        assert len(waits) == i["iterations"] + 1
    assert rec["counters"]["cg.iterations"] == (info["iterations"]
                                                + sum(i["iterations"]
                                                      for i in tr.case_solve_info))


def test_lattice_route_spans():
    """The mesh-file route with the lattice preconditioner: lattice.bj and
    two lattice.transfer spans per call inside cg.precond, the lattice's
    V-cycles below it."""
    mesh, fix, force = _box((4, 2, 4))
    mesh = relabel_nodes(mesh, np.random.default_rng(1).permutation(mesh.num_nodes))
    enable()
    fa = _analysis(mesh, fix, force, DENSE_DOF_LIMIT=600, MG_DOF_THRESHOLD=600)
    fa.run_simulation()
    rec = collect()
    disable()
    assert fa.solve_info["method"] == "tg_lattice_mg_pcg_mixed"
    by = _by_name(rec)
    # solve_s: the solve stage less the preconditioner set-up and the reactions
    (solve,), (pre,), (reac,) = by["solid.solve"], by["solid.precond_setup"], by["solid.reactions"]
    rest = solve["end_ns"] - solve["start_ns"] - sum(s["end_ns"] - s["start_ns"]
                                                     for s in (pre, reac))
    assert fa.solve_info["solve_s"] == pytest.approx(rest * 1e-9, abs=1e-3)
    ids = {s["id"]: s for s in rec["spans"]}
    n_pre = len(by["cg.precond"])
    assert n_pre == fa.solve_info["iterations"] + 1
    assert len(by["lattice.bj"]) == n_pre and len(by["lattice.transfer"]) == 2 * n_pre
    for name in ("lattice.bj", "lattice.transfer"):
        assert {ids[s["parent"]]["name"] for s in by[name]} == {"cg.precond"}
    top = [s for s in by["mg.level"] if s["attrs"]["level"] == 0]
    assert len(top) == fa._precond.n_cycles * n_pre
    assert {ids[s["parent"]]["name"] for s in top} == {"cg.precond"}
    assert len(by["solid.precond_setup"]) == 1 and by["mg.coarse_factor"]


def test_timed_records_when_on():
    enable()
    with timed("stage", "cpu", k=1) as t:
        with span("inner"):
            pass
    rec = collect()
    assert [s["name"] for s in rec["spans"]] == ["inner", "stage"]
    inner, stage = rec["spans"]
    assert inner["parent"] == stage["id"] and stage["attrs"] == {"k": 1}
    assert t.seconds == pytest.approx((stage["end_ns"] - stage["start_ns"]) * 1e-9)
    assert profiling.timed("x").sync is None and profiling.timed("x", "cpu").sync is None
