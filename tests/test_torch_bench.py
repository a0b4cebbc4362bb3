"""python -m femx_torch.bench == bench.py's run_bench on the CPU at a small
grid (4x4x16 cells, float64 on both sides, as bench.py runs on the CPU):
one JSON line carrying BENCH_r05.json's field names (compile_s and
modal10_compile_s replaced by first_solve_s and modal10_first_s,
vs_baseline left out) with a device-time field beside every time and the
card's name and power limit; the same iteration counts (f64 MG-PCG, the
accurate solve's inner iterations, the Lanczos inner solves within 2 and
the unstructured group-ELL solve within 1) and the refined f1 within 1e-6
of femx's; and the operator choice (cluster, tg, an unknown name)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from femx_torch import bench

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
GRID = (4, 4, 16)
TIME_FIELDS = ("value", "setup_s", "first_solve_s", "f32_solve_s", "modal10_s",
               "modal10_first_s", "modal_validation_s", "unstructured_solve_s",
               "unstructured_first_solve_s", "unstructured_setup_s", "unstructured_assembly_s")


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


@pytest.fixture(scope="module")
def records():
    """(femx's bench.py record, the port's JSON line parsed) at GRID."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FEMX_MG_CACHE", "0")
    mp.setenv("FEMX_BENCH_GRID", ",".join(map(str, GRID)))
    mp.delenv("FEMX_UNSTRUCTURED_OP", raising=False)
    mp.delenv("FEMX_BENCH_UNSTRUCTURED", raising=False)
    spec = importlib.util.spec_from_file_location("femx_bench", REPO / "bench.py")
    fx_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx_bench)
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fx_bench.run_bench()
    fx = json.loads(buf.getvalue().strip().splitlines()[-1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(["--device", "cpu"]) == 0
    lines = buf.getvalue().strip().splitlines()
    mp.undo()
    assert len(lines) == 1
    return fx, json.loads(lines[0])


def test_json_line_fields(records):
    fx, pt = records
    r05 = json.loads((REPO / "BENCH_r05.json").read_text())["parsed"]
    renamed = {"compile_s": "first_solve_s", "modal10_compile_s": "modal10_first_s"}
    want = {renamed.get(k, k) for k in r05} - {"vs_baseline", "mg_cache"}
    assert want <= set(pt), sorted(want - set(pt))
    assert set(fx) - {"vs_baseline", "mg_cache", *renamed} <= set(pt)
    for k in TIME_FIELDS:
        assert pt[k] > 0 and f"{k.removesuffix('_s')}_device_ms" in pt, k
    assert pt["name"] == "cpu" and "power_limit" in pt
    assert pt["unstructured_op"] == fx["unstructured_op"] == "groupell"
    assert pt["dtype"] == "float64" and pt["grid"] == list(GRID)
    assert pt["metric"] == fx["metric"] and "vs_baseline" not in pt


def test_counts_and_frequency_match_femx(records):
    fx, pt = records
    assert pt["f32_iters"] == fx["f32_iters"]
    assert str(pt["refined_inner_iters"]) in fx["unit"]
    assert pt["true_residual"] <= 1e-8
    assert abs(pt["modal10_inner_solves"] - fx["modal10_inner_solves"]) <= 2
    assert abs(pt["unstructured_iters"] - fx["unstructured_iters"]) <= 1
    # femx rounds its frequencies to 4 decimals
    np.testing.assert_allclose(pt["modal_f1_hz"], fx["modal_f1_hz"], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(pt["modal_f1_lanczos_hz"], fx["modal_f1_lanczos_hz"],
                               rtol=1e-6, atol=1e-4)
    assert pt["modal_f1_err_est"] <= 1e-6 and pt["modal_max_err_est"] <= 1e-2


@pytest.mark.parametrize("kind", ["cluster", "tg"])
def test_unstructured_flow_operators(kind):
    """The other two operators of the unstructured flow on the same
    relabelled box: the group-ELL one's iteration count within 1 and the
    same converged answer in global order (1e-7)."""
    problem = bench.flagship_problem(GRID)
    out = {}
    for k in ("groupell", kind):
        ub = bench.setup_unstructured(problem, k, np.float64, "cpu")
        res = bench.unstructured_solve(ub)
        assert res.converged and ub.setup_s >= ub.assembly_s > 0
        out[k] = (res.iterations, ub.op.to_global(res.x.numpy()))
    assert type(ub.op) is bench.UNSTRUCTURED_OPS[kind]
    assert abs(out[kind][0] - out["groupell"][0]) <= 1
    want = out["groupell"][1]
    np.testing.assert_allclose(out[kind][1], want, atol=1e-7 * np.abs(want).max())


def test_unknown_operator_raises(monkeypatch):
    monkeypatch.setenv("FEMX_UNSTRUCTURED_OP", "nope")
    with pytest.raises(ValueError, match="FEMX_UNSTRUCTURED_OP"):
        bench.run_bench(grid=GRID, device="cpu")
