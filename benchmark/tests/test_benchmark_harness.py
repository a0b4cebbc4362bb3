"""The harness on the CPU: cells found by name, traffic from the seed, the
result line's keys, no CPU fallback, and no JAX anywhere."""

import ast
import json
import os
import subprocess
import sys

import pytest

from bench_cases import BENCH, ROOT, add_cell, run_small, run_small_ranks, small_copy

from harness import traffic
from harness.registry import Registry
from harness.session import forbidden_modules

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# a load at a corner of the top face, a lattice node at every mesh size the tests use
TIP_LOAD = {"x": 0.8, "y": 0.2, "z": 0.8, "fx": 0.0, "fy": -1000.0, "fz": 500.0}


def test_every_entry_is_found_by_name():
    reg = Registry(ROOT)
    spec = reg.spec
    for c in spec["configs"]:
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert reg.config(c["name"])["source"] == c["source"]
        assert reg.config(c["name"])["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        reg.workload(w["name"])
        assert reg.traffic(w["traffic"])["kind"] in ("cases", "analyses")
        reg.limits(w["config"])
        e2e, layer = reg.metrics(w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        for m in e2e + layer:
            assert callable(reg.reader(m["name"]).read)
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for c in spec["configs"]:
        route = reg.config(c["name"])["route"]
        assert callable(reg.roofline(route["operator"]).count)


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    root = small_copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    mix = json.loads((root / "benchmark/traffic/cases.json").read_text())
    mix["requests"] = [mix["requests"][0] + [TIP_LOAD]]
    (root / "benchmark/traffic/cases2.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "box1m-struct-cases2", "config": "box1m-struct",
                              "traffic": "cases2", "chips": 1, "why": "two loads"})
    for m in spec["end_to_end"]:
        if "box1m-struct-cases" in m.get("workloads", []):
            m["workloads"].append("box1m-struct-cases2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run_small(root, "box1m-struct-cases2", seconds=0.5)
    assert res["correct"] and {"setup_s", "case_s", "case_p95_s"} <= set(res["metrics"])

    # a kind of cell that harness.cells does not hold, from its own file
    (root / "benchmark/kinds").mkdir()
    (root / "benchmark/kinds/cases_residual.py").write_text(
        "from harness import cells\n"
        "COMPARED = ['residual']\n"
        "def run(run, seed, seconds, t_start):\n"
        "    cells.run_cases(run, seed, seconds, t_start)\n")
    mix["kind"] = "cases_residual"
    (root / "benchmark/traffic/cases_residual.json").write_text(json.dumps(mix))
    add_cell(root, "box1m-struct-residual", "box1m-struct", "cases_residual")
    res = run_small(root, "box1m-struct-residual", seconds=0.5)
    assert res["correct"] and list(res["compared"]) == ["residual", "failed_requests"]

    # a cell of two ranks, from a configuration that names them
    add_cell(root, "box1m-struct-cases-2rank", "box1m-struct-2rank", "cases", devices=2)
    recs = run_small_ranks(root, "box1m-struct-cases-2rank", seconds=0.5)
    res = recs[0]["line"]
    assert res["correct"] and {"setup_s", "case_s", "case_p95_s"} <= set(res["metrics"])
    assert len(res["device"]["memory_peak_bytes_by_rank"]) == 2
    assert all(p.read_bytes() == b for p, b in before.items())


def test_traffic_is_the_seeds():
    """The cells serve the source's one documented request; a mix of
    several draws them from the seed, the same for one seed and not for
    another."""
    documented = [{"x": 0.4, "y": 0.2, "z": 0.4, "fx": 0.0, "fy": 3000.0, "fz": 0.0}]

    def first(mix, seed, n=40):
        s = traffic.requests(seed, mix)
        return [next(s) for _ in range(n)]

    big = 2 ** 31 + 12345
    for name in ("cases", "analyses"):
        mix = json.loads((ROOT / f"benchmark/traffic/{name}.json").read_text())
        assert mix["requests"] == [documented]
        assert first(mix, big) == [documented] * 40
        assert traffic.warmup_requests(big, mix, 2) == [documented] * 2
        assert traffic.traced_request(big, mix) == documented
        assert traffic.load_points(mix) == [(0.4, 0.2, 0.4)]
    mix = {"kind": "cases", "requests": [documented, [TIP_LOAD], documented + [TIP_LOAD]]}
    assert first(mix, big) == first(mix, big)
    assert first(mix, big) != first(mix, big + 1)
    assert first(mix, 3) != first(mix, 4)
    assert traffic.warmup_requests(big, mix, 10) != first(mix, big, 10)
    assert {len(r) for r in first(mix, big)} == {1, 2}
    assert traffic.load_points(mix) == [(0.4, 0.2, 0.4), (0.8, 0.2, 0.8)]


@pytest.mark.parametrize("workload,trace", [(w, t) for w in WORKLOADS for t in (False, True)])
def test_result_line(tmp_path, workload, trace):
    res = run_small(small_copy(tmp_path), workload, seed=2 ** 31 + 99, seconds=0.5, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["compared"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] is not None
    for v in res["compared"].values():
        assert v["value"] <= v["limit"]
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    json.dumps(res)


def test_the_measured_path_needs_a_card(tmp_path):
    """Without CUDA the command exits nonzero and prints no result; so it
    does in a checkout that holds only the benchmark."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for root in (ROOT, small_copy(tmp_path)):
        env = dict(os.environ, PYTHONPATH="")
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                            "--seed", "1", "--seconds", "1", "--trace", "0"],
                           cwd=root, env=env, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        tops = {name.split(".", 1)[0] for name in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "femx"}, f
    ref = {name.split(".", 1)[0] for name in _imports(BENCH / "reference.py")}
    assert ref <= {"__future__", "itertools", "typing", "numpy", "torch"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "femx_torch_extra", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "femx.mesh", sys)
    assert forbidden_modules() == ["femx"]
