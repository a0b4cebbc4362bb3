"""A cell whose configuration names `"devices": N` runs as N ranks of
femx_torch's devices=N, here on the CPU over gloo; a rank that fails or
hangs ends the run; a configuration without the key spawns nothing."""

import json
import multiprocessing
import time

import pytest

from bench_cases import (ROOT, add_cell, hanging_rank, raising_rank, run_small_ranks,
                         small_copy)

from harness import ranks

CELL = "box1m-struct-cases-2rank"


@pytest.fixture
def two_ranks(tmp_path):
    root = small_copy(tmp_path)
    add_cell(root, CELL, "box1m-struct-2rank", "cases", devices=2)
    return root


def test_two_ranks_run_the_cell(two_ranks):
    recs = run_small_ranks(two_ranks, CELL, seed=2 ** 31 + 5, seconds=1.0)
    line = recs[0]["line"]
    assert [r["rank"] for r in recs] == [0, 1] and recs[1]["line"] is None
    assert line["correct"] is True and line["failed"] == 0
    assert recs[0]["attempted"] == recs[1]["attempted"] == line["attempted"] >= 1
    assert len(line["device"]["memory_peak_bytes_by_rank"]) == 2
    assert line["device"]["count"] == 1  # both ranks on the CPU
    for r in recs:
        assert r["devices"] == [2] * r["attempted"] and r["forbidden"] == []
    assert {"setup_s", "case_s", "case_p95_s"} <= set(line["metrics"])
    assert list(line)[-1] == "compared"
    json.dumps(line)


def test_two_ranks_traced(two_ranks):
    recs = run_small_ranks(two_ranks, CELL, seed=3, seconds=0.5, trace=True)
    line = recs[0]["line"]
    assert line["correct"] is True
    assert line["attempted"] == recs[1]["attempted"] + 2  # the traced pair, on both ranks
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("traffic,like", [("cases", "box1m-struct-cases"),
                                          ("analyses", "box1m-struct-analysis")])
def test_an_analysis_that_fell_back_is_a_failed_request(tmp_path, traffic, like):
    """A box of 3 cells in y cannot be coarsened as the halo route needs: the
    program falls back to one device without raising, and every request
    served by such an analysis (set-up's, or each one) counts as failed."""
    root = small_copy(tmp_path)
    add_cell(root, "odd-2rank", "box1m-struct-odd", traffic, devices=2, like=like,
             mesh_size=0.2 / 3)  # 12 x 3 x 12 cells
    recs = run_small_ranks(root, "odd-2rank", seed=4, seconds=0.5)
    line = recs[0]["line"]
    assert all(r["devices"] == [1] * r["attempted"] for r in recs)
    assert line["correct"] is False and line["failed"] == recs[0]["attempted"] >= 1


@pytest.mark.parametrize("fn", [raising_rank, hanging_rank], ids=["raises", "hangs"])
def test_a_rank_that_fails_ends_the_run(two_ranks, fn):
    deadline = 30.0
    t0 = time.monotonic()
    with pytest.raises(ranks.RanksFailed):
        run_small_ranks(two_ranks, CELL, fn=fn, deadline=deadline)
    assert time.monotonic() - t0 < deadline + 15
    assert multiprocessing.active_children() == []


def test_run_py_ends_nonzero_without_a_line(two_ranks, monkeypatch, capsys):
    """run.py prints no result and exits nonzero when the ranks fail; and
    a configuration without `devices` never starts them."""
    import torch

    import run

    monkeypatch.setattr(run, "ROOT", two_ranks)
    monkeypatch.setattr(run, "isolate", lambda: None)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def fails(*a, **k):
        raise ranks.RanksFailed("a planted failure")

    monkeypatch.setattr(ranks, "run_ranks", fails)
    args = ["--workload", CELL, "--seed", "1", "--seconds", "1"]
    assert run.main(args) != 0
    out = capsys.readouterr()
    assert out.out.strip() == "" and "a planted failure" in out.err

    import harness.session

    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "compared": {}}
    monkeypatch.setattr(harness.session, "run_cell", lambda *a, **k: dict(line))
    assert run.main(["--workload", "box1m-struct-cases", "--seed", "1", "--seconds", "1"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert multiprocessing.active_children() == []


def test_a_config_without_devices_takes_one_process(two_ranks):
    assert ranks.devices_of(two_ranks, CELL, two_ranks / "benchmark") == 2
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        assert ranks.devices_of(ROOT, w["name"]) == 1
