"""`correct` comes out false for the control (the program's float32 path
in place of the float64 solve) and for each fault a cell can have, with
the rest of a run driven on the CPU at a small box; and a cell run on the
card when there is one."""

import json
import os
import subprocess
import sys

import pytest

from bench_cases import ROOT, run_small, small_copy

import control

CASES = ["box1m-struct-cases", "box1m-msh-cases"]
ALL = CASES + ["box1m-struct-analysis"]


@pytest.mark.parametrize("workload", ALL)
def test_the_control_is_not_correct(tmp_path, workload):
    root = small_copy(tmp_path, mesh_size=0.05)
    with control.control():
        res = run_small(root, workload, seed=11, seconds=0.5)
    assert res["correct"] is False
    assert res["compared"]["residual"]["value"] > res["compared"]["residual"]["limit"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in ALL for f in ("unchanged", "altered")]
                         + [(w, "dropped") for w in CASES])
def test_each_fault_is_not_correct(tmp_path, workload, fault):
    root = small_copy(tmp_path)
    with control.FAULTS[fault]():
        res = run_small(root, workload, seed=12, seconds=1.0)
    assert res["correct"] is False


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CASES[0],
                        "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, env=dict(os.environ), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
