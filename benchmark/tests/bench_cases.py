"""Shared by the benchmark's tests (not a test file): a copy of the
benchmark with small boxes, and runs of its cells on the CPU."""

import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

def small_copy(tmp: Path, mesh_size: float = 0.1) -> Path:
    """A checkout root under tmp holding BENCHMARK.json and the benchmark's
    folder, every configuration meshed at `mesh_size` (0.1 m: 8 x 2 x 8
    cells of the 0.8 x 0.2 x 0.8 m box; the source's own 0.05 m: 16 x 4 x
    16)."""
    shutil.copytree(BENCH, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["mesh_size_m"] = mesh_size
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def run_small(root: Path, workload: str, seed: int = 7, seconds: float = 1.0,
              trace: bool = False) -> dict:
    """One run of a cell of the small copy on the CPU; the multigrid and
    lattice routes taken above 1,000 DOF, as at full size above 150,000."""
    import torch

    from femx_torch import SolidReactionAnalysis

    torch.set_num_threads(2)  # the test workers share the host
    from harness.session import run_cell

    old = SolidReactionAnalysis.MG_DOF_THRESHOLD
    SolidReactionAnalysis.MG_DOF_THRESHOLD = 1000
    try:
        return run_cell(root, workload, seed, seconds, trace, torch.device("cpu"),
                        time.perf_counter(), bench_dir=root / "benchmark")
    finally:
        SolidReactionAnalysis.MG_DOF_THRESHOLD = old
