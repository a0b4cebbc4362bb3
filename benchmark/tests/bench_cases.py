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


def add_cell(root: Path, name: str, config: str, traffic: str, devices: int = 1,
             like: str = "box1m-struct-cases", mesh_size: float = 0.05) -> None:
    """A new cell in the copy at `root`, from new files and entries alone:
    with `devices` > 1 a new configuration `config` (box1m-struct's file
    with "devices", meshed at `mesh_size`, its limits beside it); end-to-end
    metrics as the cell `like` has them. The halo route of devices=N
    coarsens its first level on all three axes: 0.05 m (16 x 4 x 16 cells)
    takes it, 0.1 m (8 x 2 x 8) does not."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if devices > 1:
        base = next(c for c in spec["configs"] if c["name"] == "box1m-struct")
        cfg = json.loads((root / base["file"]).read_text())
        cfg.update(name=config, devices=devices, mesh_size_m=mesh_size)
        (root / f"benchmark/configs/{config}.json").write_text(json.dumps(cfg))
        shutil.copy(root / "benchmark/limits/box1m-struct.json",
                    root / f"benchmark/limits/{config}.json")
        spec["configs"].append(dict(base, name=config, file=f"benchmark/configs/{config}.json"))
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def small_rank(*args):
    """harness.ranks.rank_main with the multigrid and lattice routes taken
    above 1,000 DOF, as run_small does; set here, in the rank, since a
    spawned rank does not see the parent's settings."""
    from femx_torch import SolidReactionAnalysis

    from harness import ranks

    SolidReactionAnalysis.MG_DOF_THRESHOLD = 1000
    return ranks.rank_main(*args)


def raising_rank(*args):
    """small_rank, but rank 1 raises at its start."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("a rank that fails")
    return small_rank(*args)


def hanging_rank(*args):
    """small_rank, but rank 1 never comes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(3600)
    return small_rank(*args)


def run_small_ranks(root: Path, workload: str, n: int = 2, seed: int = 7, seconds: float = 1.0,
                    trace: bool = False, fn=small_rank, deadline=None) -> list:
    """Every rank's record of one run of a devices=N cell of the small copy,
    its N ranks on the CPU over gloo."""
    from harness import ranks

    return ranks.run_ranks(root, workload, seed, seconds, trace, n, time.perf_counter(),
                           device="cpu", bench_dir=root / "benchmark", fn=fn, deadline=deadline)
