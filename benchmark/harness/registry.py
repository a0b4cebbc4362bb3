"""What a cell is made of, found by name: BENCHMARK.json at the root of
the checkout names the cell's configuration and traffic; the files sit
under the benchmark's folder:

  configs/<config>.json   the configuration as it is run (the entry's "file")
  traffic/<traffic>.json  the traffic mix, read by harness.traffic
  metrics/<metric>.py     the metric's reader; a name with a dot falls back
                          to the reader of the part before the first dot
  limits/<config>.json    the limits of the numbers `correct` compares
  kinds/<kind>.py         a traffic `kind` that harness.cells.KINDS does not
                          hold: `run(run, seed, seconds, t_start)`, which
                          sets up and measures as cells.run_cases does, and
                          `COMPARED`, the names of the numbers of
                          reference.BoxModel.judge that `correct` compares

A configuration may name `"devices": N`: the cell then runs as the N ranks
of femx_torch's devices=N (harness/ranks.py).

A later cell adds files and entries here and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Tuple

BENCH_DIR = Path(__file__).resolve().parent.parent


class Registry:
    """BENCHMARK.json of `root` and the benchmark's files under `bench_dir`."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, config_name: str) -> dict:
        return json.loads((self.bench_dir / "limits" / f"{config_name}.json").read_text())

    def metrics(self, workload: str) -> Tuple[List[dict], List[dict]]:
        """(end-to-end, per-layer) metric entries the cell reports: those
        whose `workloads` name it, or, without the key, every cell (an
        end-to-end metric) or every cell that reports the metric it moves
        (a per-layer one)."""
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        names = {m["name"] for m in e2e}
        layer = [m for m in self.spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
        return e2e, layer

    def reader(self, metric: str):
        """The module of `metric`'s reader (its `read(run)` returns the value
        or None when the run has nothing to read)."""
        d = self.bench_dir / "metrics"
        path = d / f"{metric}.py"
        if not path.exists():
            path = d / f"{metric.split('.', 1)[0]}.py"
        return _load(path, "bench_metric_" + path.stem.replace(".", "_").replace("-", "_"))

    def kind(self, kind: str):
        """The module of a traffic kind of its own (its `run` and
        `COMPARED`)."""
        return _load(self.bench_dir / "kinds" / f"{kind}.py",
                     "bench_kind_" + kind.replace(".", "_").replace("-", "_"))

    def roofline(self, operator: str):
        """The module that counts `operator`'s operations and bytes."""
        return _load(self.bench_dir / "rooflines" / f"{operator}.py", "bench_roofline_" + operator)


_MODULES: Dict[str, object] = {}


def _load(path: Path, name: str):
    key = str(path)
    if key not in _MODULES:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]
