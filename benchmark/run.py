#!/usr/bin/env python3
"""Run one cell of the femx_torch benchmark once, on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`) names a
configuration and a traffic mix; set-up builds the model from the seed and
warms its shapes, then a closed loop of requests runs for `--seconds`, and
the plain reference judges every answer once the window has closed. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and last `compared`, each
number that decided `correct` beside its limit (also the last lines of
standard error).

A cell whose configuration names `"devices": N` runs as the N ranks of
femx_torch's devices=N, started by the program's own launcher
(harness/ranks.py); rank 0's line is printed here, and a rank that fails or
passes its deadline ends the run nonzero with no result.

The run measures femx_torch only, and only on CUDA: without a card it exits
nonzero and prints no result, as it does when jax, jaxlib, flax or femx is
loaded once the window has closed. Every FEMX_* variable is cleared and the
multigrid disk cache is off, so no run leaves state for the next; kernels
build into build/ inside the checkout, so only its first run compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


HOST_THREADS = 4  # one process with few threads, the same on every machine


def isolate() -> None:
    """The run's environment, set before torch or the program is imported."""
    for k in [k for k in os.environ if k.startswith("FEMX_")]:
        del os.environ[k]
    os.environ["FEMX_MG_CACHE"] = "0"
    cache = ROOT / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = str(HOST_THREADS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    isolate()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"this run needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(HOST_THREADS)
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness import ranks
    from harness.device import card_power_limit
    from harness.session import forbidden_modules, run_cell

    n = ranks.devices_of(ROOT, args.workload)
    found = []
    if n > 1:
        try:
            recs = ranks.run_ranks(ROOT, args.workload, args.seed, args.seconds,
                                   bool(args.trace), n, T_START)
        except ranks.RanksFailed as e:
            print(f"the run ended: {e}", file=sys.stderr)
            return 5
        result = recs[0]["line"]
        found = [m for r in recs for m in r["forbidden"]]
    else:
        device = torch.device("cuda", 0)
        result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device,
                          T_START)
    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        print(f"the run loaded {', '.join(found)}: it measures femx_torch alone", file=sys.stderr)
        return 4
    name, power = card_power_limit(0)
    print(f"card {name}, power limit {power}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
