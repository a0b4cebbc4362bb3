"""One run of one cell, from its name to its result line (a dict)."""

from __future__ import annotations

import gc
import sys
from pathlib import Path

import torch

from harness import cells, check
from harness.registry import BENCH_DIR, Registry

# the numbers the reference gives for each kind of cell
COMPARED = {"cases": ["residual", "support"], "analyses": ["residual", "support", "reaction"]}


def kind_of(reg: Registry, kind: str):
    """(the kind's run(run, seed, seconds, t_start), the numbers its cells
    compare): cells.KINDS's, or benchmark/kinds/<kind>.py's run and
    COMPARED."""
    if kind in cells.KINDS:
        return cells.KINDS[kind], COMPARED[kind]
    mod = reg.kind(kind)
    return mod.run, mod.COMPARED


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, bench_dir: Path = BENCH_DIR,
             world=None) -> dict:
    """Set up, measure, read the metrics, judge the answers; the result
    line's keys, with `compared` last. With `world` (harness.ranks), this
    process is one rank of N: every rank measures and reads alike, rank 0
    alone judges and returns the line, the others None."""
    reg = Registry(root, bench_dir)
    w = reg.workload(workload)
    config = reg.config(w["config"])
    mix = reg.traffic(w["traffic"])
    run = cells.Run(config, mix, device, trace)
    run.world = world
    run_kind, compared_names = kind_of(reg, mix["kind"])
    run_kind(run, seed, seconds, t_start)
    if world is not None:
        world.share_peaks(run)

    its = [a.info.get("iterations") for a in run.answers]
    print(f"set-up {run.setup_s:.3f} s; window {run.window_s:.3f} s, {run.attempted} requests, "
          f"{run.failed} failed; latencies {[round(t, 4) for t in run.latencies]}; "
          f"iterations {its}", file=sys.stderr)
    e2e, layer = reg.metrics(workload)
    metrics = {}
    wanted = layer if trace else e2e
    readers = {m["name"]: reg.reader(m["name"]) for m in wanted}
    # the readers that time the program run before the traced requests, and
    # those that read its trace after it
    for from_trace in (False, True):
        if trace and from_trace:
            run.take_trace()
            gc.collect()
            if world is not None:
                world.share_spans(run)
        for m in wanted:
            if getattr(readers[m["name"]], "FROM_TRACE", False) == from_trace:
                value = readers[m["name"]].read(run, reg, m["name"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    metrics = {m["name"]: metrics[m["name"]] for m in wanted if m["name"] in metrics}

    # the program's state goes before the reference runs
    run.analysis = run.probe_rhs = run.take_trace = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not run.leads:
        return None
    worst, ref_s, gap = check.judge(config, run.answers, device)
    ok, compared = check.compare(worst, reg.limits(w["config"]), compared_names)
    compared["failed_requests"] = {"value": run.failed, "limit": 0}
    correct = bool(ok and run.failed == 0 and run.answers)
    print(f"reference judged {len(run.answers)} answers in {ref_s:.3f} s; its residual "
          f"differs from the program's own by {gap:.3e} of it at most", file=sys.stderr)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    if world is not None:
        dev["count"] = world.cards(run)
        dev["memory_peak_bytes_by_rank"] = [r["memory_peak_bytes"] for r in run.ranks]
    out = {"correct": correct, "attempted": run.attempted + run.profiled_requests,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    out["compared"] = compared
    return out


def forbidden_modules(names=("jax", "jaxlib", "flax", "femx")) -> list:
    """Top-level names of loaded modules that the program must not load,
    compared whole ("femx_torch" is not "femx")."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(names))

