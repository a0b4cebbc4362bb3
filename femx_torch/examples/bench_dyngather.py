"""Throughput of the per-column gather out[i, j] = tab[idx[i, j], j] against
table height (counterpart of femx's examples/bench_dyngather.py).

For H in 8..4096 at a fixed total of 32 Mi output elements (G = TOTAL // H
blocks of H index rows, femx's grid), it runs femx_torch.gather.
take_along_axis(tab, idx, axis=0) — the hand-written CUDA kernel on the card
— on femx's inputs (numpy default_rng(0)), checks it against numpy, and
prints one JSON record per H: ns per output element, ms, correct, and the
device it ran on. Times are CUDA-event medians on a card; a CPU run (the
plain version) reports host-clock times under "host_ms" and
"host_ns_per_el" instead.

Run on a machine with a CUDA card: python -m femx_torch.examples.bench_dyngather
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from femx_torch.config import resolve_device
from femx_torch.gather import index_tensor, take_along_axis

HEIGHTS = (8, 32, 128, 512, 2048, 4096)
TOTAL = 32 * 1024 * 1024 // 128  # output rows across the grid


def _time_ms(fn, dev, reps: int) -> float:
    """Median of `reps` timed calls after one warm-up: CUDA events on a
    card, the host clock otherwise."""
    fn()
    samples = []
    for _ in range(reps):
        if dev.type == "cuda":
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            samples.append(t0.elapsed_time(t1))
        else:
            t = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t) * 1e3)
    return statistics.median(samples)


def main(device=None, heights=HEIGHTS, total: int = TOTAL, reps: int = 5):
    """Run the sweep; returns the records it printed."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rows = []
    for H in heights:
        G = max(1, total // H)
        rng = np.random.default_rng(0)
        tab_np = rng.standard_normal((H, 128)).astype(np.float32)
        idx_np = rng.integers(0, H, size=(G * H, 128)).astype(np.int32)
        tab = torch.as_tensor(tab_np, device=dev)
        idx = index_tensor(idx_np, H, dev)
        out = take_along_axis(tab, idx, axis=0)
        ok = bool(np.array_equal(out.cpu().numpy(), tab_np[idx_np, np.arange(128)[None, :]]))
        ms = _time_ms(lambda: take_along_axis(tab, idx, axis=0), dev, reps)
        n_el = G * H * 128
        host = "" if dev.type == "cuda" else "host_"
        rec = {"H": H, "grid": G, f"{host}ns_per_el": ms * 1e6 / n_el, f"{host}ms": ms,
               "correct": ok, "device": name}
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        del tab, idx, out
    return rows


if __name__ == "__main__":
    main()
