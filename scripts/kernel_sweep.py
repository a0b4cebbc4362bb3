#!/usr/bin/env python3
"""Check and time every built variant of structured_cell_matmul and take_rows
on the card, beside an earlier version of the kernels if one is given.

    python3 scripts/kernel_sweep.py [--baseline DIR] [--out FILE]

For structured_cell_matmul it runs each variant the source builds
(cell_matmul.BUILT) at eight lattices against the plain version with a
non-symmetric random cell matrix (float32 within 1e-5, float64 within 1e-12
relative), then times it (CUDA events) at the four lattices of the flagship
V-cycle and at one four times the flagship; at the flagship also over one
long run of 20,000 launches with the SM clock read meanwhile. For take_rows
it checks both width-3 kernels exactly and times them at the flagship's
u3[connT] shape with seeded random indices, beside torch.index_select.
`--baseline DIR` names a checkout of an earlier commit: its two sources are
built with the same flags and timed in the same run (their C entries take no
plan arguments), and the float32 result is compared bit for bit. Prints one
table per kernel and writes everything as JSON to --out. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from femx_torch import build, gather  # noqa: E402
from femx_torch.elements import cell_matmul as cm  # noqa: E402

HIERARCHY = [(24, 24, 96), (12, 12, 48), (6, 6, 24), (3, 3, 12), (48, 48, 96)]
ODD = [(5, 3, 7), (1, 1, 1), (7, 5, 33)]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

def cuda_ms(fn, reps=15, inner=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1) / inner)
    return statistics.median(samples)


def sustained_ms(fn, calls=20000):
    """Mean device time per call over one long run of back-to-back launches,
    and the SM clock nvidia-smi reports while it runs (short event-timed
    loops may finish before the card has left its idle clock)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(calls // 4):
        fn()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           stdout=subprocess.PIPE, text=True)
    for _ in range(calls - calls // 4):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / calls, smi.communicate(timeout=60)[0].strip()


def build_baseline(root, name):
    src = os.path.join(root, "femx_torch", "csrc", f"{name}.cu")
    out_dir = os.path.join(ROOT, "build", "baseline")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(lib)


def sweep_cell_matmul(baseline, sms):
    res = build.kernel_resources("structured_cell_matmul")
    rows = []
    P = ctypes.c_void_p
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(0)
        ndt = np.float32 if dtype == torch.float32 else np.float64
        kcell = torch.as_tensor(rng.standard_normal((81, 81)).astype(ndt), device="cuda")
        old = None
        if baseline:
            lib = build_baseline(baseline, "structured_cell_matmul")
            old = getattr(lib, "femx_structured_cell_matmul_" +
                          ("f32" if dtype == torch.float32 else "f64"))
            old.argtypes = [P] * 3 + [ctypes.c_int] * 3 + [P]
            old.restype = ctypes.c_int
        inputs = {}
        for n in HIERARCHY + ODD:
            ndof = cm.phase_offsets(n)[-1]
            u = torch.as_tensor(rng.standard_normal(ndof).astype(ndt), device="cuda")
            inputs[n] = (u, cm.structured_cell_matmul_plain(u, kcell, n))
        stream = torch.cuda.current_stream().cuda_stream
        if old is not None:
            row = {"dtype": str(dtype), "variant": "baseline", "ms": {}, "same_bits": {}}
            for n in HIERARCHY:
                u, want = inputs[n]
                fe = torch.empty_like(want)
                row["ms"][str(n)] = cuda_ms(lambda: old(
                    u.data_ptr(), kcell.data_ptr(), fe.data_ptr(), *n, stream))
                row["same_bits"][str(n)] = torch.equal(
                    fe, cm.structured_cell_matmul(u, kcell, n))
            rows.append(row)
        for v in cm.BUILT[dtype]:
            tag = v.entry_tag(dtype)
            info = next((r for e, r in res.items() if tag in e), {})
            row = {"dtype": str(dtype), "variant": v.label(), "code": v.code,
                   "smem": v.smem_bytes(kcell.element_size()), **info, "rel_err": {}, "ms": {}}
            for n, (u, want) in inputs.items():
                cells = n[0] * n[1] * n[2]
                plan = cm.plan_launch(cells, dtype, sms, variant=v)
                fe = torch.full_like(want, float("nan"))
                launch = cm._launcher(u, kcell, fe, n, plan)
                rc = launch()
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"{v.label()} at {n}: cudaError {rc}")
                err = ((fe - want).abs().max() / want.abs().max()).item()
                row["rel_err"][str(n)] = err
                if not err <= TOL[dtype]:
                    raise AssertionError(f"{v.label()} {dtype} at {n}: rel err {err}")
                if n in HIERARCHY:
                    row["ms"][str(n)] = cuda_ms(launch)
                    row.setdefault("grid", {})[str(n)] = plan.grid
                if n == HIERARCHY[0]:
                    row["sustained_ms"], row["clocks"] = sustained_ms(launch)
            rows.append(row)
            print(f"{str(dtype):14s} {row['variant']:52s} regs {row.get('registers')} spill "
                  f"{row.get('spill_bytes')} smem {row.get('smem', 0):6d} max rel err "
                  f"{max(row['rel_err'].values()):.2e}  ms " +
                  "  ".join(f"{row['ms'][str(n)]:.5f}" for n in HIERARCHY) +
                  f"  sustained {row['sustained_ms']:.5f} at {row['clocks']}", flush=True)
        for row in rows:
            if row["variant"] == "baseline" and row["dtype"] == str(dtype):
                print(f"{str(dtype):14s} {'baseline':52s} ms " +
                      "  ".join(f"{row['ms'][str(n)]:.5f}" for n in HIERARCHY) +
                      f"  planned variant bit-identical: {row['same_bits']}", flush=True)
    return rows


def sweep_take_rows(baseline):
    rows = []
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    n_nodes, shape = 463_393, (10, 331_776)
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(0)
        ndt = np.float32 if dtype == torch.float32 else np.float64
        tab = torch.as_tensor(rng.standard_normal((n_nodes, 3)).astype(ndt), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        fn = gather._kernel_fn("take_rows", dtype)
        for n_rows in (1, 127, 128, 129, 1000, 4097):  # ragged chunks, exact
            idx = gather.index_tensor(rng.integers(0, n_nodes, size=n_rows), n_nodes, "cuda")
            for per in (0, 1):
                out = torch.full((n_rows, 3), float("nan"), dtype=dtype, device="cuda")
                rc = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, 3, per, stream)
                torch.cuda.synchronize()
                if rc != 0 or not torch.equal(out, tab[idx.long()]):
                    raise AssertionError(f"take_rows {dtype} rows={n_rows} by_rows={per}: rc {rc}")
        idx = gather.index_tensor(rng.integers(0, n_nodes, size=shape), n_nodes, "cuda")
        flat = idx.long().reshape(-1)
        want = tab[idx.long()]
        out = torch.empty_like(want)
        row = {"dtype": str(dtype), "ms": {}}
        for per in (0, 1):
            out.fill_(float("nan"))
            launch = lambda: fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(),  # noqa: E731
                                idx.numel(), 3, per, stream)
            rc = launch()
            torch.cuda.synchronize()
            if rc != 0 or not torch.equal(out, want):
                raise AssertionError(f"take_rows {dtype} by_rows={per}: rc {rc}")
            row["ms"]["by_rows" if per else "default"] = cuda_ms(launch)
        if baseline:
            lib = build_baseline(baseline, "take_rows")
            old = getattr(lib, "femx_take_rows_" + ("f32" if dtype == torch.float32 else "f64"))
            old.argtypes = [P, P, P, I64, I, P]
            old.restype = I
            row["ms"]["baseline"] = cuda_ms(lambda: old(
                tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), 3, stream))
        row["ms"]["index_select"] = cuda_ms(lambda: torch.index_select(tab, 0, flat))
        item = tab.element_size()
        row["bytes_bound_ms"] = (tab.numel() * item + idx.numel() * 4 + out.numel() * item) / 3.35e9
        row["sector_bound_ms"] = (idx.numel() * (4 + 32) + out.numel() * item) / 3.35e9
        rows.append(row)
        print(f"take_rows {dtype}: " + json.dumps(row), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="checkout of an earlier commit to time beside this one")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "kernel_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    build.build(["structured_cell_matmul", "take_rows"])
    for name, (secs, out) in build.BUILD_LOG.items():
        print(f"nvcc {name}: {secs:.1f} s", flush=True)
        warn = [ln for ln in out.splitlines() if "warning" in ln or "error" in ln]
        print("\n".join(warn))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"card": smi, "sms": sms, "take_rows": sweep_take_rows(args.baseline),
              "structured_cell_matmul": sweep_cell_matmul(args.baseline, sms)}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    with open(args.out.replace(".json", "_ptxas.txt"), "w") as f:
        for name, (_, out) in build.BUILD_LOG.items():
            f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
