#!/usr/bin/env python3
"""On-card smoke test of femx_torch, the PyTorch/CUDA port of femx.

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):
  1. device   — nvidia-smi's name and power limit, torch's device name;
  2. build    — nvcc builds every kernel under femx_torch/csrc;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                float32 and float64, at the flagship shape (24, 24, 96) and
                an odd small one (5, 3, 7);
  4. timing   — kernel, plain and library times (CUDA events, median) beside
                the card's bound for the same work;
  5. default  — the reference default case (README quick start, 29,403 DOF,
                block-Jacobi, f64) through SolidReactionAnalysis on the card,
                held to the golden assertions;
  6. flagship — the main path: SolidReactionAnalysis on the 24x24x96 lattice
                (1,390,179 DOF, dtype float32: f64 CG preconditioned by the
                f32 V-cycle), then 3 warm runs whose median is the accurate
                solve time;
  7. bench    — bench.py's flow (face-clamped cantilever, StructuredMultigrid
                + pcg to 1e-5, then pcg_refined to 1e-8) through the port.
Phases 5, 6 and 7 each set the kernel launch counts to 0 just before their
first run, read them just after and check them against the count the solve
implies.
The last two lines are a {"kernels": [...]} JSON object and the
{"ok": true, "device": {...}} JSON object. Without CUDA it exits nonzero and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
FLAGSHIP = (24, 24, 96)
ODD = (5, 3, 7)
H = 1.6 / 96  # flagship cell size (bench.py)
E, NU = 2e11, 0.3
TOL = {"float32": 1e-5, "float64": 1e-12}  # max|kernel - plain| / max|plain|

# Published peaks (NVIDIA data sheets, dense): FP32 TFLOP/s outside the
# tensor cores, FP64 TFLOP/s on the tensor cores (DMMA, full IEEE FP64, the
# card's highest FP64 rate), memory TB/s.
PEAKS = {
    "H100 SXM": (67.0, 67.0, 3.35),
    "H100 PCIe": (51.2, 51.2, 2.0),
}


def log(*a):
    print(*a, flush=True)


def peaks_for(name: str):
    """The data-sheet peaks of the card torch names; raises for any other
    card ("NVIDIA H100 80GB HBM3" is the SXM part)."""
    if "H100" in name and "PCIe" in name:
        return "H100 PCIe", PEAKS["H100 PCIe"]
    if "H100" in name and ("SXM" in name or "HBM3" in name):
        return "H100 SXM", PEAKS["H100 SXM"]
    raise ValueError(f"no published peaks for {name!r}; add its row to PEAKS")


def cuda_ms(fn, reps=25, inner=10):
    """Median over `reps` samples of the mean device time of `inner`
    back-to-back calls, after a warm-up (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1) / inner)
    return statistics.median(samples)


def wall_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def counted(torch, cm, fn):
    """Run fn with the kernel launch counts set to 0 just before and read
    just after; returns (counts by dtype name, seconds, fn's result)."""
    torch.cuda.synchronize()
    cm.LAUNCHES.clear()
    secs, out = wall_s(fn)
    return dict(cm.LAUNCHES), secs, out


def phase_kernels(torch, cm, StructuredSolidOperator, peaks):
    """Phases 3 and 4: kernel == plain on the card, then times and bounds."""
    f32_peak, f64_peak, mem_tb = peaks
    rows = {}
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        tdt = getattr(torch, name)
        row = {}
        for n in (FLAGSHIP, ODD):
            op = StructuredSolidOperator.from_lattice(n, (H, H, H), E, NU, dtype=dt,
                                                      device=DEVICE)
            rng = np.random.default_rng(0)
            u = torch.as_tensor(rng.standard_normal(op.ndof).astype(dt), device=DEVICE)
            k = cm.structured_cell_matmul(u, op.Kcell, n)
            p = cm.structured_cell_matmul_plain(u, op.Kcell, n)
            torch.cuda.synchronize()
            err = (k - p).abs().max().item()
            scale = p.abs().max().item()
            log(f"   kernel vs plain {name} cells {n}: max|k-p| = {err:.3e}, "
                f"max|p| = {scale:.3e}, rel = {err / scale:.3e} (tol {TOL[name]:g})")
            check(np.isfinite(err) and err <= TOL[name] * scale,
                  f"kernel disagrees with plain ({name}, {n})")
            if n != FLAGSHIP:
                continue
            row.update(max_abs_err=err, rel_err=err / scale, tol=TOL[name])
            # timing at the flagship shape: the raw launch (no allocation,
            # no checks), the plain version, and the library matmul alone on
            # a pre-gathered ue
            fe = torch.empty_like(k)
            fn = cm._kernel_fn(tdt)
            stream = torch.cuda.current_stream().cuda_stream
            nx, ny, nz = n

            def launch():
                rc = fn(u.data_ptr(), op.Kcell.data_ptr(), fe.data_ptr(), nx, ny, nz, stream)
                check(rc == 0, f"launch failed: cudaError {rc}")

            ue = torch.stack([
                cm.split_phases(u, n)[(a % 2) * 4 + (b % 2) * 2 + (c % 2)]
                [:, a // 2:a // 2 + nx, b // 2:b // 2 + ny, c // 2:c // 2 + nz]
                for (a, b, c) in cm._SLOTS]).reshape(81, -1)
            cells = nx * ny * nz
            item = np.dtype(dt).itemsize
            nbytes = (u.numel() + 81 * 81 + 81 * cells) * item
            flops = 2.0 * 81 * 81 * cells
            t_mem = nbytes / (mem_tb * 1e12) * 1e3
            t_ops = flops / ((f32_peak if dt == np.float32 else f64_peak) * 1e12) * 1e3
            row.update(
                ms=cuda_ms(launch),
                plain_ms=cuda_ms(lambda: cm.structured_cell_matmul_plain(u, op.Kcell, n)),
                library_ms=cuda_ms(lambda: torch.matmul(op.Kcell, ue)),
                library_call="torch.matmul(Kcell, ue) on a pre-gathered ue (matmul only)",
                bound_ms=max(t_mem, t_ops),
                bound_by="operations" if t_ops >= t_mem else "bytes",
                bytes=nbytes, flops=flops)
            log(f"   timing {name} @ {n}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {flops / 1e9:.3f} "
                f"GFLOP, {nbytes / 1e6:.1f} MB)")
        rows[name] = row
    return rows


def reference_case(torch, femx_torch, cm):
    """Phase 5: README quick start on the card, golden assertions of
    tests/test_reference_goldens.py:164-182; returns the launch counts."""
    corners = [(0, 0), (0, 0.8), (0.8, 0), (0.8, 0.8)]
    mesh = femx_torch.box_tet10(0.8, 0.2, 0.8, 0.05, force_points=[(0.4, 0.2, 0.4)],
                                fix_points=[(x, 0, z) for x, z in corners])
    fa = femx_torch.SolidReactionAnalysis(
        mesh, [{"force_x": 0, "force_y": 3000.0, "force_z": 0, "force_x_pstn": 0.4,
                "force_y_pstn": 0.2, "force_z_pstn": 0.4}],
        [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
         for x, z in corners], E=E, v=NU, verbose=False, device=DEVICE)
    launches, t_run, _ = counted(torch, cm, fa.run_simulation)
    log(f"   run_simulation {t_run:.6f} s")
    log(f"   solve_info {fa.solve_info}")
    # f64 block-Jacobi PCG: K once for the initial residual, once per
    # iteration, once for the reactions
    want = {"float64": fa.solve_info["iterations"] + 2}
    log(f"   launch check: expect {want}, got {launches}")
    check(launches == want, "default case launch count mismatch")
    log(f"   stage_times {fa.stage_times}")
    R = np.array([fa.reaction_forces[3 * i["node_idx"]:3 * i["node_idx"] + 3]
                  for i in fa.fixed_nodes_info])
    log(f"   corner reactions {R.tolist()}")
    eq = fa.equilibrium_residual()
    check(fa.solve_info["converged"], "default case did not converge")
    check(np.abs(eq).max() <= 1e-6, f"equilibrium {eq}")
    check(abs(R[:, 1].mean() + 750.0) <= 750.0 * 1e-9, f"mean Ry {R[:, 1].mean()}")
    check(np.all(np.abs(R[:, 1] + 750.0) <= 0.08 * 750.0), "Ry off -750 by > 8%")
    check(abs(R[0, 1] - R[3, 1]) <= 1e-8 * abs(R[3, 1]), "Ry diagonal pair 0/3")
    check(abs(R[1, 1] - R[2, 1]) <= 1e-8 * abs(R[2, 1]), "Ry diagonal pair 1/2")
    check(np.all(np.abs(np.abs(R[:, [0, 2]]) - 376.0) <= 0.15 * 376.0), "|Rx|,|Rz| ~ 376")
    check(R[0, 0] < 0 and R[1, 0] < 0 and R[2, 0] > 0 and R[3, 0] > 0, "Rx signs")
    check(R[0, 2] < 0 and R[1, 2] > 0 and R[2, 2] < 0 and R[3, 2] > 0, "Rz signs")
    return launches


def flagship_case(torch, femx_torch, cm):
    """Phase 6: the main path at 1,390,179 DOF; returns the launch counts."""
    corners = [(x, y, 0.0) for x in (0.0, 0.4) for y in (0.0, 0.4)]
    t0 = time.perf_counter()
    mesh = femx_torch.box_tet10(0.4, 0.4, 1.6, mesh_size=H, force_points=[(0.2, 0.4, 1.6)],
                                fix_points=corners)
    t_mesh = time.perf_counter() - t0
    ndof = 3 * np.prod([2 * c + 1 for c in FLAGSHIP])  # 1,390,179 at 24x24x96
    check(mesh.structured.n_cells == FLAGSHIP and 3 * mesh.num_nodes == ndof,
          f"flagship mesh {mesh.structured.n_cells}, {3 * mesh.num_nodes} DOF")
    force = [{"force_x": 0.0, "force_y": -1000.0, "force_z": 0.0,
              "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 1.6}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    fa = femx_torch.SolidReactionAnalysis(mesh, force, fix, E=E, v=NU, dtype=np.float32,
                                          cg_tol=1e-8, solver="auto", verbose=False,
                                          device=DEVICE)
    launches, t_run, _ = counted(torch, cm, fa.run_simulation)
    info = fa.solve_info
    log(f"   mesh {t_mesh:.6f} s; first run_simulation {t_run:.6f} s")
    log(f"   solve_info {info}")
    log(f"   stage_times {fa.stage_times}")
    check(info["method"] == "structured_multigrid_pcg_mixed", info["method"])
    log(f"   levels {[lv.op.n_cells for lv in fa._precond.levels]}, omegas {fa._precond.omegas}")
    eq = fa.equilibrium_residual()
    fnorm = 1000.0
    log(f"   equilibrium residual {eq.tolist()} (|F| = {fnorm}); launches {launches}")
    check(info["converged"], "flagship did not converge")
    check(np.all(np.isfinite(fa.u)) and fa.u.shape == (ndof,), "bad u")
    check(np.linalg.norm(eq) <= 1e-6 * fnorm, f"equilibrium {eq}")
    # launch accounting: f64 CG applies K once up front, once per iteration
    # and once for the reactions; each f32 V-cycle (up front and per
    # iteration) runs 5 applies (2+2 sweeps + residual) on every level above
    # the coarsest
    it = info["iterations"]
    want = {"float64": it + 2, "float32": 5 * (len(fa._precond.levels) - 1) * (it + 1)}
    log(f"   launch check: {it} iterations -> expect {want}, got {launches}")
    check(launches == want, "launch count mismatch")

    # accurate solve time: the same entry point, warm, median of 3
    runs = []
    for _ in range(3):
        t, _ = wall_s(fa.run_simulation)
        runs.append({"run_simulation_s": t, "iterations": fa.solve_info["iterations"],
                     "precond_setup_s": fa.solve_info["precond_setup_s"],
                     "solve_s": fa.solve_info["solve_s"]})
        check(fa.solve_info["converged"] and np.linalg.norm(fa.equilibrium_residual())
              <= 1e-6 * fnorm, "warm flagship run did not hold")
    warm = {"run_simulation_s": statistics.median(r["run_simulation_s"] for r in runs),
            "solve_s": statistics.median(r["solve_s"] for r in runs), "runs": runs}
    log(f"   accurate solve, warm (median of 3): {json.dumps(warm)}")
    return launches, warm


def bench_flow(torch, femx_torch, cm):
    """Phase 7: bench.py:64-145 through the port's modules."""
    from femx_torch.solve.cg import pcg, pcg_refined
    from femx_torch.solve.multigrid import StructuredMultigrid

    nx, ny, nz = FLAGSHIP
    dims = (nx * H, ny * H, nz * H)
    mesh = femx_torch.box_tet10(*dims, mesh_size=H)
    ndof = 3 * mesh.num_nodes
    mask = np.ones(ndof)
    fixed = np.where(mesh.points[:, 2] < 1e-9)[0]
    mask[(3 * fixed[:, None] + np.arange(3)).ravel()] = 0
    f = np.zeros(ndof)
    tip = np.where(mesh.points[:, 2] > dims[2] - 1e-9)[0]
    f[3 * tip + 1] = -1000.0 / len(tip)

    t_setup, mg = wall_s(lambda: StructuredMultigrid(dims, FLAGSHIP, E, NU, mask,
                                                     dtype=np.float32, device=DEVICE))
    op = mg.fine_op
    f_int = op.to_internal(f * mask)
    fj = torch.as_tensor(f_int.astype(np.float32), device=DEVICE)
    f64j = torch.as_tensor(f_int, dtype=torch.float64, device=DEVICE)
    op64 = op.astype(np.float64)

    def solve():
        return pcg(op.apply_constrained, fj, M_inv_diag=mg, tol=1e-5, maxiter=200)

    def solve_refined():
        return pcg_refined(op.apply_constrained, fj, M_inv_diag=mg, tol=1e-5, maxiter=200,
                           refine_steps=6, A_residual=op64.apply_constrained,
                           b_residual=f64j, outer_tol=1e-8)

    # every pcg call applies the f32 K once up front and once per iteration,
    # and runs one V-cycle up front and one per iteration, each of 5 applies
    # on every level above the coarsest
    per_vcycle = 5 * (len(mg.levels) - 1)
    launches_f32, t_first, res = counted(torch, cm, solve)
    want = {"float32": (1 + per_vcycle) * (res.iterations + 1)}
    log(f"   launch check f32 solve: expect {want}, got {launches_f32}")
    check(launches_f32 == want, "bench f32 launch count mismatch")
    runs = [wall_s(solve) for _ in range(3)]
    res = runs[-1][1]
    t_f32 = statistics.median(t for t, _ in runs)
    # pcg_refined: 1 + passes pcg calls in f32, 1 + passes f64 residuals
    launches_ref, _, rr = counted(torch, cm, solve_refined)
    passes = launches_ref.get("float64", 0) - 1
    want = {"float32": (1 + per_vcycle) * (rr.iterations + passes + 1),
            "float64": passes + 1}
    log(f"   launch check refined solve: {passes} passes -> expect {want}, "
        f"got {launches_ref}")
    check(0 <= passes <= 6 and launches_ref == want, "bench refined launch count mismatch")
    runs_r = [wall_s(solve_refined) for _ in range(3)]
    rr = runs_r[-1][1]
    t_ref = statistics.median(t for t, _ in runs_r)
    out = {
        "launches_f32_solve": launches_f32, "launches_refined_solve": launches_ref,
        "ndof": ndof, "levels": [lv.op.n_cells for lv in mg.levels],
        "setup_s": t_setup, "first_solve_s": t_first, "f32_solve_s": t_f32,
        "f32_solve_runs_s": [t for t, _ in runs], "f32_iters": res.iterations,
        "f32_residual": res.residual_norm, "refined_solve_s": t_ref,
        "refined_solve_runs_s": [t for t, _ in runs_r],
        "refined_inner_iters": rr.iterations, "true_residual": rr.residual_norm,
    }
    log(f"   bench flow {json.dumps(out)}")
    check(abs(res.iterations - 13) <= 2, f"f32 iterations {res.iterations} not 13 +- 2")
    check(res.converged and rr.converged and rr.residual_norm <= 1e-8,
          f"refined residual {rr.residual_norm}")
    check(bool(torch.isfinite(rr.x).all()) and rr.x.shape == (ndof,), "bad refined x")

    # one traced f32 solve: device time by kernel name
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_prof, _ = wall_s(solve)
    events = prof.key_averages()
    # kernel events only (the aten ops above them carry the same time again)
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    log("   profile of one f32 MG-PCG solve (top kernels by device time):")
    log(events.table(sort_by="self_cuda_time_total", row_limit=14))
    out.update(profiled_solve_s=t_prof, profiled_device_ms=device_ms)
    log(f"   profiled solve: {t_prof * 1e3:.1f} ms wall, {device_ms:.1f} ms device time "
        f"-> device idle {100 * (1 - device_ms / (t_prof * 1e3)):.1f} % (unprofiled wall "
        f"{t_f32 * 1e3:.1f} ms -> idle {100 * (1 - device_ms / (t_f32 * 1e3)):.1f} %)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import femx_torch
    from femx_torch import build
    from femx_torch.assembly_structured import StructuredSolidOperator
    from femx_torch.elements import cell_matmul as cm

    t_start = time.perf_counter()
    log("1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"   nvidia-smi: {smi}")
    kind = torch.cuda.get_device_name(0)
    part, peaks = peaks_for(kind)
    log(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s); peaks taken as {part} {peaks}")

    log("2. build")
    t_build, _ = wall_s(build.build)
    log(f"   built {build.kernel_names()} in {t_build:.2f} s")
    for name, (secs, out) in build.BUILD_LOG.items():
        log(f"   nvcc {name}: {secs:.2f} s\n{out.strip()}")

    log("3-4. kernels against their plain versions; timing")
    rows = phase_kernels(torch, cm, StructuredSolidOperator, peaks)

    log("5. reference default case on the card")
    launches_default = reference_case(torch, femx_torch, cm)

    log("6. flagship main path through SolidReactionAnalysis")
    launches, warm = flagship_case(torch, femx_torch, cm)

    log("7. bench flow")
    bench = bench_flow(torch, femx_torch, cm)

    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": f"structured_cell_matmul_{'f32' if name == 'float32' else 'f64'}",
            "dtype": name, "route": "cuda",
            "source": "femx_torch/csrc/structured_cell_matmul.cu",
            "replaces": "femx/elements/pallas_structured.py:101",
            "launches": int(launches.get(name, 0)), **row,
            "launches_by_path": {
                "default_case": launches_default.get(name, 0), "flagship": launches.get(name, 0),
                "bench_f32_solve": bench["launches_f32_solve"].get(name, 0),
                "bench_refined_solve": bench["launches_refined_solve"].get(name, 0)},
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    log("end-to-end: " + json.dumps({
        "accurate_solve_run_simulation_s": warm["run_simulation_s"],
        "accurate_solve_solve_s": warm["solve_s"],
        "bench_f32_solve_s": bench["f32_solve_s"], "bench_f32_iters": bench["f32_iters"],
        "bench_refined_solve_s": bench["refined_solve_s"],
        "bench_refined_inner_iters": bench["refined_inner_iters"]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
