#!/usr/bin/env python3
"""On-card smoke test of femx_torch, the PyTorch/CUDA port of femx.

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):
  1. device   — nvidia-smi's name and power limit, torch's device name;
  2. build    — nvcc builds every kernel under femx_torch/csrc;
  3. kernels  — structured_cell_matmul against its plain PyTorch version on
                the card: float32 (FMA kernel) and float64 (the tensor-core
                and the FMA kernel), at the four lattices of the flagship
                V-cycle, (5, 3, 7), (1, 1, 1) and (7, 5, 33), with the
                operator's cell matrix and a non-symmetric random one; the
                float32 flagship operator held symmetric;
  4. timing   — kernel times (CUDA events, median) at the four lattices with
                registers and shared memory from ptxas, achieved TFLOP/s and
                GB/s, the SM clock under the kernel, and at the flagship the
                plain and library times beside the card's bound;
  5. default  — the reference default case (README quick start, 29,403 DOF,
                block-Jacobi, f64) through SolidReactionAnalysis on the card,
                held to the golden assertions;
  6. flagship — SolidReactionAnalysis on the 24x24x96 lattice (1,390,179
                DOF, dtype float32: f64 CG preconditioned by the f32
                V-cycle), then warm runs whose median is the accurate solve
                time;
  7. bench    — bench.py's flow (face-clamped cantilever, StructuredMultigrid
                + pcg to 1e-5, then pcg_refined to 1e-8) through
                femx_torch.bench's functions;
  8. unstructured flagship — the same box relabelled with
                default_rng(0).permutation, written with write_msh and solved
                by SolidReactionAnalysis(path, dtype=float32, cg_tol=1e-8):
                f64 CG on the transpose-gather operator (take_rows kernel)
                assembled in f64, preconditioned by the f32 lattice MG; its
                equilibrium held under a separately assembled f64 operator,
                its corner reactions to phase 6's;
  9. take_rows against its plain version (exact) at that operator's
                gathers, float32 and float64, then timed beside
                index_select, its bytes bound and its sector bound;
 10. unstructured bench — bench.py:223-308 through femx_torch.bench with
                the TG operator: f32 pcg with the lattice preconditioner to
                1e-5, 17 +- 2 iterations, profiled once;
 11. small mesh files — the README default box from a .msh file (TG +
                block-Jacobi, f64; reactions held to phase 5's) and a coarse
                box of <= 6,000 DOF (dense Cholesky);
 12. examples — the Pallas repro counterparts (row_copy, take_rows,
                take_along_axis at each repro's inputs, exact) and
                bench_dyngather's sweep; then take_along_axis checked and
                timed beside torch.gather at every H of the sweep (f32, and
                f64 at H=4096) with its plan's variant and bound share;
                row_copy at repro_dynslice_value's shape beside torch.mul in
                the event-timed loop, as device time from a CUDA-graph
                replay, and as the host's cost per call; row_copy at 134 MB
                moved beside torch.mul and its bytes bound;
 13. solid extras and modal — (a) bench.py:148-202: shift-invert Lanczos
                (10 modes) with f32 MG-PCG inner solves on phase 7's
                operator, first and steady, then shift_invert_refine through
                pcg_refined to a true residual of 1e-9, against BENCH_r05's
                parity numbers (22 +- 4 inner solves, f1-f3 within 1e-2,
                refined f1 within 1e-5, bounds); (b) modal(n_modes=6),
                compute_stresses and solve_cases (3 cases) on phase 6's
                analysis, the stresses run twice on the card and held to
                the CPU entry by entry within their rounding bound; (c)
                phase 5's case with
                checkpoint= (chunks of 100) cut at 300 iterations, then
                resumed by a second analysis; (d) modal(n_modes=3,
                refine=True) on phase 11's mesh-file default (take_rows f64)
                and phase 5's structured default (cell kernel f64), their
                frequencies within 1e-6; (a) runs through femx_torch.bench;
 14. group-ELL and cluster — (a) phase 10's flow with the group-ELL, then
                the cluster operator (17 +- 2 iterations; each operator's
                K @ u held to the TG apply to 1e-5; launches per apply equal
                to its take_rows calls per apply; assembly, setup, peak
                device memory); (b) phase 8's relabelled flagship file
                through SolidReactionAnalysis(dtype=float32,
                unstructured_operator=...) for both: method, equilibrium
                <= 1e-6 |F|, corner reactions within 1e-6 of phase 6's;
                (c) FEMX_GROUPELL_SYM=1 once: the symmetric storage's apply
                against the full storage (1e-5); (d) take_rows at the new
                shapes (group-ELL's largest u16[ii] bucket, width 48; its
                u6[pairperm], width 6; cluster's largest u3[nodes] class)
                against its plain version (exact), timed beside
                index_select with its bytes bound.
 15. beam and shaft — (a) the reference's portal frame through
                BeamAnalysis (section warping FEMs on the card; their
                Laplacian gathers are take_rows f64): consistent mass held to
                the golden statics (2e-5) and frequencies, lumped mass to the
                port's CPU run (1e-9); (b) a 10-storey, 4 x 4-bay steel
                building frame (5,550 DOF, FrameBuilder, three I-section
                warping FEMs, lateral and distributed loads), lumped and
                consistent: stage times, reaction equilibrium <= 1e-8 |F|,
                eigen-residuals of 20 modes under the dense eigensolve's
                backward-error scale; its 3-storey cut against the CPU
                (closed-form sections); (c) ShaftModalAnalysis on the test
                fixture and a stepped 400-element shaft on 3 bearings: whirl
                pairs within 1e3 eps lam_max / lam, Euler-Bernoulli, 60 f;
 16. plane and pipe — (a) the README's plane cantilever at 1024 x 256
                cells (2,102,274 DOF, six MG levels, f64 MG-PCG, take_rows f64
                in every apply): <= 25 iterations and within 3 of the CPU's at
                256 x 64, Timoshenko tip deflection (3 %), equilibrium <= 1e-8
                |F|, launches as counted, the solve profiled; (b) a 2,898-DOF
                cantilever through the dense route and modal(6); (c) the pipe
                at n_r=64, n_z=512 (264,450 DOF, axisymmetric MG-PCG) under
                pressure (Lame) and a temperature drop (radial ODE); (d)
                take_rows at (a)'s Tri6 gather, f32 and f64, exact, timed
                beside index_select with its bytes bound.
 17. host surface — (a) femx_torch.cli.main(["solid", "--box", ...]) on
                phase 6's lattice (1,390,179 DOF; the CLI's float64 MG-PCG,
                on the card by default) with --stress --report .docx --html:
                launches as counted, corner reactions within 1e-6 of the load
                of phase 6's, equilibrium, the .docx opened (reaction table,
                stress section); stage, stress, report and HTML times, HTML
                size; (b) .md and .docx reports of the analyses phases 5,
                15(b), 15(c) and 16 solved, no new solve; (c) `python -m
                femx_torch` subprocesses: mesh-box then solid --msh (TG:
                take_rows launched, reactions held to phase 5's to the printed
                digits), and shaft, plane (MG route), pipe and section (warping
                FEM) with --json, started together; (d) every product's plot
                when matplotlib is installed ("matplotlib: absent" otherwise).
 18. conv apply — (a) at 24x24x96, float32 and float64: the conv-form
                apply (femx_torch.assembly_conv, cuDNN with TF32 off) against
                the slot apply with the cell kernel (max difference over max
                value), CUDA-event ms of both in turns, device kernels per
                apply, the 24-channel correlation alone beside its bound; (b)
                phase 6's analysis with structured_apply="conv": iterations
                within 1 of phase 6's, corner reactions within 1e-7, launches
                as counted (the coarse levels only), warm solve beside phase
                6's.
 19. distributed — femx_torch.parallel with N ranks (processes) sharing
                the card, gloo on CUDA tensors: (a) every collective against
                numpy on 4 and 2 ranks, and whether gloo takes
                reduce_scatter_tensor; (b) the halo apply of 24x24x96 on 4
                ranks against the single-device apply, float32 and float64,
                the cell kernel launched on every rank; (c) phase 6's
                flagship with devices=4 (1,390,179 DOF): solve_info
                ["devices"] 4, iterations within 2 of phase 6's, phase 6's
                launch counts on every rank, corner reactions within 1e-6 of
                phase 6's, equilibrium, wall and collectives per iteration;
                (d) the same with devices=5 (nz 96 ghost-padded to 100); (e)
                phase 8's file with devices=4 (sharded TG + distributed
                lattice MG: take_rows and the cell kernel on every rank),
                reactions held to phase 6's; (f) devices=2 on the 8x8x32 box:
                u, solve_cases and modal(3, refine=True) against the
                single-device run; (g) `python -m femx_torch solid --devices
                2` on that box, its printed reactions against (f)'s run.
 20. V-cycle graph — at phase 6's hierarchy (24x24x96) and the benchmark's
                box1m-struct one (64x16x64, 1,647,459 DOF): five calls of
                StructuredMultigrid (eager, captured, replayed) against the
                eager V-cycle bit for bit; the pool its graph reserves against
                what an eager V-cycle of the same work reserves on a stream
                of its own; eager and replayed ms a call; slot_copy_in and
                slot_copy_out against Tensor.copy_ at both sizes, float32 and
                float64, aligned and one element off, exactly, and timed at
                box1m's (with slot_set) beside the library and the bytes bound.
13(b)'s stress check holds every entry's card-against-CPU difference to
STRESS_ROUNDING_STEPS eps times the sum of its terms' magnitudes (the two
runs sum in other orders; the card alone is checked run to run).
Phases 5-8, 10-19 each set the kernel launch counts to 0 just before
each path's first run, read them just after and check them against the
count its iteration counts imply; the counts are host launches, so a
StructuredMultigrid's V-cycle counts its eager first call and its capture
as a CUDA graph, and each replay one slot_set (`vcycle_launches`). The run
sets FEMX_MG_CACHE=0: the multigrid disk cache is off, so every
hierarchy setup it times is a full setup. The .msh file of phase 8 (read again
in 14(b)) is written under build/chip_smoke/ and deleted at the end, as
is phase 17's directory there.
The last two lines are a {"kernels": [...]} JSON object and the
{"ok": true, "device": {...}} JSON object. Without CUDA it exits nonzero and
prints no result.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
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


CORNERS_FLAGSHIP = [(x, y, 0.0) for x in (0.0, 0.4) for y in (0.0, 0.4)]
CORNERS_DEFAULT = [(0, 0), (0, 0.8), (0.8, 0), (0.8, 0.8)]


def corner_reactions(fa):
    return np.array([fa.reaction_forces[3 * i["node_idx"]:3 * i["node_idx"] + 3]
                     for i in fa.fixed_nodes_info])


def rel_diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


# the kernel wrapper modules, set by main() once the package is importable
CM = GATHER = None


def launch_counts():
    """Every kernel's launch count, keyed "<kernel>/<dtype>"."""
    out = {f"structured_cell_matmul/{k}": v for k, v in CM.LAUNCHES.items() if v}
    out.update((k, v) for k, v in GATHER.LAUNCHES.items() if v)
    return out


def counted(torch, fn):
    """Run fn with every kernel launch count set to 0 just before and read
    just after; returns (counts by "<kernel>/<dtype>", seconds, fn's
    result)."""
    torch.cuda.synchronize()
    CM.LAUNCHES.clear()
    GATHER.LAUNCHES.clear()
    secs, out = wall_s(fn)
    return launch_counts(), secs, out


SCM = "structured_cell_matmul"


def vcycle_state(mg) -> int:
    """Where StructuredMultigrid `mg` stands on its CUDA-graph route: 0
    before its first call on the card, 1 after it, 2 once its V-cycle is
    captured."""
    g = mg._route.graph
    return 0 if g is None else 2 if g.captured else 1


def vcycle_launches(per_vcycle, calls, state=0, dtype="float32"):
    """Host launches of `calls` calls of a StructuredMultigrid in `state`
    (vcycle_state) whose V-cycle launches `per_vcycle` cell kernels: its
    first call runs eagerly; its second captures the V-cycle (the capture's
    launches counted once, with one slot_copy_in and one slot_copy_out) and
    replays it; every call from the second on replays it, one slot_set each,
    and a replay launches nothing else from the host."""
    eager = min(calls, 1) if state == 0 else 0
    capture = int(state < 2 and calls > eager)
    return {f"{SCM}/{dtype}": per_vcycle * (eager + capture), "slot_set": calls - eager,
            f"slot_copy_in/{dtype}": capture, f"slot_copy_out/{dtype}": capture}


def add_launches(*counts) -> dict:
    """The sum of launch-count dicts, zero counts left out (launch_counts
    leaves them out)."""
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return {k: v for k, v in out.items() if v}


HIERARCHY = [FLAGSHIP, (12, 12, 48), (6, 6, 24), (3, 3, 12)]  # the flagship V-cycle's levels
SHAPES = HIERARCHY + [ODD, (1, 1, 1), (7, 5, 33)]  # the last: no multiple of any tile


def sm_clock_under(fn, calls=8000):
    """nvidia-smi's SM clock (a string such as "1980 MHz"), read while fn is
    launched `calls` times back to back."""
    import torch

    for _ in range(calls // 4):
        fn()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           stdout=subprocess.PIPE, text=True)
    for _ in range(calls - calls // 4):
        fn()
    torch.cuda.synchronize()
    return smi.communicate(timeout=60)[0].strip()


def phase_kernels(torch, cm, build, StructuredSolidOperator, peaks):
    """Phases 3 and 4: every planned variant of the kernel == plain on the
    card at seven lattices (with the operator's cell matrix and with a
    non-symmetric random one) and the f32 operator symmetric; then times,
    bounds and ptxas' resources at the four lattices of the V-cycle."""
    f32_peak, f64_peak, mem_tb = peaks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resources = build.kernel_resources(SCM)
    rows = {}
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        tdt = getattr(torch, name)
        families = [f for (f, d) in cm.PLANNED if d == tdt]
        default = cm.DEFAULT_FAMILY[tdt]
        rng = np.random.default_rng(0)
        k_random = torch.as_tensor(rng.standard_normal((81, 81)).astype(dt), device=DEVICE)
        row = {"levels": {}}
        for n in SHAPES:
            op = StructuredSolidOperator.from_lattice(n, (H, H, H), E, NU, dtype=dt,
                                                      device=DEVICE)
            u = torch.as_tensor(rng.standard_normal(op.ndof).astype(dt), device=DEVICE)
            nx, ny, nz = n
            cells = nx * ny * nz
            for label, kc in (("operator Kcell", op.Kcell), ("non-symmetric Kcell", k_random)):
                p = cm.structured_cell_matmul_plain(u, kc, n)
                scale = p.abs().max().item()
                got = {"wrapper": cm.structured_cell_matmul(u, kc, n)}
                for fam in families:
                    fe = torch.full_like(p, float("nan"))
                    rc = cm._launcher(u, kc, fe, n, cm.plan_launch(cells, tdt, sms, fam))()
                    check(rc == 0, f"launch failed: cudaError {rc} ({name}, {fam}, {n})")
                    got[fam] = fe
                torch.cuda.synchronize()
                for fam, k in got.items():
                    err = (k - p).abs().max().item()
                    log(f"   kernel vs plain {name} {fam:7s} cells {n} {label}: max|k-p| = "
                        f"{err:.3e}, rel = {err / scale:.3e} (tol {TOL[name]:g})")
                    check(np.isfinite(err) and err <= TOL[name] * scale,
                          f"kernel disagrees with plain ({name}, {fam}, {n}, {label})")
                    if n == FLAGSHIP and fam == "wrapper" and kc is op.Kcell:
                        row["max_abs_err"], row["rel_err"] = err, err / scale
            if n == FLAGSHIP and dt == np.float32:
                # K must stay symmetric in f32 (what TF32 products would break)
                v = torch.as_tensor(rng.standard_normal(op.ndof).astype(dt), device=DEVICE)
                Ku, Kv = op.apply(u), op.apply(v)
                asym = abs((v.double() @ Ku.double() - u.double() @ Kv.double()).item())
                limit = 1e-5 * (u.double().norm() * Kv.double().norm()).item()
                log(f"   symmetry f32 @ {n}: |v.Ku - u.Kv| = {asym:.3e} (limit {limit:.3e})")
                check(asym <= limit, "the f32 operator is not symmetric")
            if n not in HIERARCHY:
                continue
            # timing: the raw launch (no allocation, no checks) of each family
            # at each level; at the flagship also the plain version and the
            # library matmul alone on a pre-gathered ue
            fe = torch.empty((81, cells), dtype=tdt, device=DEVICE)
            item = np.dtype(dt).itemsize
            nbytes = (u.numel() + 81 * 81 + 81 * cells) * item
            flops = 2.0 * 81 * 81 * cells
            t_mem = nbytes / (mem_tb * 1e12) * 1e3
            t_ops = flops / ((f32_peak if dt == np.float32 else f64_peak) * 1e12) * 1e3
            lv = dict(cells=cells, bytes=nbytes, flops=flops, bound_ms=max(t_mem, t_ops),
                      bound_by="operations" if t_ops >= t_mem else "bytes", variants={})
            for fam in families:
                plan = cm.plan_launch(cells, tdt, sms, fam)
                launch = cm._launcher(u, op.Kcell, fe, n, plan)

                def run(launch=launch):
                    check(launch() == 0, "launch failed")

                ms = cuda_ms(run)
                # ptxas' figures exist only if this process built the library
                res = next((r for e, r in resources.items()
                            if plan.variant.entry_tag(tdt) in e), {})
                check(not res.get("spill_bytes"), f"{plan.variant.label()} spills: {res}")
                lv["variants"][fam] = dict(
                    variant=plan.variant.label(), ms=ms, grid=plan.grid,
                    smem_per_block=plan.smem, registers=res.get("registers"),
                    tflops=flops / ms / 1e9, gb_s=nbytes / ms / 1e6)
                log(f"   timing {name} {fam:5s} @ {n}: {ms:.5f} ms ({plan.variant.label()}, grid "
                    f"{plan.grid}, {res.get('registers')} registers/thread, {plan.smem} B "
                    f"shared/block) -> {flops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.0f} "
                    f"GB/s; bound {lv['bound_ms']:.5f} ms ({lv['bound_by']})")
                if n == FLAGSHIP and fam == default:
                    row["sm_clock"] = sm_clock_under(run)
            row["levels"][str(n)] = lv
            if n != FLAGSHIP:
                continue
            ue = torch.stack([
                cm.split_phases(u, n)[(a % 2) * 4 + (b % 2) * 2 + (c % 2)]
                [:, a // 2:a // 2 + nx, b // 2:b // 2 + ny, c // 2:c // 2 + nz]
                for (a, b, c) in cm._SLOTS]).reshape(81, -1)
            row.update(
                tol=TOL[name], ms=lv["variants"][default]["ms"],
                plain_ms=cuda_ms(lambda: cm.structured_cell_matmul_plain(u, op.Kcell, n)),
                library_ms=cuda_ms(lambda: torch.matmul(op.Kcell, ue)),
                library_call="torch.matmul(Kcell, ue) on a pre-gathered ue (matmul only)",
                bound_ms=lv["bound_ms"], bound_by=lv["bound_by"], bytes=nbytes, flops=flops,
                default_family=default)
            log(f"   timing {name} @ {n}: kernel {row['ms']:.4f} ms ({default}), plain "
                f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB); SM clock under the kernel: {row['sm_clock']}")
        rows[name] = row
    return rows


def default_analysis(femx_torch, **kw):
    """The README quick start's analysis (29,403 DOF, f64, block-Jacobi)."""
    corners = CORNERS_DEFAULT
    mesh = femx_torch.box_tet10(0.8, 0.2, 0.8, 0.05, force_points=[(0.4, 0.2, 0.4)],
                                fix_points=[(x, 0, z) for x, z in corners])
    return femx_torch.SolidReactionAnalysis(
        mesh, [{"force_x": 0, "force_y": 3000.0, "force_z": 0, "force_x_pstn": 0.4,
                "force_y_pstn": 0.2, "force_z_pstn": 0.4}],
        [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
         for x, z in corners], E=E, v=NU, verbose=False, device=DEVICE, **kw)


def reference_case(torch, femx_torch):
    """Phase 5: README quick start on the card, golden assertions of
    tests/test_reference_goldens.py:164-182; returns the launch counts, the
    corner reactions and the analysis."""
    fa = default_analysis(femx_torch)
    launches, t_run, _ = counted(torch, fa.run_simulation)
    log(f"   run_simulation {t_run:.6f} s")
    log(f"   solve_info {fa.solve_info}")
    # f64 block-Jacobi PCG: K once for the initial residual, once per
    # iteration, once for the reactions
    want = {f"{SCM}/float64": fa.solve_info["iterations"] + 2}
    log(f"   launch check: expect {want}, got {launches}")
    check(launches == want, "default case launch count mismatch")
    log(f"   stage_times {fa.stage_times}")
    R = corner_reactions(fa)
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
    return launches, R, fa


def flagship_case(torch, femx_torch, warm_runs=3):
    """Phase 6: the structured path at 1,390,179 DOF; returns the launch
    counts, the warm timings, the corner reactions and the analysis."""
    corners = CORNERS_FLAGSHIP
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
    torch.cuda.reset_peak_memory_stats()
    launches, t_run, _ = counted(torch, fa.run_simulation)
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
    # and once for the reactions; the f32 V-cycle (up front and per
    # iteration, a new hierarchy) runs 5 applies (2+2 sweeps + residual) on
    # every level above the coarsest
    it = info["iterations"]
    want = add_launches({f"{SCM}/float64": it + 2},
                        vcycle_launches(5 * (len(fa._precond.levels) - 1), it + 1))
    log(f"   launch check: {it} iterations -> expect {want}, got {launches}")
    check(launches == want, "launch count mismatch")

    R = corner_reactions(fa)
    log(f"   corner reactions {R.tolist()}")
    # accurate solve time: the same entry point, warm, median of warm_runs
    runs = []
    for _ in range(warm_runs):
        t, _ = wall_s(fa.run_simulation)
        runs.append({"run_simulation_s": t, "iterations": fa.solve_info["iterations"],
                     "precond_setup_s": fa.solve_info["precond_setup_s"],
                     "solve_s": fa.solve_info["solve_s"]})
        check(fa.solve_info["converged"] and np.linalg.norm(fa.equilibrium_residual())
              <= 1e-6 * fnorm, "warm flagship run did not hold")
    warm = {"run_simulation_s": statistics.median(r["run_simulation_s"] for r in runs),
            "solve_s": statistics.median(r["solve_s"] for r in runs), "runs": runs}
    warm["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    log(f"   accurate solve, warm (median of {warm_runs}): {json.dumps(warm)}")
    log(f"   peak device memory of the structured flagship: "
        f"{warm['peak_device_bytes'] / 2 ** 20:.1f} MiB")
    return launches, warm, R, fa


def bench_flow(torch, bench):
    """Phase 7: bench.py:64-145 through femx_torch.bench's functions; returns
    what the end-to-end line reports and the flow's state (phase 13 reuses
    its operators and V-cycle, phases 10 and 14 its problem)."""
    problem = bench.flagship_problem(FLAGSHIP)
    t_setup, sb = wall_s(lambda: bench.setup_structured(problem, np.float32, DEVICE))
    mg = sb.mg

    def solve():
        return bench.f32_solve(sb)

    def solve_refined():
        return bench.refined_solve(sb)

    # every pcg call applies the f32 K once up front and once per iteration,
    # and runs one V-cycle up front and one per iteration, each of 5 applies
    # on every level above the coarsest
    per_vcycle = 5 * (len(mg.levels) - 1)
    state = vcycle_state(mg)
    launches_f32, t_first, res = counted(torch, solve)
    want = add_launches({f"{SCM}/float32": res.iterations + 1},
                        vcycle_launches(per_vcycle, res.iterations + 1, state))
    log(f"   launch check f32 solve: expect {want}, got {launches_f32}")
    check(launches_f32 == want, "bench f32 launch count mismatch")
    runs = [wall_s(solve) for _ in range(3)]
    res = runs[-1][1]
    t_f32 = statistics.median(t for t, _ in runs)
    # pcg_refined: 1 + passes pcg calls in f32, 1 + passes f64 residuals
    state = vcycle_state(mg)
    launches_ref, _, rr = counted(torch, solve_refined)
    passes = launches_ref.get(f"{SCM}/float64", 0) - 1
    calls = rr.iterations + passes + 1
    want = add_launches({f"{SCM}/float32": calls, f"{SCM}/float64": passes + 1},
                        vcycle_launches(per_vcycle, calls, state))
    log(f"   launch check refined solve: {passes} passes -> expect {want}, "
        f"got {launches_ref}")
    check(0 <= passes <= 6 and launches_ref == want, "bench refined launch count mismatch")
    runs_r = [wall_s(solve_refined) for _ in range(3)]
    rr = runs_r[-1][1]
    t_ref = statistics.median(t for t, _ in runs_r)
    out = {
        "launches_f32_solve": launches_f32, "launches_refined_solve": launches_ref,
        "ndof": problem.ndof, "levels": [lv.op.n_cells for lv in mg.levels],
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
    check(bool(torch.isfinite(rr.x).all()) and rr.x.shape == (problem.ndof,), "bad refined x")

    # one traced f32 solve: device time by kernel name
    t_prof, device_ms, events = bench.profiled(solve, torch.device(DEVICE))
    log("   profile of one f32 MG-PCG solve (top kernels by device time):")
    log(events.table(sort_by="self_cuda_time_total", row_limit=14))
    out.update(profiled_solve_s=t_prof, profiled_device_ms=device_ms)
    log(f"   profiled solve: {t_prof * 1e3:.1f} ms wall, {device_ms:.1f} ms device time "
        f"-> device idle {100 * (1 - device_ms / (t_prof * 1e3)):.1f} % (unprofiled wall "
        f"{t_f32 * 1e3:.1f} ms -> idle {100 * (1 - device_ms / (t_f32 * 1e3)):.1f} %)")
    return out, sb


def unstructured_flagship(torch, femx_torch, R_struct, warm_runs=1):
    """Phase 8: the flagship box, relabelled and read back from a .msh file,
    through the transpose-gather + lattice-MG route; returns the launch
    counts, the analysis, what the end-to-end line reports and the file's
    path (phase 14(b) reads it again; main deletes it)."""
    from femx_torch.assembly_tg import SolidOperatorTG
    from femx_torch.mesh import relabel_nodes, write_msh

    t_mesh, mesh = wall_s(lambda: femx_torch.box_tet10(
        0.4, 0.4, 1.6, mesh_size=H, force_points=[(0.2, 0.4, 1.6)],
        fix_points=CORNERS_FLAGSHIP))
    mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, "flagship_relabelled.msh")
    t_write, _ = wall_s(lambda: write_msh(path, mesh))
    torch.cuda.reset_peak_memory_stats()
    log(f"   mesh {t_mesh:.6f} s; write_msh {t_write:.6f} s "
        f"({os.path.getsize(path) / 1e6:.1f} MB, {mesh.num_nodes} nodes)")
    force = [{"force_x": 0.0, "force_y": -1000.0, "force_z": 0.0,
              "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 1.6}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in CORNERS_FLAGSHIP]
    t_ctor, fa = wall_s(lambda: femx_torch.SolidReactionAnalysis(
        path, force, fix, E=E, v=NU, dtype=np.float32, cg_tol=1e-8, verbose=False,
        device=DEVICE))
    ndof = 3 * np.prod([2 * c + 1 for c in FLAGSHIP])  # 1,390,179 at 24x24x96
    check(fa.mesh.structured is None and 3 * fa.num_nodes == ndof,
          f"unstructured flagship has {3 * fa.num_nodes} DOF")
    launches, t_run, _ = counted(torch, fa.run_simulation)
    info = fa.solve_info
    log(f"   constructor (reads the file) {t_ctor:.6f} s; first run_simulation {t_run:.6f} s")
    log(f"   solve_info {info}")
    log(f"   stage_times {fa.stage_times}")
    check(info["method"] == "tg_lattice_mg_pcg_mixed", info["method"])
    check(info["converged"] and info["residual"] <= 1e-8, "unstructured flagship did not converge")
    check(np.all(np.isfinite(fa.u)) and fa.u.shape == (ndof,), "bad u")
    lp = fa._precond
    per = lp.launches_per_call()
    it = info["iterations"]
    g = fa.operator.gathers_per_apply
    # f64 CG (pcg_mixed): the f64 TG operator applied once up front, once per
    # iteration and once for the reactions; the f32 lattice preconditioner
    # (its transfer gathers, 2 V-cycles of a new hierarchy and 1 lattice
    # apply) called once up front and once per iteration
    want = add_launches({"take_rows/float64": (it + 2) * g,
                         "take_rows/float32": (it + 1) * per["take_rows"]},
                        lattice_launches(lp, it + 1))
    log(f"   lattice {lp.n_cells} cells, levels {[lv.op.n_cells for lv in lp.mg.levels]}, "
        f"transfer {type(lp.transfer).__name__}; per apply {g} take_rows, per "
        f"preconditioner call {per}")
    log(f"   launch check: {it} iterations -> expect {want}, got {launches}")
    check(launches == want, "unstructured flagship launch count mismatch")
    eq = fa.equilibrium_residual()
    check(np.linalg.norm(eq) <= 1e-6 * 1000.0, f"equilibrium {eq}")
    # the same equilibrium under an f64 operator assembled here from the mesh
    op64, _ = SolidOperatorTG.from_mesh(fa.points, fa.tetra10_conn, E, NU, dtype=np.float64,
                                        device=DEVICE)
    r64 = op64.to_global(op64.apply(torch.as_tensor(op64.to_internal(fa.u),
                                                    device=DEVICE)).cpu().numpy())
    del op64
    eq64 = np.array([0.0, -1000.0, 0.0]) + sum(r64[3 * i["node_idx"]:3 * i["node_idx"] + 3]
                                                for i in fa.fixed_nodes_info)
    check(np.linalg.norm(eq64) <= 1e-6 * 1000.0, f"equilibrium under the mesh's f64 K {eq64}")
    R = corner_reactions(fa)
    rel = rel_diff(R, R_struct)
    log(f"   corner reactions {R.tolist()}; max|R - R_structured| / max|R_structured| "
        f"= {rel:.3e}; equilibrium residual {eq.tolist()}, under the mesh's f64 K "
        f"{eq64.tolist()}")
    check(rel <= 1e-6, "corner reactions differ from the structured route's")
    runs = []
    for _ in range(warm_runs):
        t, _ = wall_s(fa.run_simulation)
        runs.append({"run_simulation_s": t, "iterations": fa.solve_info["iterations"],
                     "precond_setup_s": fa.solve_info["precond_setup_s"],
                     "solve_s": fa.solve_info["solve_s"], "stage_times": dict(fa.stage_times)})
        check(fa.solve_info["converged"] and np.linalg.norm(fa.equilibrium_residual())
              <= 1e-6 * 1000.0, "warm unstructured run did not hold")
    warm = {"run_simulation_s": statistics.median(r["run_simulation_s"] for r in runs),
            "solve_s": statistics.median(r["solve_s"] for r in runs), "runs": runs,
            "iterations": it, "read_mesh_s": fa.stage_times["read_mesh"],
            "write_msh_s": t_write, "corner_rel_diff": rel}
    warm["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    log(f"   unstructured accurate solve, warm (median of {warm_runs}): {json.dumps(warm)}")
    log(f"   peak device memory of the unstructured flagship: "
        f"{warm['peak_device_bytes'] / 2 ** 20:.1f} MiB")
    return launches, fa, warm, path


def tg_kernel_rows(torch, fa, mem_tb):
    """Phase 9: take_rows == its plain version at every gather of the
    unstructured flagship's apply (u3[connT] and each degree bucket), float32
    and float64; timed at u3[connT] against index_select and the bound."""
    op = fa.operator
    rows = {}
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        rng = np.random.default_rng(0)
        u3 = torch.as_tensor(rng.standard_normal((op.n_nodes, 3)).astype(dt), device=DEVICE)
        fe3 = torch.as_tensor(rng.standard_normal((10 * op.n_elements, 3)).astype(dt),
                              device=DEVICE)
        pairs = [(u3, op.connT)] + [(fe3, b) for b, d in
                                    zip(op.bucket_idx, op.bucket_degrees) if d]
        err = 0.0
        for tab, idx in pairs:
            k = GATHER.take_rows(tab, idx)
            p = GATHER.take_rows_plain(tab, idx)
            torch.cuda.synchronize()
            err = max(err, (k - p).abs().max().item())
        log(f"   take_rows {name}: {len(pairs)} gathers of one apply, max|k-p| = {err}")
        check(err == 0.0, f"take_rows disagrees with plain ({name})")
        idx = op.connT
        idx64 = idx.long()
        flat64 = idx64.reshape(-1)
        out = torch.empty((*idx.shape, 3), dtype=u3.dtype, device=DEVICE)
        fn = GATHER._kernel_fn("take_rows", u3.dtype)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(by_rows=0):
            rc = fn(u3.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), 3, by_rows,
                    stream)
            check(rc == 0, f"launch failed: cudaError {rc}")

        # the row-per-thread kernel (built for timing) must be exact too
        out.fill_(float("nan"))
        launch(1)
        torch.cuda.synchronize()
        check(torch.equal(out, u3[idx64]), f"take_rows by rows disagrees with plain ({name})")

        def apply_gathers():
            for tab, ix in pairs:
                GATHER.take_rows(tab, ix)

        item = np.dtype(dt).itemsize
        nbytes = u3.numel() * item + idx.numel() * 4 + out.numel() * item
        # scattered rows cost a 32-byte sector each, whatever the row holds
        sector_bytes = idx.numel() * (4 + 32) + out.numel() * item
        row = dict(max_abs_err=err, ms=cuda_ms(launch), by_rows_ms=cuda_ms(lambda: launch(1)),
                   plain_ms=cuda_ms(lambda: u3[idx64]),
                   library_ms=cuda_ms(lambda: torch.index_select(u3, 0, flat64)),
                   library_call="torch.index_select(u3, 0, connT)",
                   bound_ms=nbytes / (mem_tb * 1e12) * 1e3, bound_by="bytes", bytes=nbytes,
                   sector_bound_ms=sector_bytes / (mem_tb * 1e12) * 1e3,
                   sector_bytes=sector_bytes,
                   shape=f"u3 {tuple(u3.shape)}[connT {tuple(idx.shape)}]",
                   apply_gathers_ms=cuda_ms(apply_gathers), gathers_per_apply=len(pairs))
        log(f"   timing take_rows {name} u3[connT]: kernel {row['ms']:.5f} ms (row-per-thread "
            f"kernel {row['by_rows_ms']:.5f} ms), plain {row['plain_ms']:.5f} ms, index_select "
            f"{row['library_ms']:.5f} ms; bytes bound {row['bound_ms']:.5f} ms "
            f"({nbytes / 1e6:.1f} MB, share {100 * row['bound_ms'] / row['ms']:.0f} %), sector "
            f"bound {row['sector_bound_ms']:.5f} ms ({sector_bytes / 1e6:.1f} MB, share "
            f"{100 * row['sector_bound_ms'] / row['ms']:.0f} %); all {len(pairs)} gathers of "
            f"one apply {row['apply_gathers_ms']:.5f} ms")
        rows[name] = row
    return rows


def lattice_launches(lp, calls, state=0) -> dict:
    """The cell kernel's host launches of `calls` calls of lattice
    preconditioner `lp` whose hierarchy was in `state` (vcycle_state): its
    n_cycles V-cycles a call, and the lattice applies between them."""
    vc = 5 * (len(lp.mg.levels) - 1)
    applies = lp.launches_per_call()[SCM] - lp.n_cycles * vc
    return add_launches({f"{SCM}/float32": calls * applies},
                        vcycle_launches(vc, lp.n_cycles * calls, state))


def unstructured_bench(torch, bench, problem, kind, runs_n=3):
    """Phases 10 and 14(a): bench.py:223-308 through femx_torch.bench with the
    operator `kind` ("tg", "groupell" or "cluster") — face-clamped,
    relabelled, f32 operator + LatticePreconditioner, f32 pcg to 1e-5, 17 +-
    2 iterations (BENCH_r05's 17, the same K and preconditioner for every
    operator), profiled once; returns what the end-to-end line reports and
    the flow's state."""
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    ub = bench.setup_unstructured(problem, kind, np.float32, DEVICE)
    torch.cuda.synchronize()

    def solve():
        return bench.unstructured_solve(ub)

    state = vcycle_state(ub.lp.mg)
    launches, t_first, res = counted(torch, solve)
    per = ub.lp.launches_per_call()
    it = res.iterations
    want = add_launches(
        {"take_rows/float32": (it + 1) * (ub.op.gathers_per_apply + per["take_rows"])},
        lattice_launches(ub.lp, it + 1, state))
    log(f"   {kind}: {ub.op.gathers_per_apply} take_rows per apply, per preconditioner call "
        f"{per}; launch check: {it} iterations -> expect {want}, got {launches}")
    check(launches == want, f"unstructured bench ({kind}) launch count mismatch")
    runs = [wall_s(solve) for _ in range(runs_n)]
    res = runs[-1][1]
    t_solve = statistics.median(t for t, _ in runs)
    out = {"op": kind, "ndof": problem.ndof, "assemble_s": ub.assembly_s,
           "setup_s": ub.setup_s, "first_solve_s": t_first, "f32_solve_s": t_solve,
           "f32_solve_runs_s": [t for t, _ in runs], "iters": res.iterations,
           "residual": res.residual_norm, "lattice_cells": ub.lp.n_cells, "launches": launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated() - base}
    log(f"   unstructured bench {json.dumps(out)}")
    check(res.converged and abs(res.iterations - 17) <= 2,
          f"unstructured f32 iterations ({kind}) {res.iterations} not 17 +- 2")

    from torch.autograd import DeviceType

    t_prof, device_ms, events = bench.profiled(solve, torch.device(DEVICE))
    n_kernels = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    log(f"   profile of one f32 {kind} + lattice-MG PCG solve (top kernels by device time):")
    log(events.table(sort_by="self_cuda_time_total", row_limit=16))
    out.update(profiled_solve_s=t_prof, profiled_device_ms=device_ms,
               device_kernels=n_kernels, device_kernels_per_iteration=n_kernels / (it + 1),
               idle_share=1 - device_ms / (t_solve * 1e3))
    log(f"   profiled solve: {t_prof * 1e3:.1f} ms wall, {device_ms:.1f} ms device time, "
        f"{n_kernels} device kernels ({n_kernels / (it + 1):.0f} per iteration) -> device "
        f"idle {100 * (1 - device_ms / (t_prof * 1e3)):.1f} % (unprofiled wall "
        f"{t_solve * 1e3:.1f} ms -> idle {100 * out['idle_share']:.1f} %); peak device "
        f"memory {out['peak_device_bytes'] / 2 ** 20:.1f} MiB")
    return out, ub


def small_mesh_files(torch, femx_torch, R_default):
    """Phase 11: the README default box from a .msh file (TG + block-Jacobi,
    f64, reactions held to phase 5's) and a coarse box through the dense
    Cholesky route."""
    from femx_torch.mesh import write_msh

    os.makedirs(WORK_DIR, exist_ok=True)
    force = [{"force_x": 0, "force_y": 3000.0, "force_z": 0, "force_x_pstn": 0.4,
              "force_y_pstn": 0.2, "force_z_pstn": 0.4}]
    fix = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, z in CORNERS_DEFAULT]
    out = {}
    for label, h in (("mesh_file_default", 0.05), ("mesh_file_dense", 0.1)):
        mesh = femx_torch.box_tet10(0.8, 0.2, 0.8, h, force_points=[(0.4, 0.2, 0.4)],
                                    fix_points=[(x, 0, z) for x, z in CORNERS_DEFAULT])
        path = os.path.join(WORK_DIR, f"{label}.msh")
        write_msh(path, mesh)
        fa = femx_torch.SolidReactionAnalysis(path, force, fix, E=E, v=NU, verbose=False,
                                              device=DEVICE)
        os.remove(path)
        launches, t_run, _ = counted(torch, fa.run_simulation)
        info = fa.solve_info
        eq = fa.equilibrium_residual()
        R = corner_reactions(fa)
        log(f"   {label}: {3 * fa.num_nodes} DOF, run_simulation {t_run:.6f} s, solve_info "
            f"{info}, launches {launches}, equilibrium {eq.tolist()}")
        check(np.linalg.norm(eq) <= 1e-6 * 3000.0, f"{label} equilibrium {eq}")
        if label == "mesh_file_default":
            check(info["method"] == "tg_block_jacobi_pcg" and info["converged"], str(info))
            want = {"take_rows/float64": (info["iterations"] + 2) * fa.operator.gathers_per_apply}
            rel = rel_diff(R, R_default)
            log(f"   corner reactions vs the structured default case: rel {rel:.3e}")
            check(rel <= 1e-9, "mesh-file default reactions differ from phase 5's")
        else:
            check(3 * fa.num_nodes <= 6000 and info["method"] == "dense_cholesky", str(info))
            want = {}
        check(launches == want, f"{label} launch count mismatch: expect {want}")
        out[label] = {"launches": launches, "run_simulation_s": t_run, "solve_info": info,
                      "analysis": fa}
    return out


def examples_phase(torch, mem_tb):
    """Phase 12: the repro counterparts at their own inputs and the
    bench_dyngather sweep, counted; then take_along_axis and row_copy
    timed beside their plain versions and bounds."""
    from femx_torch.examples import bench_dyngather, gather_repros, mosaic_repros

    def run_all():
        errs = {}
        for mod in (mosaic_repros, gather_repros):
            for name, fn in mod.REPROS.items():
                got = fn().cpu().numpy()
                errs[name] = float(np.abs(got - mod.expected(name)).max())
        return errs, bench_dyngather.main()

    launches, t_all, (errs, sweep) = counted(torch, run_all)
    log(f"   repros max|kernel - numpy|: {errs}")
    check(all(v == 0.0 for v in errs.values()), "a repro disagrees")
    check(all(r["correct"] for r in sweep), "bench_dyngather sweep incorrect")
    per_h = 2 + 5  # check, warm-up, 5 timed
    want = {"row_copy/float32": len(mosaic_repros.REPROS), "take_rows/float32": 3,
            "take_along_axis/float32": 2 + per_h * len(bench_dyngather.HEIGHTS)}
    log(f"   launch check examples: expect {want}, got {launches}")
    check(launches == want, "examples launch count mismatch")

    def bytes_ms(nbytes):
        return nbytes / (mem_tb * 1e12) * 1e3

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sweep_rows = []
    tal = None
    for Hh, dt in [(h, np.float32) for h in bench_dyngather.HEIGHTS] + [
            (bench_dyngather.HEIGHTS[-1], np.float64)]:
        rng = np.random.default_rng(0)
        G = bench_dyngather.TOTAL // Hh
        tab = torch.as_tensor(rng.standard_normal((Hh, 128)).astype(dt), device=DEVICE)
        idx = torch.as_tensor(rng.integers(0, Hh, size=(G * Hh, 128)).astype(np.int32),
                              device=DEVICE)
        idx64 = idx.long()
        k = GATHER.take_along_axis(tab, idx, 0)
        p = GATHER.take_along_axis_plain(tab, idx64, 0)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        check(err == 0.0, f"take_along_axis disagrees with plain (H={Hh}, {np.dtype(dt).name})")
        item = np.dtype(dt).itemsize
        nb = tab.numel() * item + idx.numel() * 4 + k.numel() * item
        plan = GATHER.plan_take_along(*idx.shape, *tab.shape, 0, item, sms)
        rec = dict(H=Hh, dtype=np.dtype(dt).name, variant=plan.variant, grid=plan.grid,
                   smem=plan.smem, max_abs_err=err,
                   ms=cuda_ms(lambda: GATHER.take_along_axis(tab, idx, 0)),
                   plain_ms=cuda_ms(lambda: GATHER.take_along_axis_plain(tab, idx64, 0)),
                   library_ms=cuda_ms(lambda: torch.gather(tab, 0, idx64)),
                   bound_ms=bytes_ms(nb), bytes=nb)
        rec.update(ns_per_el=rec["ms"] * 1e6 / k.numel(), bound_share=rec["bound_ms"] / rec["ms"],
                   vs_library=rec["library_ms"] / rec["ms"])
        log(f"   take_along_axis H={Hh} {rec['dtype']}: {rec['ms']:.5f} ms "
            f"({rec['ns_per_el']:.5f} ns/el, {rec['variant']}, grid {plan.grid}), torch.gather "
            f"{rec['library_ms']:.5f} ms, bound {rec['bound_ms']:.5f} ms (share "
            f"{100 * rec['bound_share']:.1f} %)")
        sweep_rows.append(rec)
        if Hh == bench_dyngather.HEIGHTS[-1] and dt == np.float32:
            tal = dict(max_abs_err=err, ms=rec["ms"], plain_ms=rec["plain_ms"],
                       library_ms=rec["library_ms"], library_call="torch.gather(tab, 0, idx)",
                       bound_ms=rec["bound_ms"], bound_by="bytes", bytes=nb,
                       shape=f"tab ({Hh}, 128), idx {tuple(idx.shape)}, axis 0 "
                             f"(bench_dyngather H={Hh})", variant=plan.variant)
        del tab, idx, idx64, k, p
    tal.update(sweep=sweep, timed_sweep=sweep_rows,
               no_slower_than_library_at_every_h=all(r["ms"] <= r["library_ms"]
                                                      for r in sweep_rows))

    # row_copy at repro_dynslice_value's shape: the event-timed loop (host
    # bound at 8 KB), the device time from a CUDA graph of the same 10 calls,
    # and the host's cost of one call
    x = torch.arange(16 * 128, dtype=torch.float32, device=DEVICE).reshape(16, 128)
    r0 = torch.tensor([4], dtype=torch.int32, device=DEVICE)
    k = GATHER.row_copy(x, r0, 8)
    p = GATHER.row_copy_plain(x, r0, 8)
    torch.cuda.synchronize()
    err_r = (k - p).abs().max().item()
    check(err_r == 0.0, "row_copy disagrees with plain")
    nb = 2 * 8 * 128 * 4 + 4
    raw = GATHER._kernel_fn("row_copy", torch.float32)
    raw_args = (x.data_ptr(), r0.data_ptr(), k.data_ptr(), 8, 128, 1.0,
                torch.cuda.current_stream().cuda_stream)
    calls = {"row_copy": lambda: GATHER.row_copy(x, r0, 8),
             "torch.mul": lambda: torch.mul(x[4:12], 1.0),
             "plain": lambda: GATHER.row_copy_plain(x, r0, 8),
             "raw C entry": lambda: raw(*raw_args)}
    # kernel and library in turns (kernel, library, library, kernel, twice),
    # median of each: the loop measures the host, whose speed drifts within
    # a call
    turns = {"row_copy": [], "torch.mul": []}
    for name in ("row_copy", "torch.mul", "torch.mul", "row_copy") * 2:
        turns[name].append(cuda_ms(calls[name]))
    rc = dict(max_abs_err=err_r, ms=statistics.median(turns["row_copy"]),
              plain_ms=cuda_ms(calls["plain"]), library_ms=statistics.median(turns["torch.mul"]),
              turns_ms=turns, library_call="torch.mul(x[4:12], 1.0)",
              bound_ms=bytes_ms(nb), bound_by="bytes", bytes=nb,
              shape="x (16, 128), rows [4, 12) (repro_dynslice_value)",
              graph_device_ms=graph_device_ms(torch, calls["row_copy"]),
              library_graph_device_ms=graph_device_ms(torch, calls["torch.mul"]),
              host_us_per_call={name: host_us(torch, fn) for name, fn in calls.items()})
    rc["no_slower_than_library"] = rc["ms"] <= rc["library_ms"]
    log(f"   timing row_copy: {json.dumps(rc)}")

    # row_copy where bytes bind: 131,072 rows of (262,144, 128) f32
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((262_144, 128)).astype(
        np.float32), device=DEVICE)
    n_big = 131_072
    k = GATHER.row_copy(x, r0, n_big)
    torch.cuda.synchronize()
    check(torch.equal(k, GATHER.row_copy_plain(x, r0, n_big)),
          "row_copy disagrees with plain (large)")
    nb = 2 * n_big * 128 * 4 + 4
    big = dict(ms=cuda_ms(lambda: GATHER.row_copy(x, r0, n_big)),
               plain_ms=cuda_ms(lambda: GATHER.row_copy_plain(x, r0, n_big)),
               library_ms=cuda_ms(lambda: torch.mul(x[4:4 + n_big], 1.0)),
               library_call="torch.mul(x[4:131076], 1.0)", bound_ms=bytes_ms(nb), bytes=nb,
               shape="x (262144, 128), rows [4, 131076)")
    big["bound_share"] = big["bound_ms"] / big["ms"]
    log(f"   timing row_copy, large: {json.dumps(big)}")
    rc["large"] = big
    return launches, {"take_along_axis": tal, "row_copy": rc}


BENCH_F_HZ = (121.70, 121.88, 450.56)  # BENCH_r05.json: the f32 Lanczos f1-f3
BENCH_F1_REFINED_HZ = 120.962324  # BENCH_r05.json: the Ritz-refined f1
RHO = 7850.0


def pcg_launches(its, per_apply=1, per_precond=0):
    """Kernel launches of pcg calls with these iteration counts: one
    operator apply and one preconditioner call up front and per iteration."""
    return (per_apply + per_precond) * (sum(its) + len(its))


def bench_modal(torch, bench, sb):
    """Phase 13(a): bench.py:148-202 through femx_torch.bench's functions:
    shift-invert Lanczos with f32 MG-PCG inner solves on the face-clamped
    flagship (twice: first and steady), then shift_invert_refine through
    pcg_refined to a true residual of 1e-9, held to BENCH_r05's parity
    numbers."""
    per_vcycle = 5 * (len(sb.mg.levels) - 1)

    def lanczos():
        return bench.lanczos(sb)

    torch.cuda.reset_peak_memory_stats()
    state = vcycle_state(sb.mg)
    launches, t_first, mres = counted(torch, lanczos)
    inner = mres.inner_iterations
    want = add_launches({f"{SCM}/float32": pcg_launches(inner)},
                        vcycle_launches(per_vcycle, pcg_launches(inner, 0, 1), state))
    log(f"   Lanczos: {mres.iterations} inner MG-PCG solves of {inner} iterations; "
        f"launch check: expect {want}, got {launches}")
    check(len(inner) == mres.iterations and launches == want, "Lanczos launch count mismatch")
    t_steady, mres = wall_s(lanczos)
    peak = torch.cuda.max_memory_allocated()
    f_hz = mres.omega.cpu().numpy() / (2 * np.pi)
    log(f"   modal first-10: {t_steady:.6f} s steady, {t_first:.6f} s first; f = "
        f"{f_hz.tolist()} Hz; peak device memory {peak / 2 ** 20:.1f} MiB")
    check(abs(mres.iterations - 22) <= 4, f"{mres.iterations} inner solves, not 22 +- 4")
    rel3 = np.abs(f_hz[:3] / np.array(BENCH_F_HZ) - 1.0)
    log(f"   f1-f3 against BENCH_r05's {BENCH_F_HZ}: rel {rel3.tolist()}")
    check(np.all(rel3 <= 1e-2), "Lanczos f1-f3 off BENCH_r05's by more than 1e-2")

    solves = []
    state = vcycle_state(sb.mg)
    launches_r, t_ref, (om_ref, eta, _) = counted(
        torch, lambda: bench.refine_modes(sb, mres, solves))
    # pcg_refined: 1 + passes f32 pcg calls and as many f64 residuals
    calls = launches_r.get(f"{SCM}/float64", 0)
    vcycles = sum(i for i, _ in solves) + calls
    want = add_launches({f"{SCM}/float32": vcycles, f"{SCM}/float64": calls},
                        vcycle_launches(per_vcycle, vcycles, state))
    log(f"   refinement: {len(solves)} accurate solves, {calls} pcg calls, true residuals "
        f"max {max(r for _, r in solves):.3e}; launch check: expect {want}, got {launches_r}")
    check(len(solves) == 20 and 20 <= calls <= 20 * 7 and launches_r == want,
          "refinement launch count mismatch")
    f_ref = om_ref.cpu().numpy() / (2 * np.pi)
    eta = eta.cpu().numpy()
    rel1 = abs(f_ref[0] / BENCH_F1_REFINED_HZ - 1.0)
    log(f"   refined: {t_ref:.6f} s, f1 {f_ref[0]:.6f} Hz (Lanczos {f_hz[0]:.6f}; rel to "
        f"BENCH_r05's {BENCH_F1_REFINED_HZ}: {rel1:.3e}); bounds {eta.tolist()}")
    check(rel1 <= 1e-5, "refined f1 off BENCH_r05's by more than 1e-5")
    check(eta[0] <= 1e-5 and eta.max() <= 1e-2, f"Ritz bounds {eta.tolist()}")
    return {"launches_lanczos": launches, "launches_refine": launches_r,
            "modal10_s": t_steady, "modal10_first_s": t_first,
            "modal10_inner_solves": mres.iterations, "modal10_inner_iterations": inner,
            "modal_f_lanczos_hz": f_hz.tolist(), "modal_f1_lanczos_hz": float(f_hz[0]),
            "modal_f1_hz": float(f_ref[0]), "modal_f_refined_hz": f_ref.tolist(),
            "modal_bounds": eta.tolist(), "modal_refine_s": t_ref,
            "modal_refine_iterations": [i for i, _ in solves],
            "modal_peak_device_bytes": peak}


# modes of phase 13(b)'s analysis modal (6, not 10, and 3 in 13(d): the
# whole run must stay well inside its time limit on a slow host)
ANALYSIS_MODES = 6


# compute_stresses against the CPU (13(b)): each run rounds an entry along
# its longest chain at most ~64 times (the 10-term Jacobian and gradient
# sums, the cofactor inverse, the 6-term stress product, the 4-point mean,
# up to 24 element terms at a node, the division by the count), each time by
# at most eps of the magnitudes summed there; two runs differ by at most
# twice that.
STRESS_ROUNDING_STEPS = 128


def stress_rounding_scale(torch, points, conn, u, C, chunk=65536):
    """(N, 6) float64, host: per nodal stress entry the sum of its terms'
    magnitudes through nodal_stresses' chain, |C| |S| (|dN| |u|) averaged
    per element and over the node's elements (on the CPU)."""
    from femx_torch.elements import tet10 as tet10_el

    f64 = torch.float64
    pts = torch.as_tensor(np.asarray(points), dtype=f64)
    conn_t = torch.as_tensor(np.asarray(conn), dtype=torch.int64)
    u3 = torch.as_tensor(np.asarray(u), dtype=f64).reshape(-1, 3).abs()
    Ca = torch.as_tensor(np.abs(np.asarray(C)), dtype=f64)
    sel = torch.as_tensor(np.abs(tet10_el._SEL), dtype=f64)
    out = torch.zeros((pts.shape[0], 6), dtype=f64)
    for e0 in range(0, conn_t.shape[0], chunk):
        c = conn_t[e0:e0 + chunk]
        dN, _, _ = tet10_el.jacobians(pts[c])
        grad = torch.einsum("egkn,enc->egkc", dN.abs(), u3[c])
        stress = torch.einsum("ab,egb->ega", Ca, torch.einsum("ack,egkc->ega", sel, grad))
        es = stress.mean(dim=1)
        for k in range(10):
            out.index_add_(0, c[:, k], es)
    counts = torch.bincount(conn_t.reshape(-1), minlength=pts.shape[0]).to(f64)
    return (out / counts.clamp(min=1.0)[:, None]).numpy()


def analysis_extras(torch, femx_torch, fa):
    """Phase 13(b): modal(n_modes=6), compute_stresses and solve_cases on
    phase 6's corner-fixed f32 flagship analysis."""
    from femx_torch.analysis.solid import nodal_stresses

    per_vcycle = 5 * (len(fa._precond.levels) - 1)
    out = {}
    state = vcycle_state(fa._precond)
    launches, t_modal, res = counted(torch, lambda: fa.modal(n_modes=ANALYSIS_MODES, rho=RHO))
    info = fa.modal_info
    inner = info["inner_iterations"]
    want = add_launches({f"{SCM}/float32": pcg_launches(inner)},
                        vcycle_launches(per_vcycle, pcg_launches(inner, 0, 1), state))
    f_hz = res.omega.cpu().numpy() / (2 * np.pi)
    V = res.modes.double()
    mass = torch.as_tensor(fa.operator.to_global(fa._lumped_mass(RHO)), device=DEVICE)
    orth = float((V.T @ (mass[:, None] * V)
                  - torch.eye(ANALYSIS_MODES, dtype=V.dtype, device=DEVICE))
                 .abs().max())
    log(f"   fa.modal(n_modes={ANALYSIS_MODES}): {t_modal:.6f} s, {info['iterations']} inner solves of "
        f"{info['inner_iterations']} iterations; f = {f_hz.tolist()} Hz; "
        f"max|V^T M V - I| = {orth:.3e}; launch check: expect {want}, got {launches}")
    check(launches == want, "analysis modal launch count mismatch")
    check(res.modes.shape == (3 * fa.num_nodes, ANALYSIS_MODES) and np.all(f_hz > 0)
          and np.all(np.diff(f_hz) >= 0), "frequencies not positive and ascending")
    check(orth <= 1e-4, "modes not mass-orthonormal")
    out.update(analysis_modal_s=t_modal, analysis_modal_f_hz=f_hz.tolist(),
               analysis_modal_inner_solves=info["iterations"], launches_modal=launches)

    torch.cuda.reset_peak_memory_stats()
    launches, t_st, (nodal, vm) = counted(torch, fa.compute_stresses)
    peak = torch.cuda.max_memory_allocated()
    check(launches == {}, f"compute_stresses launched kernels: {launches}")
    check(nodal.shape == (fa.num_nodes, 6) and np.all(np.isfinite(nodal))
          and np.all(np.isfinite(vm)), "stresses not finite")
    t_cpu, (nodal_c, vm_c) = wall_s(lambda: nodal_stresses(
        fa.points, fa.tetra10_conn, fa.u, fa.C, device="cpu"))
    rows = np.random.default_rng(0).choice(fa.num_nodes, 1000, replace=False)
    rel = max(rel_diff(nodal[rows], nodal_c[rows]), rel_diff(vm[rows], vm_c[rows]))
    again = nodal_stresses(fa.points, fa.tetra10_conn, fa.u, fa.C, device=DEVICE)
    same = bool(np.array_equal(again[0], nodal) and np.array_equal(again[1], vm))
    # every entry against the rounding bound of its own computation (the
    # card and the CPU sum in other orders, so their difference is bounded
    # by the sum of the terms' magnitudes, not by the result's)
    scale = stress_rounding_scale(torch, fa.points, fa.tetra10_conn, fa.u, fa.C)
    eps = np.finfo(np.float64).eps
    ratio = np.abs(nodal - nodal_c) / (eps * np.maximum(scale, 1e-300))
    dvm_lim = (np.sqrt(3.0) * STRESS_ROUNDING_STEPS * eps * np.linalg.norm(scale, axis=1)
               + 16 * eps * np.abs(vm_c))
    vm_ratio = float((np.abs(vm - vm_c) / np.maximum(dvm_lim, 1e-300)).max())
    worst = np.unravel_index(np.argmax(ratio), ratio.shape)
    log(f"   compute_stresses: {t_st:.6f} s on the card ({t_cpu:.3f} s on the CPU), peak "
        f"{peak / 2 ** 20:.1f} MiB, max von Mises {vm.max():.6e} Pa; card run twice "
        f"bitwise equal: {same}; against the CPU: 1,000 sampled rows rel {rel:.3e} (of "
        f"their largest entry); every entry's difference / (eps x the sum of its terms' "
        f"magnitudes): max {ratio.max():.3f} (limit {STRESS_ROUNDING_STEPS}) at node "
        f"{worst[0]} component {worst[1]} (difference "
        f"{abs(nodal - nodal_c)[worst]:.3e}, value {nodal_c[worst]:.3e}, scale "
        f"{scale[worst]:.3e}); von Mises against its bound: {vm_ratio:.3f} (limit 1)")
    check(ratio.max() <= STRESS_ROUNDING_STEPS and vm_ratio <= 1.0,
          "compute_stresses differs from the CPU run beyond its rounding bound")
    out.update(compute_stresses_s=t_st, compute_stresses_peak_device_bytes=peak,
               compute_stresses_cpu_rel=rel, compute_stresses_rounding_ratio=float(ratio.max()),
               compute_stresses_card_repeatable=same, launches_stresses=launches)

    f0 = fa.force_data
    f1 = [{"force_x": 700.0, "force_y": 0.0, "force_z": 300.0, "force_x_pstn": 0.4,
           "force_y_pstn": 0.4, "force_z_pstn": 0.8}]
    state = vcycle_state(fa._precond)
    launches, t_cases, U = counted(torch, lambda: fa.solve_cases([f0, f1, f0 + f1]))
    its = [c["iterations"] for c in fa.case_solve_info]
    # as solve(): f64 CG on the f64 operator, the f32 V-cycle as preconditioner
    want = add_launches({f"{SCM}/float64": pcg_launches(its)},
                        vcycle_launches(per_vcycle, pcg_launches(its, 0, 1), state))
    r0, r2 = rel_diff(U[0], fa.u), rel_diff(U[2], U[0] + U[1])
    log(f"   solve_cases (3 cases): {t_cases:.6f} s, iterations {its}, residuals "
        f"{[c['residual'] for c in fa.case_solve_info]}; |U0 - u| rel {r0:.3e}, "
        f"|U2 - (U0 + U1)| rel {r2:.3e}; launch check: expect {want}, got {launches}")
    check(launches == want, "solve_cases launch count mismatch")
    check(all(c["converged"] for c in fa.case_solve_info) and np.all(np.isfinite(U)),
          "a case did not converge")
    check(r0 <= 1e-4 and r2 <= 1e-4, "solve_cases disagrees with solve() or linearity")
    out.update(solve_cases_s=t_cases, solve_cases_iters=its, launches_cases=launches)
    return out


def checkpoint_case(torch, femx_torch, R_default, R_iterations):
    """Phase 13(c): phase 5's case with checkpoint= (chunks of 100): a first
    run cut at 300 iterations, then a second analysis that resumes from the
    file and continues CG: phase 5's iteration count and reactions."""
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, "default_case_state")
    chunk = 100

    def chunked_launches(done):
        # the chunks continue CG's recurrences: one apply per iteration, one
        # up front (the first residual, or checking the file's against
        # b - A x on resume) and one for the reactions
        return {f"{SCM}/float64": done + 2}

    try:
        first = default_analysis(femx_torch, checkpoint=path, checkpoint_chunk=chunk)
        first.CHECKPOINT_MAXITER = 300
        launches1, t1, _ = counted(torch, first.run_simulation)
        info1 = first.solve_info
        want1 = chunked_launches(info1["iterations"])
        log(f"   cut run: {t1:.6f} s, solve_info {info1}; launch check: expect {want1}, "
            f"got {launches1}")
        check(not info1["converged"] and info1["iterations"] == 300, "the cut run did not stop")
        check(launches1 == want1, "checkpoint cut run launch count mismatch")
        fa = default_analysis(femx_torch, checkpoint=path, checkpoint_chunk=chunk)
        launches2, t2, _ = counted(torch, fa.run_simulation)
        info = fa.solve_info
        want2 = chunked_launches(info["iterations"] - info["resumed_iterations"])
        rel = rel_diff(corner_reactions(fa), R_default)
        log(f"   resumed run: {t2:.6f} s, solve_info {info}; corner reactions vs phase 5: "
            f"rel {rel:.3e}; launch check: expect {want2}, got {launches2}")
        check(info["method"] == "structured_block_jacobi_pcg_checkpointed", info["method"])
        check(info["resumed_iterations"] == 300 and info["converged"], "did not resume")
        check(info["iterations"] == R_iterations, f"{info['iterations']} iterations in all, "
              f"not phase 5's {R_iterations}")
        check(launches2 == want2, "checkpoint resumed run launch count mismatch")
        check(rel <= 1e-9, "resumed reactions differ from phase 5's")
    finally:
        for ext in (".npz", ".json"):
            if os.path.exists(path + ext):
                os.remove(path + ext)
    return {"launches_cut": launches1, "launches_resumed": launches2,
            "checkpoint_cut_s": t1, "checkpoint_resumed_s": t2,
            "checkpoint_iterations": info["iterations"], "checkpoint_reactions_rel": rel}


def mesh_file_modal(torch, fa_file, fa_default):
    """Phase 13(d): modal(n_modes=3, tol=1e-6, refine=True) on phase 11's
    mesh-file default (TG + block-Jacobi, f64: take_rows) and on phase 5's
    structured default (the f64 cell kernel): the same K and lumped mass,
    so the same frequencies."""
    out, f = {}, {}
    for label, fa, key, per in (
            ("mesh_file_modal", fa_file, "take_rows/float64", fa_file.operator.gathers_per_apply),
            ("default_modal", fa_default, f"{SCM}/float64", 1)):
        launches, t, res = counted(torch, lambda fa=fa: fa.modal(n_modes=3, tol=1e-6,
                                                                  refine=True))
        info = fa.modal_info
        its = info["inner_iterations"] + info["refine_iterations"]
        want = {key: pcg_launches(its, per)}
        f[label] = res.omega.cpu().numpy() / (2 * np.pi)
        log(f"   {label}: {t:.6f} s, {info['iterations']} Lanczos steps, inner iterations "
            f"{sum(info['inner_iterations'])}, refine {info['refine_iterations']}; f = "
            f"{f[label].tolist()} Hz, bounds {fa.modal_error_bounds.tolist()}; launch "
            f"check: expect {want}, got {launches}")
        check(launches == want, f"{label} launch count mismatch")
        out[label] = {"launches": launches, "s": t, "f_hz": f[label].tolist()}
    rel = rel_diff(f["mesh_file_modal"], f["default_modal"])
    log(f"   mesh-file against structured frequencies: rel {rel:.3e}")
    check(rel <= 1e-6, "mesh-file and structured modal frequencies differ")
    out["rel"] = rel
    return out


def block_operators_bench(torch, bench, problem, tg_ub):
    """Phase 14(a): femx_torch.bench's unstructured flow with group-ELL, then
    cluster (unstructured_bench, as phase 10), each operator's K @ u in
    global order held to phase 10's TG apply (1e-5 relative, f32) and its
    launches per apply to its take_rows calls per apply."""
    x = np.random.default_rng(0).standard_normal(problem.ndof).astype(np.float32)
    tg = tg_ub.op
    xt = torch.as_tensor(tg.to_internal(x), device=DEVICE)
    y_tg = tg.to_global(tg.apply(xt).cpu().numpy())
    tg_ms = cuda_ms(lambda: tg.apply(xt), reps=10, inner=3)
    rows, ubs = {}, {}
    for kind in ("groupell", "cluster"):
        out, ub = unstructured_bench(torch, bench, problem, kind)
        xi = torch.as_tensor(ub.op.to_internal(x), device=DEVICE)
        launches, _, y = counted(torch, lambda: ub.op.apply(xi))
        want = {"take_rows/float32": ub.op.gathers_per_apply}
        rel = rel_diff(ub.op.to_global(y.cpu().numpy()), y_tg)
        out.update(apply_launches=launches, apply_rel_to_tg=rel,
                   apply_ms=cuda_ms(lambda: ub.op.apply(xi), reps=10, inner=3),
                   tg_apply_ms=tg_ms, gather_rows=ub.op.gather_rows())
        log(f"   {kind} apply: K@u against TG rel {rel:.3e}; launches per apply: expect {want}, "
            f"got {launches}; {out['apply_ms']:.4f} ms per apply (TG's {tg_ms:.4f} ms), "
            f"{out['gather_rows']} gather rows; "
            f"assembly {ub.assembly_s:.3f} s, setup {ub.setup_s:.3f} s")
        check(launches == want, f"{kind} apply launch count mismatch")
        check(rel <= 1e-5, f"{kind} apply differs from TG's by {rel:.3e}")
        rows[kind], ubs[kind] = out, ub
    return rows, ubs


def block_operator_flagships(torch, femx_torch, path, R_struct):
    """Phase 14(b): phase 8's relabelled flagship file through
    SolidReactionAnalysis(dtype=float32, unstructured_operator=...) for
    group-ELL and cluster: f64 CG on the float64 build, the f32 lattice MG;
    method, equilibrium, corner reactions against phase 6's and launch
    counts."""
    force = [{"force_x": 0.0, "force_y": -1000.0, "force_z": 0.0,
              "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 1.6}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in CORNERS_FLAGSHIP]
    out = {}
    for kind in ("groupell", "cluster"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # what earlier phases still hold
        fa = femx_torch.SolidReactionAnalysis(path, force, fix, E=E, v=NU, dtype=np.float32,
                                              cg_tol=1e-8, verbose=False, device=DEVICE,
                                              unstructured_operator=kind)
        launches, t_run, _ = counted(torch, fa.run_simulation)
        info = fa.solve_info
        log(f"   {kind}: run_simulation {t_run:.6f} s; solve_info {info}; stage_times "
            f"{fa.stage_times}")
        check(info["method"] == f"{kind}_lattice_mg_pcg_mixed", info["method"])
        check(info["converged"] and info["residual"] <= 1e-8, f"{kind} flagship did not converge")
        per = fa._precond.launches_per_call()
        it = info["iterations"]
        g = fa._op64.gathers_per_apply
        # as phase 8: the f64 operator once up front, once per iteration and
        # once for the reactions; the f32 lattice MG once up front and once
        # per iteration
        want = add_launches({"take_rows/float64": (it + 2) * g,
                             "take_rows/float32": (it + 1) * per["take_rows"]},
                            lattice_launches(fa._precond, it + 1))
        log(f"   launch check: {it} iterations, {g} take_rows per apply -> expect {want}, "
            f"got {launches}")
        check(launches == want, f"{kind} flagship launch count mismatch")
        eq = fa.equilibrium_residual()
        R = corner_reactions(fa)
        rel = rel_diff(R, R_struct)
        peak = torch.cuda.max_memory_allocated() - base
        log(f"   corner reactions {R.tolist()}; against the structured route's rel {rel:.3e}; "
            f"equilibrium {eq.tolist()}; peak device memory {peak / 2 ** 30:.3f} GiB")
        check(np.linalg.norm(eq) <= 1e-6 * 1000.0, f"{kind} equilibrium {eq}")
        check(rel <= 1e-6, f"{kind} corner reactions differ from the structured route's")
        out[kind] = {"launches": launches, "run_simulation_s": t_run, "iterations": it,
                     "solve_s": info["solve_s"], "precond_setup_s": info["precond_setup_s"],
                     "stage_times": dict(fa.stage_times), "corner_rel_diff": rel,
                     "peak_device_bytes": peak}
        del fa
    return out


def groupell_symmetric(torch, ub):
    """Phase 14(c): FEMX_GROUPELL_SYM=1 once at the flagship: the symmetric
    storage's apply against phase 14(a)'s full storage (1e-5 relative, f32),
    its launches per apply, both applies timed."""
    from femx_torch.assembly_groupell import SolidOperatorGroupELL

    os.environ["FEMX_GROUPELL_SYM"] = "1"
    try:
        t_build, (sym, _) = wall_s(lambda: SolidOperatorGroupELL.from_mesh(
            ub.points, ub.conn, E, NU, dtype=np.float32, device=DEVICE))
    finally:
        del os.environ["FEMX_GROUPELL_SYM"]
    full = ub.op
    x = np.random.default_rng(1).standard_normal(3 * full.n_nodes).astype(np.float32)
    xf = torch.as_tensor(full.to_internal(x), device=DEVICE)
    xs = torch.as_tensor(sym.to_internal(x), device=DEVICE)
    launches, _, y = counted(torch, lambda: sym.apply(xs))
    want = {"take_rows/float32": sym.gathers_per_apply}
    rel = rel_diff(sym.to_global(y.cpu().numpy()), full.to_global(full.apply(xf).cpu().numpy()))
    out = {"launches": launches, "build_s": t_build, "rel_to_full": rel,
           "blocks": sym.gather_rows(), "full_blocks": full.gather_rows(),
           "apply_ms": cuda_ms(lambda: sym.apply(xs), reps=10, inner=3),
           "full_apply_ms": cuda_ms(lambda: full.apply(xf), reps=10, inner=3)}
    log(f"   symmetric storage: {json.dumps(out)}; launches per apply: expect {want}")
    check(sym.symmetric and launches == want, "symmetric apply launch count mismatch")
    check(rel <= 1e-5, f"symmetric apply differs from full storage by {rel:.3e}")
    return out


def new_shape_rows(torch, ge, cl, mem_tb):
    """Phase 14(d): take_rows at the shapes the new operators give it, each
    against its plain version (exact) and timed beside index_select, with
    its bytes bound: group-ELL's largest u16[ii] bucket (width 48), its
    u6[pairperm] (width 6) and cluster's largest u3[nodes] class (width 3),
    f32."""
    rng = np.random.default_rng(2)
    big = max(range(len(ge.idx)), key=lambda i: ge.idx[i].numel())
    cls = max(range(len(cl.cl_nodes)), key=lambda i: cl.cl_nodes[i].numel())
    cases = [("groupell u16[ii]", ge.n_pad // 16, 48, ge.idx[big]),
             ("groupell u6[pairperm]", ge.n_pad // 2, 6, ge.pairperm),
             ("cluster u3[nodes]", cl.n_nodes, 3, cl.cl_nodes[cls])]
    rows = []
    for label, n_rows, width, idx in cases:
        tab = torch.as_tensor(rng.standard_normal((n_rows, width)).astype(np.float32),
                              device=DEVICE)
        k = GATHER.take_rows(tab, idx)
        p = GATHER.take_rows_plain(tab, idx)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        check(err == 0.0, f"take_rows disagrees with plain at {label}")
        flat64 = idx.reshape(-1).long()
        nbytes = tab.numel() * 4 + idx.numel() * 4 + k.numel() * 4
        row = dict(shape=f"{label}: table {tuple(tab.shape)}, index {tuple(idx.shape)}",
                   max_abs_err=err, ms=cuda_ms(lambda: GATHER.take_rows(tab, idx)),
                   plain_ms=cuda_ms(lambda: GATHER.take_rows_plain(tab, idx)),
                   library_ms=cuda_ms(lambda: torch.index_select(tab, 0, flat64)),
                   bound_ms=nbytes / (mem_tb * 1e12) * 1e3, bound_by="bytes", bytes=nbytes)
        log(f"   take_rows {row['shape']}: kernel {row['ms']:.5f} ms, plain "
            f"{row['plain_ms']:.5f} ms, index_select {row['library_ms']:.5f} ms; bytes bound "
            f"{row['bound_ms']:.5f} ms ({nbytes / 1e6:.1f} MB, share "
            f"{100 * row['bound_ms'] / row['ms']:.0f} %)")
        rows.append(row)
    return rows


# -- phases 15-16: the beam, shaft, plane and pipe products ------------------
EPS = float(np.finfo(np.float64).eps)
GOLDEN_FREQS_HZ = np.array([16.8448, 33.4577, 44.0366, 104.8251, 234.9084,
                            305.0161, 342.7343, 363.8935, 400.6217, 644.5324])
PORTAL_SECTIONS = [
    {"group": "l_section", "type": "I section",
     "params": {"d": 0.05, "b": 0.025, "t_w": 0.005, "t_f": 0.005, "r": 0.001}},
    {"group": "c_section", "type": "C section",
     "params": {"d": 0.05, "b": 0.025, "t_f": 0.005, "t_w": 0.005, "r": 0.001}}]
FIX_ALL = {"type": "Fix", "fix_x": True, "fix_y": True, "fix_z": True, "fix_rx": True,
           "fix_ry": True, "fix_rz": True}
# The building frame's rolled sections (d, b, t_f, t_w, root radius r; m):
# UC 305x305x97 columns, UB 457x191x67 girders along x, UB 305x165x40
# beams along y.
BUILDING_SECTIONS = [
    {"group": "column", "type": "I section",
     "params": {"d": 0.3079, "b": 0.3053, "t_f": 0.0154, "t_w": 0.0099, "r": 0.0152}},
    {"group": "girder", "type": "I section",
     "params": {"d": 0.4534, "b": 0.1899, "t_f": 0.0127, "t_w": 0.0085, "r": 0.0102}},
    {"group": "beam", "type": "I section",
     "params": {"d": 0.3034, "b": 0.1650, "t_f": 0.0102, "t_w": 0.0060, "r": 0.0089}}]
STOREY, BAY, BAYS = 3.5, 6.0, 4
STOREYS, CUT_STOREYS = 10, 3  # 925 nodes / 5,550 DOF; the cut 1,770 DOF
PLANE_CELLS, PLANE_CPU_CELLS = (1024, 256), (256, 64)  # 2,102,274 and 132,354 DOF
PIPE_CELLS = (64, 512)  # (n_r, n_z): 264,450 DOF


def frame_ndof(storeys):
    """DOF of building_frame: joints plus one midside node per member."""
    joints = (BAYS + 1) ** 2 * (storeys + 1)
    members = (BAYS + 1) ** 2 * storeys + 2 * BAYS * (BAYS + 1) * storeys
    return 6 * (joints + members)


def lattice_ndof(cells):
    return 2 * (2 * cells[0] + 1) * (2 * cells[1] + 1)


def portal_analysis(femx_torch, rho, mass, device):
    """The reference's portal frame (tests/test_reference_goldens.py:46-73)
    through BeamAnalysis; returns (analysis, loaded node)."""
    fb = femx_torch.FrameBuilder()
    n0 = fb.add_node((0.0, 0.0, 0.0))
    n1 = fb.add_node((0.0, 1.0, 0.0))
    n2 = fb.add_node((0.7, 1.0, 0.0))
    n3 = fb.add_node((0.7, 0.0, 0.0))
    n4 = fb.add_node((0.35, 1.0, 0.0))
    fb.add_vertex_group("fix", [n0, n3])
    fb.add_vertex_group("load_y", [n4])
    fb.add_member(n0, n1, "l_section")
    fb.add_member(n3, n2, "l_section")
    fb.add_member(n1, n4, "c_section")
    fb.add_member(n4, n2, "c_section")
    bcs = [{"group": "fix", **FIX_ALL},
           {"group": "load_y", "type": "Force", "force_x": 0, "force_y": -3000.0, "force_z": 0}]
    return femx_torch.BeamAnalysis(fb.build(), PORTAL_SECTIONS, bcs, E=E, nu=NU, rho=rho,
                                   mass=mass, device=device), n4


def portal_golden(torch, femx_torch):
    """Phase 15(a): the golden portal frame on the card (consistent mass,
    rho 7800: statics to 2e-5, the 10 frequencies under the bounds of
    tests/test_reference_goldens.py:90-100); lumped, rho 7850, against the
    port's own CPU run (1e-9)."""
    ba, n4 = portal_analysis(femx_torch, 7800.0, "consistent", DEVICE)
    launches, secs, res = counted(torch, ba.run)
    u3 = res.u.reshape(-1, 6)[:, :3]
    umax, smax = float(np.abs(u3).max()), float(res.smoothed_stresses.max())
    f = res.natural_frequencies_hz[:10]
    rel = np.abs(f - GOLDEN_FREQS_HZ) / GOLDEN_FREQS_HZ
    log(f"   consistent, rho 7800: {secs:.3f} s, max |u| {umax:.6e} m at node "
        f"{int(np.argmax(np.linalg.norm(u3, axis=1)))}, max stress {smax / 1e6:.4f} MPa at node "
        f"{int(np.argmax(res.smoothed_stresses))}; f {f.round(4).tolist()} Hz, rel to the "
        f"golden {rel.round(5).tolist()}; launches {launches}")
    check(int(np.argmax(np.linalg.norm(u3, axis=1))) == n4, "max |u| not at node 4")
    check(abs(umax / 3.0047e-3 - 1) <= 2e-5, f"max |u| {umax}")
    check(int(np.argmax(res.smoothed_stresses)) == n4, "max stress not at node 4")
    check(abs(smax / 1e6 / 283.4407 - 1) <= 2e-5, f"max stress {smax}")
    check(rel[[0, 1, 3, 4, 6]].max() < 1e-3 and rel[[2, 8]].max() < 1e-2
          and rel[[5, 7]].max() < 3.5e-2 and rel[9] < 0.11, f"golden frequencies {rel}")
    card, _ = portal_analysis(femx_torch, 7850.0, "lumped", DEVICE)
    cpu, _ = portal_analysis(femx_torch, 7850.0, "lumped", "cpu")
    fc, fh = card.run().natural_frequencies, cpu.run().natural_frequencies
    lumped_rel = float(np.abs(fc / fh - 1).max())
    log(f"   lumped, rho 7850: {len(fc)} frequencies, card against CPU max rel {lumped_rel:.3e}")
    check(lumped_rel <= 1e-9, "lumped frequencies: card and CPU disagree")
    return {"launches": launches, "s": secs, "umax": umax, "smax_mpa": smax / 1e6,
            "lumped_card_cpu_rel": lumped_rel}


def building_frame(femx_torch, storeys, mass, device, section_method="auto"):
    """A steel building frame of `storeys` 3.5 m storeys over a 4 x 4 grid of
    6 m bays (FrameBuilder, every member in 2 elements): UC columns fixed at
    the base, UB girders along x and beams along y, a lateral 10 kN x k/n
    point load (x) at each of the five windward nodes of floor k, and 15 kN/m
    of gravity on every girder and beam (DistributedForce)."""
    fb = femx_torch.FrameBuilder()
    grid = {}
    for k in range(storeys + 1):
        for i in range(BAYS + 1):
            for j in range(BAYS + 1):
                grid[i, j, k] = fb.add_node((i * BAY, j * BAY, k * STOREY))
    for k in range(storeys):
        for i in range(BAYS + 1):
            for j in range(BAYS + 1):
                fb.add_member(grid[i, j, k], grid[i, j, k + 1], "column", n_elems=2)
    for k in range(1, storeys + 1):
        for i in range(BAYS + 1):
            for j in range(BAYS + 1):
                if i < BAYS:
                    fb.add_member(grid[i, j, k], grid[i + 1, j, k], "girder", n_elems=2)
                if j < BAYS:
                    fb.add_member(grid[i, j, k], grid[i, j + 1, k], "beam", n_elems=2)
    fb.add_vertex_group("base", [grid[i, j, 0] for i in range(BAYS + 1)
                                 for j in range(BAYS + 1)])
    bcs = [{"group": "base", **FIX_ALL}]
    for k in range(1, storeys + 1):
        fb.add_vertex_group(f"wind{k}", [grid[0, j, k] for j in range(BAYS + 1)])
        bcs.append({"group": f"wind{k}", "type": "Force", "force_x": 10e3 * k / storeys,
                    "force_y": 0.0, "force_z": 0.0})
    bcs += [{"group": g, "type": "DistributedForce", "wx": 0.0, "wy": 0.0, "wz": -15e3}
            for g in ("girder", "beam")]
    return femx_torch.BeamAnalysis(fb.build(), BUILDING_SECTIONS, bcs, E=E, nu=NU,
                                   rho=7850.0, mass=mass, section_method=section_method,
                                   device=device)


def frame_checks(torch, ba, res, n_modes=20):
    """Reaction equilibrium (force components, against |sum F|) and the
    eigen-residuals of the first n_modes against the backward-error scale
    1e3 eps (|K| + w^2 |M|) |phi| of a dense symmetric eigensolve (|.|_2,
    from 60 power steps on the card). Returns the two worst ratios."""
    fixed = res.fixed_dofs
    r = res.K @ res.u - res.f
    applied = res.f.reshape(-1, 6)[:, :3].sum(axis=0)
    react = np.array([r[fixed[fixed % 6 == c]].sum() for c in range(3)])
    eq = float(np.linalg.norm(react + applied) / np.linalg.norm(applied))
    free = np.setdiff1d(np.arange(len(res.u)), fixed)
    dev = torch.device(DEVICE)
    K = torch.as_tensor(res.K[np.ix_(free, free)], device=dev)
    M = torch.as_tensor(res.M[np.ix_(free, free)], device=dev)

    def norm2(A):
        x = torch.ones(A.shape[0], dtype=A.dtype, device=dev)
        for _ in range(60):
            x = A @ x
            x = x / torch.linalg.vector_norm(x)
        return float(torch.linalg.vector_norm(A @ x))

    k2, m2 = norm2(K), norm2(M)
    phi = torch.as_tensor(res.mode_shapes[free, :n_modes], device=dev)
    w2 = torch.as_tensor(res.natural_frequencies[:n_modes] ** 2, device=dev)
    resid = torch.linalg.vector_norm(K @ phi - (M @ phi) * w2, dim=0)
    scale = 1e3 * EPS * (k2 + w2 * m2) * torch.linalg.vector_norm(phi, dim=0)
    ratio = float((resid / scale).max())
    log(f"   equilibrium |sum R + sum F| / |sum F| = {eq:.3e}; |K|_2 {k2:.4e}, |M|_2 "
        f"{m2:.4e}; eigen-residuals of {n_modes} modes / (1e3 eps (|K| + w^2 |M|) |phi|): "
        f"max {ratio:.3e}")
    check(eq <= 1e-8, f"frame equilibrium {eq}")
    check(ratio <= 1.0, f"eigen-residual ratio {ratio}")
    return eq, ratio


def building_frames(torch, femx_torch):
    """Phase 15(b): the 10-storey frame (925 nodes, 5,550 DOF) with lumped,
    then consistent mass, its stage times; a 3-storey cut (1,770 DOF) held
    to the port's CPU run (closed-form sections on both: the warping FEMs
    of the CPU run would take minutes)."""
    out = {}
    for mass in ("lumped", "consistent"):
        ba = building_frame(femx_torch, STOREYS, mass, DEVICE)
        launches, secs, res = counted(torch, lambda: ba.run(n_modes=20))
        check(len(res.u) == frame_ndof(STOREYS), f"{len(res.u)} DOF")
        log(f"   {STOREYS} storeys, {mass}: {secs:.3f} s, stages {json.dumps(ba.stage_times)}; f1-f3 "
            f"{res.natural_frequencies_hz[:3].round(6).tolist()} Hz; launches {launches}")
        eq, ratio = frame_checks(torch, ba, res)
        out[mass] = {"s": secs, "stage_times": ba.stage_times, "launches": launches,
                     "equilibrium": eq, "eigen_residual_ratio": ratio,
                     "f1_hz": float(res.natural_frequencies_hz[0])}
        if mass == "lumped":  # phase 17 reports and plots it
            out[mass]["analysis"] = (ba, res)
    card = building_frame(femx_torch, CUT_STOREYS, "consistent", DEVICE,
                          "closed_form").run(n_modes=20)
    cpu = building_frame(femx_torch, CUT_STOREYS, "consistent", "cpu", "closed_form").run(n_modes=20)
    check(len(card.u) == frame_ndof(CUT_STOREYS), f"{len(card.u)} DOF in the cut")
    u_rel = rel_diff(card.u, cpu.u)
    f_rel = float(np.abs(card.natural_frequencies / cpu.natural_frequencies - 1).max())
    log(f"   {CUT_STOREYS}-storey cut, card against CPU: u rel {u_rel:.3e}, 20 frequencies rel {f_rel:.3e}")
    check(u_rel <= 1e-10 and f_rel <= 1e-8, "3-storey cut: card and CPU disagree")
    out["cut"] = {"u_rel": u_rel, "f_rel": f_rel}
    return out


def eb_lateral_hz(n, L, d, rho=7850.0):
    I, A = np.pi * d**4 / 64.0, np.pi * d**2 / 4.0
    return (n * np.pi / L) ** 2 * np.sqrt(E * I / (rho * A)) / (2 * np.pi)


def shaft_cases(torch, femx_torch):
    """Phase 15(c): ShaftModalAnalysis on the test fixture
    (tests/test_shaft_modal.py:29-35) and on a stepped shaft of 5 segments
    on 3 bearings in 400 elements; whirl pairs held to the eigensolve's
    rounding scale 1e3 eps lam_max / lam, critical speeds = 60 f."""
    from femx_torch.modal import modal_dense

    cases = {
        "fixture": dict(segments=[{"length": 2.0, "d": 0.04}], bearings=[0.0, 2.0],
                        n_elems=60),
        "stepped": dict(segments=[{"length": 0.3, "d": 0.05}, {"length": 0.5, "d": 0.07},
                                  {"length": 0.6, "d": 0.08, "d_inner": 0.03},
                                  {"length": 0.5, "d": 0.07}, {"length": 0.3, "d": 0.05}],
                        bearings=[0.15, 1.1, 2.05], n_elems=400),
    }
    out = {}
    for label, kw in cases.items():
        sm = femx_torch.ShaftModalAnalysis(E=E, nu=NU, rho=7850.0, verbose=False,
                                           device=DEVICE, **kw)
        launches, secs, _ = counted(torch, lambda: sm.run(n_modes=12))
        res = sm.analysis.results
        lam_max = float(modal_dense(res.K, res.M, res.fixed_dofs, device=DEVICE).omega.max()) ** 2
        lat = sm.lateral_frequencies_hz()
        lam = (2 * np.pi * lat) ** 2
        splits = [abs(lam[i + 1] - lam[i]) / lam[i] for i in (0, 2)]
        allowed = [1e3 * EPS * lam_max / lam[i] for i in (0, 2)]
        log(f"   {label}: {len(sm.mesh.cells['line'])} elements, {secs:.3f} s; lateral "
            f"{lat[:4].round(6).tolist()} Hz; whirl-pair splits {splits} against "
            f"1e3 eps lam_max / lam = {allowed} (lam_max / lam_1 = {lam_max / lam[0]:.3e}); "
            f"launches {launches}")
        check(all(sp <= al for sp, al in zip(splits, allowed)), f"{label} whirl pairs split")
        check(np.allclose(sm.critical_speeds_rpm, 60.0 * lat, rtol=1e-15), "critical speeds")
        if label == "fixture":
            for n, i in ((1, 0), (2, 2)):
                eb = eb_lateral_hz(n, 2.0, 0.04)
                check(abs(lat[i] / eb - 1) <= 0.01, f"pair {n} off Euler-Bernoulli {eb}")
        out[label] = {"s": secs, "whirl_splits": splits, "allowed": allowed,
                      "lam_max_over_lam1": lam_max / lam[0], "lateral_hz": lat[:4].tolist(),
                      "analysis": sm}
    return out


CANTILEVER_2D = dict(L=1.0, H=0.2, t=0.01, P=-1000.0)


def plane_cantilever(femx_torch, cells, device):
    """The README's plane cantilever (README.md:282-285) at `cells`, through
    rect_tri6_from_cells: left edge clamped, 1 kN down on the right edge."""
    from femx_torch.mesh.generators2d import rect_tri6_from_cells

    c = CANTILEVER_2D
    mesh = rect_tri6_from_cells(cells, (c["L"] / cells[0], c["H"] / cells[1]))
    return femx_torch.PlaneAnalysis(
        mesh, [{"group": "right", "force_x": 0.0, "force_y": c["P"]}],
        [{"group": "left", "fix_x": 0, "fix_y": 0}], E=E, v=NU, thickness=c["t"],
        verbose=False, device=device)


def mg_launches(info):
    """take_rows launches of a 2D product's run with an MG-PCG solve: one
    operator apply up front and one per iteration, applies_per_cycle for
    each V-cycle (up front and per iteration), and one gather after the
    solve (the plane's reactions, the pipe's stresses)."""
    it = info["iterations"]
    return it + 2 + info["applies_per_cycle"] * (it + 1)


def plane_flagship(torch, femx_torch, bench):
    """Phase 16(a): the plane cantilever at 1024 x 256 cells (2,102,274 DOF,
    six levels) through PlaneAnalysis, f64 MG-PCG at cg_tol 1e-10: at most
    25 iterations and within 3 of the port's CPU run at 256 x 64 cells, tip
    deflection within 3 % of Timoshenko beam theory, equilibrium <= 1e-8
    |F|, take_rows launches as counted; then the solve profiled once."""
    c = CANTILEVER_2D
    pa = plane_cantilever(femx_torch, PLANE_CELLS, DEVICE)
    check(pa.ndof == lattice_ndof(PLANE_CELLS), f"{pa.ndof} DOF")
    torch.cuda.reset_peak_memory_stats()
    launches, secs, _ = counted(torch, pa.run_simulation)
    info = pa.solve_info
    log(f"   run_simulation {secs:.3f} s, stages {json.dumps(pa.stage_times)}")
    log(f"   solve_info {info}")
    check(info["method"] == "mg_pcg_2d"
          and (PLANE_CELLS != (1024, 256) or len(info["mg_levels"]) == 6), info["method"])
    want = {"take_rows/float64": mg_launches(info)}
    log(f"   launch check: expect {want}, got {launches}")
    check(launches == want, "plane launch count mismatch")
    cpu = plane_cantilever(femx_torch, PLANE_CPU_CELLS, "cpu")
    cpu.run_simulation()
    it, it_cpu = info["iterations"], cpu.solve_info["iterations"]
    log(f"   iterations: card {it} at {PLANE_CELLS}, CPU {it_cpu} at {PLANE_CPU_CELLS} cells")
    check(info["converged"] and it <= 25 and abs(it - it_cpu) <= 3, "plane iterations")
    I, A = c["t"] * c["H"] ** 3 / 12.0, c["t"] * c["H"]
    G = E / (2 * (1 + NU))
    delta_beam = abs(c["P"]) * c["L"] ** 3 / (3 * E * I) + abs(c["P"]) * c["L"] / (5 / 6 * G * A)
    pts = pa.points
    tip = np.where((np.abs(pts[:, 0] - c["L"]) < 1e-12)
                   & (np.abs(pts[:, 1] - c["H"] / 2) < 1e-12))[0][0]
    delta = abs(pa.u.reshape(-1, 2)[tip, 1])
    eq = float(np.linalg.norm(pa.equilibrium_residual()) / abs(c["P"]))
    log(f"   tip deflection {delta:.6e} m, Timoshenko {delta_beam:.6e} m (rel "
        f"{delta / delta_beam - 1:.4e}); equilibrium {eq:.3e} |F|")
    check(abs(delta / delta_beam - 1) <= 0.03, "tip deflection off beam theory")
    check(eq <= 1e-8, f"plane equilibrium {eq}")
    _, t_stress, _ = counted(torch, pa.compute_stresses)
    check(np.all(np.isfinite(pa.von_mises)), "von Mises not finite")
    t_solve = info["solve_s"]
    t_prof, device_ms, events = bench.profiled(pa.solve, torch.device(DEVICE))
    idle = 1 - device_ms / (t_prof * 1e3)
    log(f"   compute_stresses {t_stress:.3f} s; profiled solve {t_prof:.3f} s wall, "
        f"{device_ms:.1f} ms device -> idle {100 * idle:.1f} %; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
    top = sorted((e for e in events if str(e.device_type).endswith("CUDA")),
                 key=lambda e: -e.self_device_time_total)[:6]
    log("   device time by kernel: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}" for e in top))
    return {"launches": launches, "run_simulation_s": secs, "solve_s": t_solve,
            "iterations": it, "cpu_iterations": it_cpu, "stage_times": pa.stage_times,
            "tip_rel": delta / delta_beam - 1, "equilibrium": eq,
            "profiled_solve_s": t_prof, "device_ms": device_ms, "idle_share": idle,
            "peak_device_bytes": torch.cuda.max_memory_allocated(), "analysis": pa}


def plane_dense_modal(torch, femx_torch):
    """Phase 16(b): a 2,898-DOF plane cantilever (80 x 4 cells, L/H = 20)
    through the dense route and modal(n_modes=6): bending modes 1-2 within 2
    % of Euler-Bernoulli, the axial mode within 1 % of the fixed-free bar
    (tests/test_plane_analysis.py:225-255)."""
    from femx_torch.mesh.generators2d import rect_tri6

    L, H, t, rho = 1.0, 0.05, 0.01, 7850.0
    pa = femx_torch.PlaneAnalysis(rect_tri6(L, H, 1.0 / 80), [],
                                  [{"group": "left", "fix_x": 0, "fix_y": 0}], E=E, v=NU,
                                  thickness=t, verbose=False, device=DEVICE)
    launches, secs, _ = counted(torch, pa.run_simulation)
    check(pa.solve_info["method"] == "dense_cholesky" and pa.ndof <= 6000, "dense route")
    _, t_modal, res = counted(torch, lambda: pa.modal(n_modes=6, rho=rho))
    f = res.omega.cpu().numpy() / (2 * np.pi)
    I, A = t * H**3 / 12, t * H

    def eb(beta):
        return beta**2 / (2 * np.pi) * np.sqrt(E * I / (rho * A * L**4))

    f_axial = np.sqrt(E / rho) / (4 * L)
    log(f"   {pa.ndof} DOF: run_simulation {secs:.3f} s, modal {t_modal:.3f} s; f "
        f"{f.round(4).tolist()} Hz; EB {eb(1.8751):.4f}, {eb(4.69409):.4f}; axial "
        f"{f_axial:.4f}; launches {launches}")
    check(abs(f[0] / eb(1.8751) - 1) < 0.02 and abs(f[1] / eb(4.69409) - 1) < 0.02,
          "bending modes off Euler-Bernoulli")
    check(np.abs(f / f_axial - 1).min() < 0.01, "no axial mode")
    return {"launches": launches, "s": secs, "modal_s": t_modal, "f_hz": f.tolist(),
            "analysis": pa}


def radial_fd_reference(a, b, v, alpha, Ti, To, pi=0.0, N=2001):
    """Plane-strain radial thermoelastic BVP by finite differences
    (tests/test_pipe_thermal.py:18-53): (r, u, sigma_rr, sigma_tt)."""
    lam = E * v / ((1 + v) * (1 - 2 * v))
    mu = E / (2 * (1 + v))
    beta = alpha * E / (1 - 2 * v)
    r = np.linspace(a, b, N)
    h = r[1] - r[0]
    T = Ti + (To - Ti) * np.log(r / a) / np.log(b / a)
    dT = ((To - Ti) / np.log(b / a)) / r
    A = np.zeros((N, N))
    rhs = np.zeros(N)
    c = lam + 2 * mu
    for i in range(1, N - 1):
        A[i, i - 1] = c * (1 / h**2 - 1 / (2 * h * r[i]))
        A[i, i] = c * (-2 / h**2 - 1 / r[i] ** 2)
        A[i, i + 1] = c * (1 / h**2 + 1 / (2 * h * r[i]))
        rhs[i] = beta * dT[i]
    A[0, 0] = c * (-3 / (2 * h)) + lam / a
    A[0, 1] = c * (4 / (2 * h))
    A[0, 2] = c * (-1 / (2 * h))
    rhs[0] = beta * T[0] - pi
    A[-1, -1] = c * (3 / (2 * h)) + lam / b
    A[-1, -2] = c * (-4 / (2 * h))
    A[-1, -3] = c * (1 / (2 * h))
    rhs[-1] = beta * T[-1]
    u = np.linalg.solve(A, rhs)
    du = np.gradient(u, r, edge_order=2)
    return r, u, c * du + lam * u / r - beta * T, lam * du + c * u / r - beta * T


def pipe_cases(torch, femx_torch):
    """Phase 16(c): PipeThermalAnalysis(0.05, 0.08, length=0.3) at n_r=64,
    n_z=512 (264,450 DOF, axisymmetric MG-PCG), with 5 MPa internal pressure
    only, against the Lame solution, then with T 200 -> 50 K, against the
    radial ODE (tests/test_pipe_thermal.py's tolerances)."""
    a, b, v, alpha = 0.05, 0.08, NU, 1.2e-5
    out = {}
    for label, kw in (("pressure", dict(pressure_inner=5e6)),
                      ("thermal", dict(T_inner=200.0, T_outer=50.0))):
        pt = femx_torch.PipeThermalAnalysis(a, b, length=0.3, E=E, v=v, alpha=alpha,
                                            n_r=PIPE_CELLS[0], n_z=PIPE_CELLS[1],
                                            verbose=False, device=DEVICE, **kw)
        check(pt.ndof == lattice_ndof(PIPE_CELLS), f"{pt.ndof} DOF")
        launches, secs, _ = counted(torch, pt.run_simulation)
        info = pt.solve_info
        want = {"take_rows/float64": mg_launches(info)}
        log(f"   {label}: run_simulation {secs:.3f} s, solve_info {info}; launches {launches}, "
            f"expect {want}")
        check(info["method"] == "mg_pcg_2d" and info["converged"], "pipe route")
        check(launches == want, "pipe launch count mismatch")
        radii, u_r = pt.radial_profile(pt.u[0::2])
        _, s_rr = pt.radial_profile(pt.stress_nodes[:, 0])
        _, s_tt = pt.radial_profile(pt.stress_nodes[:, 2])
        inner = slice(2, -2)
        if label == "pressure":
            p = 5e6
            A_ = p * a**2 / (b**2 - a**2)
            B_ = p * a**2 * b**2 / (b**2 - a**2)
            rr_want, tt_want = A_ - B_ / radii**2, A_ + B_ / radii**2
            u_want = (1 + v) / E * ((1 - 2 * v) * A_ * radii + B_ / radii)
            errs = (float(np.abs(s_rr - rr_want)[inner].max() / p),
                    float(np.abs(s_tt - tt_want)[inner].max() / p),
                    float(abs(s_tt[0] / tt_want[0] - 1)),
                    float(np.abs(u_r / u_want - 1).max()))
            log(f"   Lame: interior s_rr {errs[0]:.3e} p, s_tt {errs[1]:.3e} p, bore hoop rel "
                f"{errs[2]:.3e}, u_r rel {errs[3]:.3e}")
            check(errs[0] < 4e-3 and errs[1] < 4e-3 and errs[2] < 0.01 and errs[3] < 1e-4,
                  "pipe off Lame")
        else:
            r_fd, u_fd, rr_fd, tt_fd = radial_fd_reference(a, b, v, alpha, 200.0, 50.0)
            scale = np.abs(tt_fd).max()
            errs = (float(np.abs(u_r / np.interp(radii, r_fd, u_fd) - 1).max()),
                    float(np.abs(s_rr - np.interp(radii, r_fd, rr_fd))[inner].max() / scale),
                    float(np.abs(s_tt - np.interp(radii, r_fd, tt_fd))[inner].max() / scale))
            log(f"   radial ODE: u_r rel {errs[0]:.3e}, interior s_rr {errs[1]:.3e}, s_tt "
                f"{errs[2]:.3e} of the peak thermal stress")
            check(errs[0] < 2e-4 and errs[1] < 5e-3 and errs[2] < 5e-3, "pipe off the radial ODE")
        out[label] = {"launches": launches, "s": secs, "iterations": info["iterations"],
                      "solve_s": info["solve_s"], "errors": errs, "analysis": pt}
    return out


def tri6_rows(torch, pa, mem_tb):
    """Phase 16(d): take_rows at the plane flagship's element gather (table
    (n_nodes, 2), index conn (E, 6)), f32 and f64, against its plain version
    (exact) and timed beside index_select, with its bytes bound; and the
    share of one f64 operator apply it takes."""
    idx = pa.operator.conn
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(pa.ndof), device=DEVICE)
    apply_ms = cuda_ms(lambda: pa.operator.apply(u))
    flat64 = idx.reshape(-1).long()
    rng = np.random.default_rng(3)
    rows = {}
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        tab = torch.as_tensor(rng.standard_normal((pa.num_nodes, 2)).astype(dt), device=DEVICE)
        k = GATHER.take_rows(tab, idx)
        p = GATHER.take_rows_plain(tab, idx)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        check(err == 0.0, f"take_rows disagrees with plain at the Tri6 gather ({name})")
        item = np.dtype(dt).itemsize
        nbytes = tab.numel() * item + idx.numel() * 4 + k.numel() * item
        row = dict(shape=f"u2 {tuple(tab.shape)}[conn {tuple(idx.shape)}]", max_abs_err=err,
                   ms=cuda_ms(lambda: GATHER.take_rows(tab, idx)),
                   plain_ms=cuda_ms(lambda: GATHER.take_rows_plain(tab, idx)),
                   library_ms=cuda_ms(lambda: torch.index_select(tab, 0, flat64)),
                   bound_ms=nbytes / (mem_tb * 1e12) * 1e3, bound_by="bytes", bytes=nbytes)
        log(f"   take_rows {name} {row['shape']}: kernel {row['ms']:.5f} ms, plain "
            f"{row['plain_ms']:.5f} ms, index_select {row['library_ms']:.5f} ms; bytes bound "
            f"{row['bound_ms']:.5f} ms ({nbytes / 1e6:.1f} MB, share "
            f"{100 * row['bound_ms'] / row['ms']:.0f} %)")
        rows[name] = row
    log(f"   one f64 apply of the plane operator at {tuple(idx.shape)} elements: "
        f"{apply_ms:.4f} ms (take_rows f64 {rows['float64']['ms']:.4f} ms of it)")
    rows["float64"]["apply_ms"] = apply_ms
    return rows


def graph_device_ms(torch, fn, inner=10, reps=25):
    """Device time of one call of fn: a CUDA graph captures `inner` calls;
    each sample replays it behind a spin kernel long enough that the host has
    queued the replay before the card reaches it; median over `reps` of the
    replay's time / inner."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of spinning ahead of the events
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1) / inner)
    return statistics.median(samples)


def host_us(torch, fn, calls=2000):
    """The host's time to issue one call of fn (microseconds, mean of
    `calls` back to back; the card keeps up with calls this small)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


# -- phases 17-18: the host surface and the conv-form structured apply --------
# FP64 outside the tensor cores (NVIDIA data sheets, dense): cuDNN's float64
# convolution is not known to use DMMA, so its bound is taken at this rate.
FP64_VECTOR = {"H100 SXM": 34.0, "H100 PCIe": 25.6}
_PNG = b"\x89PNG\r\n\x1a\n"


def flagship_cli_args(out_dir):
    """`femx_torch solid` on phase 6's box, loads and fixes, with stresses,
    a .docx report and the HTML viewer written to out_dir."""
    args = ["solid", "--box", "0.4", "0.4", "1.6", "--mesh-size", repr(H), "--E", repr(E),
            "--nu", repr(NU), "--force", "0,-1000,0@0.2,0.4,1.6"]
    for x, y, z in CORNERS_FLAGSHIP:
        args += ["--fix", f"{x},{y},{z}:xyz"]
    return args + ["--stress", "--report", os.path.join(out_dir, "flagship_report.docx"),
                   "--html", os.path.join(out_dir, "flagship.html")]


def docx_text(path):
    """word/document.xml of a .docx (a valid zip, or this raises)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        check(z.testzip() is None, f"{path}: corrupt zip member")
        return z.read("word/document.xml").decode()


def cli_flagship(torch, femx_torch, R_flagship, out_dir):
    """Phase 17(a): femx_torch.cli.main on phase 6's 1,390,179-DOF box with
    --stress --report .docx --html, on the card by default (the CLI's
    float64: f64 MG-PCG at cg_tol 1e-10). The analysis the CLI builds is
    recorded (a subclass that also times its report, viewer and stress
    calls); its launches counted, its corner reactions held to phase 6's to
    1e-6 of the load, its equilibrium, and the .docx opened."""
    from unittest import mock

    import femx_torch.analysis
    from femx_torch import cli

    made = []
    base = femx_torch.analysis.SolidReactionAnalysis

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.host_times = {}
            made.append(self)

        def _timed(self, key, fn, *a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.host_times[key] = time.perf_counter() - t0
            return out

        def compute_stresses(self):
            return self._timed("compute_stresses_s", super().compute_stresses)

        def generate_report(self, filename="FEM_Report.md"):
            return self._timed("report_s", super().generate_report, filename)

        def export_html(self, filename="fem_result.html", factor=1.0):
            return self._timed("html_s", super().export_html, filename, factor)

    args = flagship_cli_args(out_dir)
    with mock.patch.object(femx_torch.analysis, "SolidReactionAnalysis", Recorded):
        launches, secs, rc = counted(torch, lambda: cli.main(args))
    check(rc == 0 and len(made) == 1, f"cli.main returned {rc}")
    fa = made[0]
    info = fa.solve_info
    check(fa.device.type == "cuda", f"the CLI ran on {fa.device}")
    check(info["method"] == "structured_multigrid_pcg" and info["converged"], str(info))
    it, levels = info["iterations"], len(fa._precond.levels)
    want = add_launches({f"{SCM}/float64": it + 2},
                        vcycle_launches(5 * (levels - 1), it + 1, dtype="float64"))
    log(f"   cli.main {secs:.3f} s; solve_info {info}")
    log(f"   stage_times {json.dumps(fa.stage_times)}; host {json.dumps(fa.host_times)}")
    log(f"   launch check: {it} iterations, {levels} levels -> expect {want}, got {launches}")
    check(launches == want, "CLI flagship launch count mismatch")
    R = corner_reactions(fa)
    eq = fa.equilibrium_residual()
    dR = float(np.abs(R - R_flagship).max())
    log(f"   corner reactions {R.tolist()}; max |R - R(phase 6)| {dR:.3e} N; equilibrium "
        f"{eq.tolist()}")
    check(dR <= 1e-6 * 1000.0, "CLI corner reactions differ from phase 6's")
    check(np.linalg.norm(eq) <= 1e-6 * 1000.0, f"CLI equilibrium {eq}")
    doc = docx_text(os.path.join(out_dir, "flagship_report.docx"))
    check("Total Reaction" in doc and "Stress Results (von Mises, nodal-averaged)" in doc,
          "the .docx lacks the reaction table or the stress section")
    check(doc.count("<w:tr>") >= 1 + 4 + 1, "reaction table rows")
    html_bytes = os.path.getsize(os.path.join(out_dir, "flagship.html"))
    vm_max = float(np.max(fa.nodal_von_mises))
    log(f"   report {fa.host_times['report_s']:.3f} s, HTML {fa.host_times['html_s']:.3f} s, "
        f"{html_bytes} bytes; max von Mises {vm_max / 1e6:.4f} MPa")
    return {"launches": launches, "s": secs, "iterations": it, "levels": levels,
            "stage_times": dict(fa.stage_times), "host_times": dict(fa.host_times),
            "solve_s": info["solve_s"], "html_bytes": html_bytes, "reaction_diff_n": dR}


def write_reports(torch, out_dir, solved):
    """Phase 17(b): .md and .docx reports of analyses phases 5, 15 and 16
    solved (no new solve: a report launches at most the stress recovery
    of an analysis that has none yet); images are phase 17(d)'s. Each
    report's file opens and holds its product's result section."""
    from femx_torch import report

    writers = {
        "solid_default": (lambda p: report.solid_report(solved["solid_default"], p, image=False),
                          "Reaction Force Results"),
        "building_frame": (lambda p: report.beam_report(*solved["building_frame"], p,
                                                        plots=False),
                           "3. Modal Analysis Results"),
        "shaft_stepped": (lambda p: report.shaft_report(solved["shaft_stepped"], p, image=False),
                          "Modal Results"),
        "plane_flagship": (lambda p: report.plane_report(solved["plane_flagship"], p,
                                                         image=False),
                           "Stress Results (von Mises, nodal recovery)"),
        "plane_dense": (lambda p: report.plane_report(solved["plane_dense"], p, image=False),
                        "Modal Analysis Results"),
        "pipe_thermal": (lambda p: report.pipe_report(solved["pipe_thermal"], p, image=False),
                         "Bore (inner)"),
    }
    out = {}
    for label, (write, section) in writers.items():
        times, launches = {}, {}
        for ext in ("md", "docx"):
            path = os.path.join(out_dir, f"{label}.{ext}")
            launches[ext], times[ext], _ = counted(torch, lambda: write(path))
            text = open(path).read() if ext == "md" else docx_text(path)
            check(section in text, f"{label}.{ext} lacks {section!r}")
        out[label] = {"md_s": times["md"], "docx_s": times["docx"], "launches": launches,
                      "md_bytes": os.path.getsize(os.path.join(out_dir, f"{label}.md"))}
        log(f"   {label}: {json.dumps(out[label])}")
    return out


_LAUNCH_RUNNER = r"""
import json, runpy, sys
from femx_torch import gather
from femx_torch.elements import cell_matmul as cm
code = 0
try:
    runpy.run_module("femx_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
counts = {f"structured_cell_matmul/{k}": v for k, v in cm.LAUNCHES.items() if v}
counts.update((k, v) for k, v in gather.LAUNCHES.items() if v)
print("LAUNCHES " + json.dumps(counts))
sys.exit(code)
"""


def cli_subprocesses(torch, R_default, out_dir):
    """Phase 17(c): `python -m femx_torch` in subprocesses, on the card by
    default: mesh-box then solid --msh on the README default box (TG +
    block-Jacobi, f64; run through runpy so the process can print its
    launch counts: take_rows must have launched; reactions held to phase
    5's to the printed precision), and shaft, plane (MG route), pipe and
    section (warping FEM) with --json, started together."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    msh = os.path.join(out_dir, "default_box.msh")
    fixes = [f"{x},0,{z}" for x, z in CORNERS_DEFAULT]
    mesh_box = ["mesh-box", "--dims", "0.8", "0.2", "0.8", "--mesh-size", "0.05",
                "--force", "0,3000,0@0.4,0.2,0.4", *sum((["--fix", f] for f in fixes), []),
                "-o", msh]
    solid = ["solid", "--msh", msh, "--E", "2e11", "--nu", "0.3",
             "--force", "0,3000,0@0.4,0.2,0.4", *sum((["--fix", f + ":xyz"] for f in fixes), [])]
    jobs = {
        "shaft": ["shaft", "--segment", "2.0,0.04", "--bearing", "0", "--bearing", "2",
                  "--E", "2e11", "--nu", "0.3", "--json"],
        "plane": ["plane", "--plate", "1.0", "0.2", "--mesh-size", "0.0025", "--E", "2e11",
                  "--nu", "0.3", "--thickness", "0.01", "--force-edge", "right=0,-1000",
                  "--fix-edge", "left", "--json"],
        "pipe": ["pipe", "--ri", "0.05", "--ro", "0.08", "--E", "2e11", "--nu", "0.3",
                 "--Ti", "200", "--To", "50", "--pi", "5e6", "--nr", "32", "--nz", "128",
                 "--json"],
        "section": ["section", "--type", "I section", "--params",
                    "d=0.05,b=0.025,t_w=0.005,t_f=0.005,r=0.001", "--method", "fem"],
    }

    def start(cmd, runner=False):
        head = ([sys.executable, "-c", _LAUNCH_RUNNER] if runner
                else [sys.executable, "-m", "femx_torch"])
        return time.perf_counter(), subprocess.Popen(head + cmd, cwd=out_dir, env=env,
                                                     stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True)

    def finish(label, job):
        t0, proc = job
        out, err = proc.communicate(timeout=600)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"femx_torch {label} exited {proc.returncode}:\n"
              f"{out[-3000:]}\n{err[-3000:]}")
        return secs, out

    running = {k: start(v) for k, v in jobs.items()}
    out = {}
    secs, text = finish("mesh-box", start(mesh_box))
    log(f"   mesh-box {secs:.3f} s: {text.strip()}")
    secs, text = finish("solid --msh", start(solid, runner=True))
    counts = json.loads(text.split("LAUNCHES ")[1])
    R = np.array(re.findall(r"Rx=(\S+), Ry=(\S+), Rz=(\S+) N", text), dtype=float)
    dR = float(np.abs(R - R_default).max() / np.abs(R_default).max())
    log(f"   solid --msh {secs:.3f} s, launches {counts}; reactions vs phase 5 rel {dR:.3e}")
    check(counts.get("take_rows/float64", 0) > 0, "solid --msh launched no take_rows")
    check(R.shape == (4, 3) and dR <= 1e-4, "solid --msh reactions differ from phase 5's")
    out["solid_msh"] = {"s": secs, "launches": counts, "reaction_rel": dR}
    for label in jobs:
        secs, text = finish(label, running[label])
        payload = json.loads(text.strip().splitlines()[-1])
        log(f"   {label} {secs:.3f} s: " + json.dumps(
            {k: v for k, v in payload.items() if k not in ("radii", "hoop_profile_mpa")})[:600])
        if label == "shaft":  # the pinned-pinned demo shaft: first critical ~1187.8 RPM
            ok = abs(payload["critical_speeds_rpm"][0] / 1187.8 - 1) <= 1e-3
        elif label == "plane":
            ok = (payload["solve_info"]["method"].startswith("mg_pcg_2d")
                  and np.abs(payload["equilibrium_residual"]).max() <= 1e-8 * 1000.0)
        elif label == "pipe":
            ok = np.isfinite(payload["max_von_mises_mpa"]) and payload["max_von_mises_mpa"] > 0
        else:
            ok = payload["J"] > 0 and 0 < payload["kappa_y"] <= 1 and payload["A"] > 0
        check(ok, f"femx_torch {label}: {payload}")
        out[label] = {"s": secs}
    return out


def host_plots(torch, out_dir, solved):
    """Phase 17(d): every product's plot, when matplotlib is installed."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        log("   matplotlib: absent")
        return None
    from femx_torch.viz import save_beam_modal_plot, save_beam_static_plot
    from femx_torch.viz_sections import plot_extruded_sections

    ba, res = solved["building_frame"]
    plots = {
        "solid_default": lambda p: solved["solid_default"].plot(show_window=False, filename=p),
        "solid_default_vm": lambda p: solved["solid_default"].plot(
            show_window=False, filename=p, color="von_mises"),
        "building_static": lambda p: save_beam_static_plot(ba, res, p),
        "building_mode1": lambda p: save_beam_modal_plot(ba, res, 1, p),
        "building_sections": lambda p: plot_extruded_sections(ba.mesh, ba.section_data,
                                                              filename=p),
        "shaft_mode1": lambda p: solved["shaft_stepped"].plot_mode(1, p),
        "plane_dense": lambda p: solved["plane_dense"].plot(p),
        "pipe_thermal": lambda p: solved["pipe_thermal"].plot(p),
    }
    out = {}
    for label, draw in plots.items():
        path = os.path.join(out_dir, f"{label}.png")
        _, secs, _ = counted(torch, lambda: draw(path))
        with open(path, "rb") as f:
            check(f.read(8) == _PNG, f"{label}: not a PNG")
        out[label] = secs
    log(f"   plots (s): {json.dumps(out)}")
    return out


def kernels_per_call(torch, fn, calls=20):
    """(device kernels, their summed device ms) per call of fn: `calls`
    calls under one torch.profiler session, after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in events) / calls,
            sum(e.self_device_time_total for e in events) / 1e3 / calls)


def conv_apply_rows(torch, part, peaks):
    """Phase 18(a): at 24x24x96 cells, float32 and float64, the conv-form
    apply (cuDNN, TF32 off) against the slot apply with the cell kernel:
    max difference over max value, CUDA-event ms of both in turns (slot,
    conv, conv, slot; back-to-back applies, so the host's launches bound
    them), device kernels and their summed device time per apply (20
    profiled applies), the full 24-channel correlation alone, and its
    bound."""
    import torch.nn.functional as F

    from femx_torch.assembly_conv import conv_kernels
    from femx_torch.assembly_structured import StructuredSolidOperator, conv_routing_active

    out = {}
    nx, ny, nz = FLAGSHIP
    ext = (nx + 1, ny + 1, nz + 1)
    flops = 2.0 * 24 * 24 * 27 * ext[0] * ext[1] * ext[2]
    for dt, name in ((np.float32, "float32"), (np.float64, "float64")):
        ops = {form: StructuredSolidOperator.from_lattice(
            FLAGSHIP, (H, H, H), E, NU, dtype=dt, device=DEVICE, apply_form=form)
            for form in ("slot", "conv")}
        check(conv_routing_active(ops["conv"]) and not conv_routing_active(ops["slot"]),
              "routing at 24x24x96")
        rng = np.random.default_rng(18)
        u = torch.as_tensor(rng.standard_normal(ops["slot"].ndof).astype(dt), device=DEVICE)
        slot, conv = ops["slot"].apply(u), ops["conv"].apply(u)
        torch.cuda.synchronize()
        rel = float((conv - slot).abs().max() / slot.abs().max())
        check(rel <= TOL[name], f"conv vs slot {name}: {rel}")
        ms = {"slot": [], "conv": []}
        for form in ("slot", "conv", "conv", "slot"):
            ms[form].append(cuda_ms(lambda: ops[form].apply(u)))
        per_apply = {}
        for form, op in ops.items():
            scm, _, _ = counted(torch, lambda: op.apply(u))
            kernels, kernel_ms = kernels_per_call(torch, lambda: op.apply(u))
            per_apply[form] = {"device_kernels": kernels, "device_kernel_ms": kernel_ms,
                               "cell_kernel": int(scm.get(f"{SCM}/{name}", 0))}
        check(per_apply["conv"]["cell_kernel"] == 0 and per_apply["slot"]["cell_kernel"] == 1,
              f"cell kernel launches per apply {per_apply}")
        full, _ = conv_kernels(ops["conv"], u.dtype, u.device)
        U = torch.as_tensor(rng.standard_normal((1, 24) + ext).astype(dt), device=DEVICE)
        full_ms = cuda_ms(lambda: F.conv3d(U, full, padding=1))
        peak = peaks[0] if name == "float32" else FP64_VECTOR[part]
        nbytes = 2 * 24 * ext[0] * ext[1] * ext[2] * np.dtype(dt).itemsize
        bound_ms = max(flops / (peak * 1e12), nbytes / (peaks[2] * 1e12)) * 1e3
        out[name] = {"max_diff_over_max": rel,
                     "slot_ms": statistics.median(ms["slot"]),
                     "conv_ms": statistics.median(ms["conv"]), "turns_ms": ms,
                     "full_correlation_ms": full_ms, "correlation_bound_ms": bound_ms,
                     "correlation_gflop": flops / 1e9, "per_apply": per_apply}
        log(f"   {name}: {json.dumps(out[name])}")
    return out


def flagship_conv(torch, femx_torch, it6, R_flagship, warm6, warm_runs=3):
    """Phase 18(b): phase 6's analysis with structured_apply="conv": the fine
    level (55,296 cells) and the f64 CG operator route conv, the coarser
    levels keep the cell kernel. Iterations within 1 of phase 6's, corner
    reactions within 1e-7 relative, launches as counted, and the warm solve
    time beside phase 6's."""
    mesh = femx_torch.box_tet10(0.4, 0.4, 1.6, mesh_size=H, force_points=[(0.2, 0.4, 1.6)],
                                fix_points=CORNERS_FLAGSHIP)
    force = [{"force_x": 0.0, "force_y": -1000.0, "force_z": 0.0,
              "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 1.6}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in CORNERS_FLAGSHIP]
    fa = femx_torch.SolidReactionAnalysis(mesh, force, fix, E=E, v=NU, dtype=np.float32,
                                          cg_tol=1e-8, verbose=False, device=DEVICE,
                                          structured_apply="conv")
    launches, t_run, _ = counted(torch, fa.run_simulation)
    info = fa.solve_info
    it, levels = info["iterations"], len(fa._precond.levels)
    log(f"   first run_simulation {t_run:.3f} s; solve_info {info}")
    check(info["structured_apply"] == "conv" and info["converged"], str(info))
    check(abs(it - it6) <= 1, f"{it} iterations against phase 6's {it6}")
    # the f64 CG operator and the fine V-cycle level apply by convolution;
    # the levels below the fine one and above the coarsest launch the kernel
    want = add_launches(vcycle_launches(5 * (levels - 2), it + 1))
    log(f"   launch check: expect {want}, got {launches}")
    check(launches == want, "conv flagship launch count mismatch")
    R = corner_reactions(fa)
    rel = rel_diff(R, R_flagship)
    eq = fa.equilibrium_residual()
    log(f"   corner reactions rel to phase 6 {rel:.3e}; equilibrium {eq.tolist()}")
    check(rel <= 1e-7 and np.linalg.norm(eq) <= 1e-6 * 1000.0, "conv flagship reactions")
    runs = []
    for _ in range(warm_runs):
        t, _ = wall_s(fa.run_simulation)
        runs.append({"run_simulation_s": t, "solve_s": fa.solve_info["solve_s"],
                     "iterations": fa.solve_info["iterations"]})
    warm = {"run_simulation_s": statistics.median(r["run_simulation_s"] for r in runs),
            "solve_s": statistics.median(r["solve_s"] for r in runs), "runs": runs,
            "slot_run_simulation_s": warm6["run_simulation_s"], "slot_solve_s": warm6["solve_s"]}
    log(f"   warm (median of {warm_runs}), conv beside phase 6's slot: {json.dumps(warm)}")
    return {"launches": launches, "iterations": it, "reaction_rel": rel, **warm}


# -- phase 19: the distributed paths (femx_torch.parallel) --------------------
# N ranks on the one card (gloo on CUDA tensors: NCCL refuses two ranks on
# one GPU), so every time here is the cost of decomposing on one card, not a
# scaling. Each rank zeroes its launch counts before each path and reads
# them after (counts are per process).
DIST_RANKS = 4  # (a)-(c), (e)
PAD_RANKS = 5  # (d): 96 -> 100 cells
SMALL_CELLS = (8, 8, 32)  # (f), (g): the flagship box at mesh_size 0.05
SMALL_H = 0.05
DIST_TIMEOUT = 600


def flagship_problem(femx_torch, h=H):
    """Phase 6's corner-fixed box with the tip load, at cell size h."""
    mesh = femx_torch.box_tet10(0.4, 0.4, 1.6, mesh_size=h, force_points=[(0.2, 0.4, 1.6)],
                                fix_points=CORNERS_FLAGSHIP)
    force = [{"force_x": 0.0, "force_y": -1000.0, "force_z": 0.0,
              "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 1.6}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in CORNERS_FLAGSHIP]
    return mesh, force, fix


class _CollectiveCount:
    """Counts the torch.distributed collectives a rank calls inside the
    block (all_reduce, all_gather, reduce_scatter_tensor)."""

    NAMES = ("all_reduce", "all_gather", "reduce_scatter_tensor")

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.saved, self.counts = dist, {}, dict.fromkeys(self.NAMES, 0)
        for n in self.NAMES:
            fn = getattr(dist, n)
            self.saved[n] = fn

            def wrapped(*a, _fn=fn, _n=n, **k):
                self.counts[_n] += 1
                return _fn(*a, **k)

            setattr(dist, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.dist, n, fn)


def _rank_path(torch, fn):
    """In a rank: (counts, seconds, fn()) with the counts zeroed just
    before and read just after."""
    from femx_torch import gather
    from femx_torch.elements import cell_matmul

    torch.cuda.synchronize()
    cell_matmul.LAUNCHES.clear()
    gather.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = {f"{SCM}/{k}": v for k, v in cell_matmul.LAUNCHES.items() if v}
    counts.update((k, v) for k, v in gather.LAUNCHES.items() if v)
    return counts, time.perf_counter() - t0, out


def _analysis_path(torch, mesh, force, fix, kwargs, **extra):
    """One SolidReactionAnalysis(devices=N) path in a rank: its launches,
    wall, collectives, the rank's peak device memory and (rank 0 only) the
    arrays."""
    from femx_torch.parallel import comm, rank_checks

    torch.cuda.reset_peak_memory_stats()
    with _CollectiveCount() as cc:
        counts, secs, res = _rank_path(torch, lambda: rank_checks.solid_analysis(
            mesh, force, fix, kwargs, **extra))
    res["launches"], res["wall_s"], res["collectives"] = counts, secs, cc.counts
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    if comm.rank() != 0:
        for k in ("u", "reactions", "cases", "von_mises"):
            res.pop(k, None)
    return res


def rank_distributed(msh_path, u_probe, mask_probe):
    """Rank function of 19(a)-(c) and (e), 4 ranks: the collectives, the
    halo apply at 24x24x96 in float32 and float64, the structured flagship
    with devices=4, the unstructured flagship file with devices=4."""
    import torch

    import femx_torch
    from femx_torch.parallel import comm, rank_checks

    out = {"collectives": rank_checks.collectives(4099, 0, "cuda")}
    for dt in ("float32", "float64"):
        counts, secs, res = _rank_path(torch, lambda: rank_checks.structured_apply(
            FLAGSHIP, (H, H, H), mask_probe, u_probe, dt, "cuda", repeats=20))
        out[f"halo_{dt}"] = {"launches": counts, "halo_apply_s": res["halo_apply_s"],
                             **({"halo": res["halo"]} if comm.rank() == 0 else {})}
    mesh, force, fix = flagship_problem(femx_torch)
    out["flagship"] = _analysis_path(torch, mesh, force, fix, dict(
        E=E, v=NU, dtype=np.float32, cg_tol=1e-8, devices=DIST_RANKS, device=DEVICE))
    del mesh
    out["unstructured"] = _analysis_path(torch, msh_path, force, fix, dict(
        E=E, v=NU, dtype=np.float32, cg_tol=1e-8, devices=DIST_RANKS, device=DEVICE))
    return out


def rank_padded():
    """Rank function of 19(d), 5 ranks: the structured flagship with
    devices=5 (nz 96 ghost-padded to 100)."""
    import torch

    import femx_torch

    mesh, force, fix = flagship_problem(femx_torch)
    return _analysis_path(torch, mesh, force, fix, dict(
        E=E, v=NU, dtype=np.float32, cg_tol=1e-8, devices=PAD_RANKS, device=DEVICE))


def small_cases(force):
    return [force, [dict(force[0], force_x=700.0, force_y=0.0)]]


def rank_small():
    """Rank function of 19(a) and (f), 2 ranks: the collectives, and
    modal(refine=True) and solve_cases on the 8x8x32 box with devices=2."""
    import torch

    import femx_torch
    from femx_torch.parallel import rank_checks

    mesh, force, fix = flagship_problem(femx_torch, SMALL_H)
    out = {"collectives": rank_checks.collectives(4099, 0, "cuda")}
    out["small"] = _analysis_path(torch, mesh, force, fix, dict(
        E=E, v=NU, cg_tol=1e-10, devices=2, device=DEVICE), cases=small_cases(force),
        modal=dict(n_modes=3, rho=RHO, refine=True))
    return out


def _check_collectives(res, n):
    c = res["collectives"]
    for k, v in c.items():
        if "/" in k:
            lim = (1e-6 if k.endswith("float32") else 1e-14) * n
            check(v <= lim, f"{n}-rank {k} off numpy by {v}")
    return c


def _check_rank_launches(ranks, key, path, want=None):
    """Every rank launched the path's kernels (and, given want, exactly
    those counts); returns the per-rank counts for launches_by_path."""
    per = {f"{path}/rank{r.rank}": r.result[key]["launches"] for r in ranks}
    for name, counts in per.items():
        check(counts, f"{name}: no kernel launched")
        if want is not None:
            check(counts == want, f"{name}: launches {counts}, expected {want}")
    return per


def _peaks_mib(ranks, key=None):
    return [round((r.result[key] if key else r.result)["peak_device_bytes"] / 2 ** 20, 1)
            for r in ranks]


def distributed_phase(torch, femx_torch, it_flagship, R_flagship, n_levels, msh_path,
                      peak_flagship):
    """Phase 19 (see the module docstring). Every rank builds the whole
    analysis (the full operator, the slab operators and the hierarchy), so
    each rank's peak device memory is printed beside phase 6's one-device
    peak (peak_flagship, bytes)."""
    from femx_torch.assembly_structured import StructuredSolidOperator
    from femx_torch.parallel import launch

    out, paths = {}, {}
    log(" (b) inputs: a random u and the flagship's free mask; the single-device applies")
    op64 = StructuredSolidOperator.from_lattice(FLAGSHIP, (H, H, H), E, NU, dtype=np.float64,
                                                device=DEVICE)
    m3 = np.ones(op64.grid_shape + (3,))
    m3[:, :, 0] = 0.0  # the z=0 face clamped
    mask = m3.reshape(-1)
    u = np.random.default_rng(0).standard_normal(op64.ndof)
    single = {}
    for dt in ("float32", "float64"):
        op = (op64 if dt == "float64" else op64.astype(np.float32)).with_free_mask(
            op64.to_internal(mask))
        single[dt] = op.apply_constrained(torch.as_tensor(u, dtype=op.Kcell.dtype,
                                                          device=DEVICE)).cpu().numpy()
    del op64, op
    log(f" (a)-(c), (e): {DIST_RANKS} ranks on the card")
    t0 = time.perf_counter()
    ranks = launch(rank_distributed, DIST_RANKS, msh_path, u, mask, device=DEVICE,
                   timeout=DIST_TIMEOUT, all_ranks=True)
    t_launch = time.perf_counter() - t0
    r0 = ranks[0].result
    col = _check_collectives(r0, DIST_RANKS)
    log(f"   (a) collectives on CUDA tensors, {DIST_RANKS} ranks, backend "
        f"{col['backend']}: {json.dumps(col)}")
    for dt in ("float32", "float64"):
        rel = rel_diff(r0[f"halo_{dt}"]["halo"], single[dt])
        per = _check_rank_launches(ranks, f"halo_{dt}", f"dist_halo_{dt}")
        paths.update(per)
        ms = [1e3 * r.result[f"halo_{dt}"]["halo_apply_s"] for r in ranks]
        log(f"   (b) halo apply {dt} at 24x24x96 on {DIST_RANKS} ranks against phase 6's "
            f"single-device apply: rel {rel:.3e} (limit {TOL[dt]}); wall per apply "
            f"{[round(m, 3) for m in ms]} ms by rank; launches {list(per.values())}")
        check(rel <= TOL[dt], f"halo apply {dt} differs from the single-device apply")
        out[f"halo_{dt}_rel"], out[f"halo_{dt}_apply_ms"] = rel, ms

    f = r0["flagship"]
    info = f["solve_info"]
    it = info["iterations"]
    want = {f"{SCM}/float64": it + 2, f"{SCM}/float32": 5 * (n_levels - 1) * (it + 1)}
    per = _check_rank_launches(ranks, "flagship", "dist_flagship4", want)
    paths.update(per)
    R = np.array([f["reactions"][3 * n:3 * n + 3] for n in f["fixed_nodes"]])
    relR = rel_diff(R, R_flagship)
    eq = np.linalg.norm(f["equilibrium"])
    coll = {k: v / (it + 1) for k, v in f["collectives"].items()}
    log(f"   (c) flagship devices={DIST_RANKS}: solve_info {info}; stage_times "
        f"{f['stage_times']}; rank-0 wall {f['wall_s']:.3f} s; collectives per iteration "
        f"{coll}; corner reactions rel {relR:.3e} from phase 6's; |equilibrium| {eq:.3e} N; "
        f"launches per rank {want} (as counted); peak device memory by rank "
        f"{_peaks_mib(ranks, 'flagship')} MiB (one device, phase 6: "
        f"{peak_flagship / 2 ** 20:.1f} MiB)")
    check(info["devices"] == DIST_RANKS, f"devices {info['devices']}")
    check(info["converged"] and abs(it - it_flagship) <= 2,
          f"{it} iterations against phase 6's {it_flagship}")
    check(relR <= 1e-6 and eq <= 1e-6 * 1000.0, "flagship devices=4 reactions")
    out["flagship"] = {"solve_info": info, "wall_s": f["wall_s"], "stage_times": f["stage_times"],
                       "collectives_per_iteration": coll, "corner_rel": relR,
                       "peak_mib_by_rank": _peaks_mib(ranks, "flagship")}

    g = r0["unstructured"]
    ginfo = g["solve_info"]
    per = _check_rank_launches(ranks, "unstructured", "dist_unstructured4")
    paths.update(per)
    for name, counts in per.items():
        check(counts.get("take_rows/float64", 0) > 0 and counts.get("take_rows/float32", 0) > 0
              and counts.get(f"{SCM}/float32", 0) > 0, f"{name}: a kernel missing: {counts}")
    R = np.array([g["reactions"][3 * n:3 * n + 3] for n in g["fixed_nodes"]])
    relR = rel_diff(R, R_flagship)
    eq = np.linalg.norm(g["equilibrium"])
    coll = {k: v / (ginfo["iterations"] + 1) for k, v in g["collectives"].items()}
    log(f"   (e) unstructured flagship file, devices={DIST_RANKS}: solve_info {ginfo}; "
        f"stage_times {g['stage_times']}; rank-0 wall {g['wall_s']:.3f} s; collectives per "
        f"iteration {coll}; corner reactions rel {relR:.3e} from phase 6's; |equilibrium| "
        f"{eq:.3e} N; launches {list(per.values())}; peak device memory by rank "
        f"{_peaks_mib(ranks, 'unstructured')} MiB")
    check(ginfo["devices"] == DIST_RANKS and ginfo["converged"]
          and ginfo["method"] == "tg_distributed_lattice_mg_pcg_mixed", str(ginfo))
    check(relR <= 1e-6 and eq <= 1e-6 * 1000.0, "unstructured devices=4 reactions")
    out["unstructured"] = {"solve_info": ginfo, "wall_s": g["wall_s"],
                           "stage_times": g["stage_times"], "collectives_per_iteration": coll,
                           "corner_rel": relR}
    out["launch_4_s"] = t_launch

    log(f" (d) the flagship with devices={PAD_RANKS} (nz 96 -> 100)")
    t0 = time.perf_counter()
    pranks = launch(rank_padded, PAD_RANKS, device=DEVICE, timeout=DIST_TIMEOUT,
                    all_ranks=True)
    p = pranks[0].result
    pinfo = p["solve_info"]
    per = {f"dist_padded5/rank{r.rank}": r.result["launches"] for r in pranks}
    paths.update(per)
    for name, counts in per.items():
        check(counts.get(f"{SCM}/float64", 0) > 0 and counts.get(f"{SCM}/float32", 0) > 0,
              f"{name}: a kernel missing: {counts}")
    R = np.array([p["reactions"][3 * n:3 * n + 3] for n in p["fixed_nodes"]])
    relR = rel_diff(R, R_flagship)
    log(f"   solve_info {pinfo}; rank-0 wall {p['wall_s']:.3f} s (launch "
        f"{time.perf_counter() - t0:.1f} s); corner reactions rel {relR:.3e}; launches "
        f"{list(per.values())}; peak device memory by rank {_peaks_mib(pranks)} MiB")
    check(pinfo["devices"] == PAD_RANKS and pinfo["padded_nz"] == 100 and pinfo["converged"],
          str(pinfo))
    check(relR <= 1e-6, "padded flagship reactions")
    out["padded"] = {"solve_info": pinfo, "wall_s": p["wall_s"], "corner_rel": relR}

    log(" (a), (f): 2 ranks: the collectives; modal(3, refine=True) and solve_cases on "
        f"the {SMALL_CELLS} box")
    sranks = launch(rank_small, 2, device=DEVICE, timeout=DIST_TIMEOUT, all_ranks=True)
    s0 = sranks[0].result
    col2 = _check_collectives(s0, 2)
    log(f"   (a) collectives, 2 ranks: {json.dumps(col2)}")
    sm = s0["small"]
    per = {f"dist_small2/rank{r.rank}": r.result["small"]["launches"] for r in sranks}
    paths.update(per)
    for name, counts in per.items():
        check(counts.get(f"{SCM}/float64", 0) > 0, f"{name}: no cell kernel: {counts}")
    mesh, force, fix = flagship_problem(femx_torch, SMALL_H)
    check(mesh.structured.n_cells == SMALL_CELLS, str(mesh.structured.n_cells))
    ref = femx_torch.SolidReactionAnalysis(mesh, force, fix, E=E, v=NU, cg_tol=1e-10,
                                           solver="mg", verbose=False,
                                           device=DEVICE).run_simulation()
    U = ref.solve_cases(small_cases(force))
    m = ref.modal(n_modes=3, rho=RHO, refine=True)
    f_ref = m.omega.cpu().numpy() / (2 * np.pi)
    f_got = sm["omega"] / (2 * np.pi)
    rel_u, rel_c = rel_diff(sm["u"], ref.u), rel_diff(sm["cases"], U)
    rel_f = float(np.abs(f_got - f_ref).max() / f_ref.max())
    log(f"   (f) devices=2: solve_info {sm['solve_info']}; u rel {rel_u:.3e} and cases rel "
        f"{rel_c:.3e} from the single-device run (iterations {ref.solve_info['iterations']}, "
        f"cases {[c['iterations'] for c in ref.case_solve_info]}; here "
        f"{[c['iterations'] for c in sm['case_solve_info']]}); refined f {f_got.tolist()} Hz "
        f"against {f_ref.tolist()} (rel {rel_f:.3e}); Ritz bounds {sm['modal_error_bounds']}; "
        f"launches {list(per.values())}")
    check(sm["solve_info"]["devices"] == 2, str(sm["solve_info"]))
    check(rel_u <= 1e-9 and rel_c <= 1e-9 and rel_f <= 1e-6, "devices=2 modal/cases differ")
    out["small"] = {"solve_info": sm["solve_info"], "u_rel": rel_u, "cases_rel": rel_c,
                    "f_rel": rel_f, "f_hz": f_got.tolist(), "wall_s": sm["wall_s"]}

    log(" (g) python -m femx_torch solid --devices 2 on the same box")
    args = [sys.executable, "-m", "femx_torch", "solid", "--box", "0.4", "0.4", "1.6",
            "--mesh-size", str(SMALL_H), "--E", str(E), "--nu", str(NU),
            "--force", "0,-1000,0@0.2,0.4,1.6", "--devices", "2"]
    for x, y, z in CORNERS_FLAGSHIP:
        args += ["--fix", f"{x},{y},{z}:xyz"]
    t0 = time.perf_counter()
    proc = subprocess.run(args, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=DIST_TIMEOUT)
    t_cli = time.perf_counter() - t0
    rows = re.findall(r"Rx=(\S+), Ry=(\S+), Rz=(\S+) N", proc.stdout)
    R_cli = np.array(rows, dtype=float)
    R_ref = corner_reactions(ref)
    log(f"   exit {proc.returncode} in {t_cli:.1f} s; "
        f"{[ln for ln in proc.stdout.splitlines() if 'solved' in ln]}; corner reactions "
        f"{R_cli.tolist()}")
    check(proc.returncode == 0 and "System solved on 2 devices" in proc.stdout,
          f"CLI --devices 2 failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    check(R_cli.shape == (4, 3) and np.all(np.abs(R_cli - R_ref) <= 1e-4 * np.abs(R_ref)
                                           + 1e-9 * np.abs(R_ref).max()),
          "CLI reactions differ from the single-device run's to the printed digits")
    out["cli_s"] = t_cli
    return out, paths


# -- phase 20: the V-cycle's CUDA graph at full size ---------------------------
# (box dimensions in m, cells): phase 6's flagship and the benchmark's
# box1m-struct configuration (benchmark/configs/box1m-struct.json)
GRAPH_HIERARCHIES = {"flagship": ((0.4, 0.4, 1.6), FLAGSHIP),
                     "box1m": ((0.8, 0.2, 0.8), (64, 16, 64))}


def pool_bytes(torch, pool):
    """What the allocator reserves for the memory pool of id `pool`."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def eager_need(torch, multigrid, mg, r):
    """The bytes an eager V-cycle on a copy of r makes the allocator reserve
    on a new stream (whose requests no cached block serves, and which makes
    its own cuBLAS workspace, as the capture stream does): what the capture
    records, run eagerly. The stream's blocks and workspace are given back
    after."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    with torch.cuda.stream(side):
        x = torch.empty_like(r)
        x.copy_(r)
        y = mg._vcycle(0, x).contiguous()
        del x, y
    torch.cuda.synchronize()
    need = torch.cuda.memory_reserved() - before
    multigrid._clear_cublas_workspaces()
    torch.cuda.empty_cache()
    return need


def slot_rows(torch, n, mem_tb):
    """slot_copy_in and slot_copy_out at n float32 elements (the fine level's
    residual) against Tensor.copy_, aligned and one element off, and
    slot_set against a 16-byte copy from the host: CUDA-event ms of 10
    calls in a row, the device time of a replayed graph of them, and the
    bytes bound 2 n sizeof(float) / the card's bandwidth."""
    g = np.random.default_rng(21)
    slots = torch.zeros(2, dtype=torch.int64, device=DEVICE)
    buf = torch.empty(n, dtype=torch.float32, device=DEVICE)
    src = torch.as_tensor(g.standard_normal(n + 1).astype(np.float32), device=DEVICE)
    dst = torch.empty(n + 1, dtype=torch.float32, device=DEVICE)
    nb = 2 * n * 4
    rows = {}
    for kernel, lib_call, lib in (
            ("slot_copy_in", "buf.copy_(src)", lambda s, d: buf.copy_(s)),
            ("slot_copy_out", "dst.copy_(buf)", lambda s, d: d.copy_(buf))):
        fn = getattr(GATHER, kernel)
        row = dict(bytes=nb, bound_ms=nb / (mem_tb * 1e12) * 1e3, bound_by="bytes",
                   shape=f"{n} float32", library_call=lib_call)
        for off, tag in ((0, ""), (1, "offset1_")):
            s, d = src[off:off + n], dst[off:off + n]
            GATHER.slot_set(slots, s.data_ptr(), d.data_ptr())
            row[f"{tag}ms"] = cuda_ms(lambda: fn(slots, buf))
            row[f"{tag}library_ms"] = cuda_ms(lambda: lib(s, d))
            row[f"{tag}graph_device_ms"] = graph_device_ms(torch, lambda: fn(slots, buf))
            row[f"{tag}library_graph_device_ms"] = graph_device_ms(torch, lambda: lib(s, d))
        row["bound_share"] = row["bound_ms"] / row["graph_device_ms"]
        row["no_slower_than_library"] = row["graph_device_ms"] <= row["library_graph_device_ms"]
        rows[kernel] = row
    pair = torch.tensor([src.data_ptr(), dst.data_ptr()], dtype=torch.int64)
    rows["slot_set"] = dict(
        ms=cuda_ms(lambda: GATHER.slot_set(slots, src.data_ptr(), dst.data_ptr())),
        graph_device_ms=graph_device_ms(
            torch, lambda: GATHER.slot_set(slots, src.data_ptr(), dst.data_ptr())),
        library_ms=cuda_ms(lambda: slots.copy_(pair)), library_call="slots.copy_(host pair)",
        host_us_per_call={
            "slot_set": host_us(torch, lambda: GATHER.slot_set(slots, src.data_ptr(),
                                                                dst.data_ptr())),
            "slots.copy_": host_us(torch, lambda: slots.copy_(pair), calls=500)},
        bytes=16, bound_by="launch")
    for k, row in rows.items():
        log(f"   timing {k}: {json.dumps(row)}")
    return rows


def vcycle_graph_phase(torch, mem_tb):
    """Phase 20: at phase 6's and the benchmark's box1m hierarchies, five
    calls of StructuredMultigrid (eager, captured and replayed, replayed)
    against the eager V-cycle on the same residuals, bit for bit; the pool
    its graph reserves (one of its own here) against what an eager V-cycle
    of the same work reserves on a stream of its own; eager and replayed ms
    a call. Then the slot
    copies at both fine levels' sizes, float32 and float64, aligned and one
    element off, against Tensor.copy_ exactly, and their timing at box1m's
    (slot_rows)."""
    from femx_torch.solve import multigrid
    from femx_torch.solve.multigrid import StructuredMultigrid

    rng = np.random.default_rng(20)
    idx = torch.cuda.current_device()
    out, sizes = {}, []
    for label, (dims, cells) in GRAPH_HIERARCHIES.items():
        ny, nz = 2 * cells[1] + 1, 2 * cells[2] + 1
        ndof = 3 * (2 * cells[0] + 1) * ny * nz
        mask = np.ones(ndof)
        mask[:3 * ny * nz] = 0  # clamped at x = 0
        t_setup, mg = wall_s(lambda: StructuredMultigrid(dims, cells, E, NU, mask,
                                                         device=DEVICE))
        check(mg.fine_op.ndof == ndof, f"{label}: {mg.fine_op.ndof} DOF, not {ndof}")
        sizes.append(ndof)
        rs = [torch.as_tensor(rng.standard_normal(ndof).astype(np.float32), device=DEVICE)
              for _ in range(5)]
        saved = multigrid._CAPTURE.pop(idx, None)  # a pool of this hierarchy's own
        try:
            got = [mg(r) for r in rs]
            want = [mg._vcycle(0, r) for r in rs]
            torch.cuda.synchronize()
            check(vcycle_state(mg) == 2, f"{label}: the V-cycle was not captured")
            equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
            check(all(equal), f"{label}: replayed V-cycles differ from the eager ones: {equal}")
            graph_pool = pool_bytes(torch, multigrid._capture_place(torch.device(DEVICE))[1])
            need = eager_need(torch, multigrid, mg, rs[0])
            check(graph_pool <= need, f"{label}: the graph's pool reserves {graph_pool} B, an "
                  f"eager V-cycle {need} B")
            rec = dict(cells=list(cells), dof=ndof, levels=len(mg.levels), setup_s=t_setup,
                       bitwise_equal_calls=len(equal), graph_pool_bytes=graph_pool,
                       eager_need_bytes=need,
                       eager_ms=cuda_ms(lambda: mg._vcycle(0, rs[0]), reps=5, inner=5),
                       replay_ms=cuda_ms(lambda: mg(rs[0]), reps=5, inner=5))
            log(f"   {label}: {json.dumps(rec)}")
            out[label] = rec
            del got, want, mg
        finally:
            multigrid._CAPTURE.pop(idx, None)
            if saved is not None:
                multigrid._CAPTURE[idx] = saved
    slots = torch.zeros(2, dtype=torch.int64, device=DEVICE)
    for n in sizes:
        for dt in (torch.float32, torch.float64):
            for off in (0, 1):
                src = torch.randn(n + off, dtype=dt, device=DEVICE)
                dst = torch.full((n + off,), float("nan"), dtype=dt, device=DEVICE)
                buf, ref = torch.empty(n, dtype=dt, device=DEVICE), torch.empty(n, dtype=dt,
                                                                               device=DEVICE)
                GATHER.slot_set(slots, src[off:].data_ptr(), dst[off:].data_ptr())
                GATHER.slot_copy_in(slots, buf)
                buf2 = buf * 1.0
                GATHER.slot_copy_out(slots, buf2)
                ref.copy_(src[off:])
                torch.cuda.synchronize()
                check(torch.equal(buf, ref) and torch.equal(dst[off:], ref)
                      and bool(dst[:off].isnan().all()),
                      f"slot copies differ from Tensor.copy_ at {n} {dt}, offset {off}")
    log(f"   slot copies equal Tensor.copy_ at {sizes} elements, float32 and float64, "
        f"offsets 0 and 1")
    out["slot_rows"] = slot_rows(torch, sizes[-1], mem_tb)
    return out


def main() -> int:
    global CM, GATHER
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # the multigrid disk cache off (ranks and subprocesses inherit it): every
    # setup time below is a full setup, never a load from an earlier run
    os.environ["FEMX_MG_CACHE"] = "0"
    import femx_torch
    from femx_torch import bench, build, gather
    from femx_torch.assembly_structured import StructuredSolidOperator
    from femx_torch.elements import cell_matmul as cm

    CM, GATHER = cm, gather
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

    log("3-4. structured_cell_matmul against its plain version; timing")
    rows = phase_kernels(torch, cm, build, StructuredSolidOperator, peaks)

    paths = {}
    log("5. reference default case on the card")
    paths["default_case"], R_default, fa_default = reference_case(torch, femx_torch)

    log("6. flagship (structured) through SolidReactionAnalysis")
    paths["flagship"], warm, R_flagship, fa_flagship = flagship_case(torch, femx_torch)

    log("7. bench flow (femx_torch.bench)")
    bflow, sb = bench_flow(torch, bench)
    paths["bench_f32_solve"] = bflow["launches_f32_solve"]
    paths["bench_refined_solve"] = bflow["launches_refined_solve"]

    log("8. unstructured flagship: relabelled box from a .msh file")
    paths["unstructured_flagship"], fa_u, warm_u, msh_path = unstructured_flagship(
        torch, femx_torch, R_flagship)
    host_dir = None
    try:
        log("9. take_rows against its plain version at the flagship's gathers; timing")
        tg_rows = tg_kernel_rows(torch, fa_u, peaks[2])
        del fa_u

        log("10. unstructured bench flow (femx_torch.bench: TG + lattice MG, f32)")
        ubench, tg_ub = unstructured_bench(torch, bench, sb.problem, "tg")
        paths["unstructured_bench"] = ubench["launches"]

        log("11. small mesh files: TG + block-Jacobi (f64) and dense Cholesky")
        small = small_mesh_files(torch, femx_torch, R_default)
        for label, rec in small.items():
            paths[label] = rec["launches"]

        log("12. examples: repro counterparts and the bench_dyngather sweep")
        paths["examples"], ex_rows = examples_phase(torch, peaks[2])

        log("13. solid extras and modal")
        log(" (a) bench.py's modal: f32 Lanczos on the face-clamped flagship, then refined")
        modal = bench_modal(torch, bench, sb)
        paths["modal_lanczos"] = modal["launches_lanczos"]
        paths["modal_refine"] = modal["launches_refine"]
        problem = sb.problem
        del sb
        log(" (b) modal, compute_stresses and solve_cases on the corner-fixed f32 flagship")
        extras = analysis_extras(torch, femx_torch, fa_flagship)
        paths["analysis_modal"] = extras["launches_modal"]
        paths["compute_stresses"] = extras["launches_stresses"]
        paths["solve_cases"] = extras["launches_cases"]
        it_flagship = fa_flagship.solve_info["iterations"]
        levels_flagship = len(fa_flagship._precond.levels)
        del fa_flagship
        log(" (c) checkpoint= on the default case: a cut run, then a resumed one")
        ck = checkpoint_case(torch, femx_torch, R_default, fa_default.solve_info["iterations"])
        paths["checkpoint_cut"] = ck["launches_cut"]
        paths["checkpoint_resumed"] = ck["launches_resumed"]
        log(" (d) refined modal on the mesh-file default (TG) and the structured default")
        mfm = mesh_file_modal(torch, small["mesh_file_default"]["analysis"], fa_default)
        paths["mesh_file_modal"] = mfm["mesh_file_modal"]["launches"]
        paths["default_modal"] = mfm["default_modal"]["launches"]

        log("14. group-ELL and cluster operators")
        log(" (a) femx_torch.bench's unstructured flow with group-ELL, then cluster")
        blk, ubs = block_operators_bench(torch, bench, problem, tg_ub)
        del tg_ub
        for k in ("groupell", "cluster"):
            paths[f"{k}_bench"] = blk[k]["launches"]
            paths[f"{k}_apply"] = blk[k]["apply_launches"]
        log(" (b) the relabelled flagship file through SolidReactionAnalysis, f32, both operators")
        ubs["cluster"].lp = ubs["groupell"].lp = None  # their lattices are not needed any more
        flag = block_operator_flagships(torch, femx_torch, msh_path, R_flagship)
        for k in ("groupell", "cluster"):
            paths[f"{k}_flagship"] = flag[k]["launches"]
        log(" (c) group-ELL symmetric storage (FEMX_GROUPELL_SYM=1)")
        sym = groupell_symmetric(torch, ubs["groupell"])
        paths["groupell_symmetric_apply"] = sym["launches"]
        log(" (d) take_rows at the new operators' shapes")
        new_rows = new_shape_rows(torch, ubs["groupell"].op, ubs["cluster"].op, peaks[2])
        del ubs

        log("15. beam and shaft products")
        log(" (a) the golden portal frame through BeamAnalysis")
        portal = portal_golden(torch, femx_torch)
        paths["beam_portal"] = portal["launches"]
        log(" (b) the 10-storey building frame, lumped and consistent mass")
        frames = building_frames(torch, femx_torch)
        for m in ("lumped", "consistent"):
            paths[f"building_{m}"] = frames[m]["launches"]
        log(" (c) ShaftModalAnalysis: the test fixture and a stepped shaft")
        shafts = shaft_cases(torch, femx_torch)
        log("16. plane and pipe products")
        log(" (a) the plane cantilever at 1024 x 256 cells (MG-PCG)")
        plane = plane_flagship(torch, femx_torch, bench)
        paths["plane_flagship"] = plane["launches"]
        log(" (b) the dense route and modal(n_modes=6)")
        pdense = plane_dense_modal(torch, femx_torch)
        paths["plane_dense"] = pdense["launches"]
        log(" (c) PipeThermalAnalysis at n_r=64, n_z=512: pressure, then thermal")
        pipes = pipe_cases(torch, femx_torch)
        for k, rec in pipes.items():
            paths[f"pipe_{k}"] = rec["launches"]
        log(" (d) take_rows at the Tri6 gather")
        plane_pa = plane.pop("analysis")
        tri6 = tri6_rows(torch, plane_pa, peaks[2])

        log("17. the host surface: CLI, reports, plots")
        solved = {"solid_default": fa_default,
                  "building_frame": frames["lumped"].pop("analysis"),
                  "shaft_stepped": shafts["stepped"].pop("analysis"),
                  "plane_flagship": plane_pa, "plane_dense": pdense.pop("analysis"),
                  "pipe_thermal": pipes["thermal"].pop("analysis")}
        pipes["pressure"].pop("analysis")
        shafts["fixture"].pop("analysis")
        os.makedirs(WORK_DIR, exist_ok=True)
        host_dir = tempfile.mkdtemp(prefix="host_", dir=WORK_DIR)
        log(" (a) femx_torch.cli.main: solid --box at phase 6's lattice, --stress --report --html")
        cli_flag = cli_flagship(torch, femx_torch, R_flagship, host_dir)
        paths["cli_flagship"] = cli_flag["launches"]
        log(" (b) reports of the analyses phases 5, 15 and 16 solved")
        reports = write_reports(torch, host_dir, solved)
        log(" (c) python -m femx_torch: mesh-box, solid --msh, shaft, plane, pipe, section")
        subs = cli_subprocesses(torch, R_default, host_dir)
        log(" (d) plots")
        plots = host_plots(torch, host_dir, solved)
        del solved, plane_pa

        log("18. the conv-form structured apply")
        log(" (a) conv against slot at 24x24x96, float32 and float64")
        conv_rows = conv_apply_rows(torch, part, peaks)
        log(" (b) the structured flagship with structured_apply='conv'")
        conv_flag = flagship_conv(torch, femx_torch, it_flagship, R_flagship, warm)
        paths["flagship_conv"] = conv_flag["launches"]

        log("19. the distributed paths: N ranks on the one card (femx_torch.parallel)")
        dist, dist_paths = distributed_phase(torch, femx_torch, it_flagship, R_flagship,
                                             levels_flagship, msh_path,
                                             warm["peak_device_bytes"])
        paths.update(dist_paths)

        log("20. the V-cycle's CUDA graph at the flagship's and box1m's hierarchies")
        vgraph = vcycle_graph_phase(torch, peaks[2])

        def by_path(key):
            return {p: int(c.get(key, 0)) for p, c in paths.items()}

        kernels = []
        for name, row in rows.items():
            key = f"{SCM}/{name}"
            kernels.append({
                "name": f"structured_cell_matmul_{'f32' if name == 'float32' else 'f64'}",
                "dtype": name, "route": "cuda",
                "source": "femx_torch/csrc/structured_cell_matmul.cu",
                "replaces": "femx/elements/pallas_structured.py:101",
                "path": "flagship", "launches": int(paths["flagship"].get(key, 0)), **row,
                "launches_by_path": by_path(key)})
        gather_src = "examples/pallas_gather_repros.py"
        for name, row in tg_rows.items():
            key = f"take_rows/{name}"
            kernels.append({
                "name": f"take_rows_{'f32' if name == 'float32' else 'f64'}",
                "dtype": name, "route": "cuda", "source": "femx_torch/csrc/take_rows.cu",
                "replaces": f"{gather_src}:56",
                "also_replaces": [f"{gather_src}:72", f"{gather_src}:128"],
                "path": "unstructured_flagship",
                "launches": int(paths["unstructured_flagship"].get(key, 0)), **row,
                **({"new_shapes": new_rows} if name == "float32" else {}),
                "tri6_shape": tri6[name],
                "launches_by_path": by_path(key)})
        kernels.append({
            "name": "take_along_axis", "dtype": "float32", "route": "cuda",
            "source": "femx_torch/csrc/take_along_axis.cu", "replaces": f"{gather_src}:90",
            "also_replaces": [f"{gather_src}:108", "examples/bench_dyngather.py:52"],
            "path": "examples",
            "launches": int(paths["examples"].get("take_along_axis/float32", 0)),
            **ex_rows["take_along_axis"], "launches_by_path": by_path("take_along_axis/float32")})
        mosaic_src = "examples/pallas_mosaic_repros.py"
        kernels.append({
            "name": "row_copy", "dtype": "float32", "route": "cuda",
            "source": "femx_torch/csrc/row_copy.cu", "replaces": f"{mosaic_src}:47",
            "also_replaces": [f"{mosaic_src}:{n}" for n in (63, 86, 107, 128)],
            "path": "examples", "launches": int(paths["examples"].get("row_copy/float32", 0)),
            **ex_rows["row_copy"], "launches_by_path": by_path("row_copy/float32")})
        for kernel, key in (("slot_copy_in", "slot_copy_in/float32"),
                            ("slot_copy_out", "slot_copy_out/float32"), ("slot_set", "slot_set")):
            kernels.append({
                "name": f"{kernel}_f32" if kernel != "slot_set" else kernel,
                "dtype": "float32" if kernel != "slot_set" else "int64", "route": "cuda",
                "source": "femx_torch/csrc/slot_copy.cu",
                "replaces": "none: the input, output and addresses of the V-cycle's CUDA graph "
                            "(femx_torch/solve/multigrid.py)",
                "path": "flagship", "launches": int(paths["flagship"].get(key, 0)),
                **vgraph["slot_rows"][kernel], "launches_by_path": by_path(key)})
        for k in kernels:
            check(k["launches"] > 0, f"{k['name']} was not launched on its path ({k['path']})")
        log("end-to-end: " + json.dumps({
            "accurate_solve_run_simulation_s": warm["run_simulation_s"],
            "accurate_solve_solve_s": warm["solve_s"],
            "bench_f32_solve_s": bflow["f32_solve_s"], "bench_f32_iters": bflow["f32_iters"],
            "bench_refined_solve_s": bflow["refined_solve_s"],
            "bench_refined_inner_iters": bflow["refined_inner_iters"],
            "unstructured_run_simulation_s": warm_u["run_simulation_s"],
            "unstructured_solve_s": warm_u["solve_s"],
            "unstructured_iters": warm_u["iterations"],
            "unstructured_read_mesh_s": warm_u["read_mesh_s"],
            "unstructured_bench_f32_solve_s": ubench["f32_solve_s"],
            "unstructured_bench_f32_iters": ubench["iters"],
            "unstructured_bench_idle_share": ubench["idle_share"],
            "mesh_file_default_run_simulation_s": small["mesh_file_default"]["run_simulation_s"],
            "mesh_file_default_iters": small["mesh_file_default"]["solve_info"]["iterations"],
            "flagship_peak_device_bytes": warm["peak_device_bytes"],
            "unstructured_peak_device_bytes": warm_u["peak_device_bytes"],
            "modal10_s": modal["modal10_s"], "modal10_first_s": modal["modal10_first_s"],
            "modal10_inner_solves": modal["modal10_inner_solves"],
            "modal_f1_hz": modal["modal_f1_hz"],
            "modal_f1_lanczos_hz": modal["modal_f1_lanczos_hz"],
            "modal_f1_bound": modal["modal_bounds"][0],
            "modal_max_bound": max(modal["modal_bounds"]),
            "modal_refine_s": modal["modal_refine_s"],
            "modal_peak_device_bytes": modal["modal_peak_device_bytes"],
            "analysis_modal_s": extras["analysis_modal_s"],
            "compute_stresses_s": extras["compute_stresses_s"],
            "compute_stresses_rounding_ratio": extras["compute_stresses_rounding_ratio"],
            "compute_stresses_peak_device_bytes": extras["compute_stresses_peak_device_bytes"],
            "solve_cases_iters": extras["solve_cases_iters"],
            "solve_cases_s": extras["solve_cases_s"],
            "checkpoint_resumed_s": ck["checkpoint_resumed_s"],
            "checkpoint_iterations": ck["checkpoint_iterations"],
            "mesh_file_modal_s": mfm["mesh_file_modal"]["s"],
            "default_modal_s": mfm["default_modal"]["s"],
            **{f"{k}_bench_{f}": blk[k][f] for k in ("groupell", "cluster")
               for f in ("iters", "f32_solve_s", "assemble_s", "setup_s", "peak_device_bytes",
                         "idle_share", "apply_ms")},
            **{f"{k}_flagship_{f}": flag[k][f] for k in ("groupell", "cluster")
               for f in ("iterations", "run_simulation_s", "solve_s", "peak_device_bytes")},
            "tg_apply_ms": blk["groupell"]["tg_apply_ms"],
        "groupell_symmetric_apply_ms": sym["apply_ms"],
            "groupell_full_apply_ms": sym["full_apply_ms"],
            "portal_s": portal["s"], "portal_lumped_card_cpu_rel": portal["lumped_card_cpu_rel"],
            **{f"building_{m}_{k}": frames[m][k] for m in ("lumped", "consistent")
               for k in ("s", "stage_times", "equilibrium", "eigen_residual_ratio", "f1_hz")},
            "building_cut_u_rel": frames["cut"]["u_rel"],
            "building_cut_f_rel": frames["cut"]["f_rel"],
            **{f"shaft_{k}_whirl_splits": v["whirl_splits"] for k, v in shafts.items()},
            **{f"plane_{k}": v for k, v in plane.items() if k != "launches"},
            "plane_dense_modal_s": pdense["modal_s"],
            **{f"pipe_{k}_{f}": v[f] for k, v in pipes.items()
               for f in ("s", "iterations", "solve_s", "errors")},
            **{f"cli_flagship_{k}": v for k, v in cli_flag.items() if k != "launches"},
            "reports": reports, "cli_subprocess_s": {k: v["s"] for k, v in subs.items()},
            "plots_s": plots, "conv_apply": conv_rows,
            **{f"flagship_conv_{k}": v for k, v in conv_flag.items() if k != "launches"},
            "distributed": dist,
            "vcycle_graph": {k: v for k, v in vgraph.items() if k != "slot_rows"}}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0

    finally:
        if os.path.exists(msh_path):
            os.remove(msh_path)
        if host_dir is not None:
            shutil.rmtree(host_dir, ignore_errors=True)

if __name__ == "__main__":
    sys.exit(main())
