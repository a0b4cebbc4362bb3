"""femx's headline benchmark (bench.py) on the port: the ~1.39M-DOF solid
cantilever, assembled and solved on the card.

    python -m femx_torch.bench [--device cuda|cpu]

prints one JSON line with bench.py's field names (diagnostics go to
stderr) and exits nonzero on any failure. The flow is bench.py's
(bench.py:40-365) on the flagship grid (FEMX_BENCH_GRID, default 24,24,96
cells of 1.6/96 m, clamped at z = 0, 1 kN at the tip):

  1. StructuredMultigrid setup and the f32 MG-PCG solve to 1e-5 (first
     call, then the best of 3 warm ones);
  2. the accurate solve: pcg_refined to a true residual of 1e-8 (the
     headline `value`);
  3. 10 modes by shift-invert Lanczos with MG-PCG inner solves (first and
     steady), then shift_invert_refine through 1e-9-refined solves, with
     per-mode Ritz bounds;
  4. the unstructured flow (FEMX_BENCH_UNSTRUCTURED=0 skips it): the box
     with randomly relabelled nodes, the operator FEMX_UNSTRUCTURED_OP
     ("groupell", the default, "cluster" or "tg") with the lattice-MG
     preconditioner, PCG to 1e-5.

The port compiles nothing, so the first call's wall is reported as
first_solve_s and modal10_first_s in place of compile_s and
modal10_compile_s. Beside every wall `<name>_s` (and `value`) stands
`<name>_device_ms`, the card's time between CUDA events recorded on the
stream before and after it, and the two solves also report the summed
kernel time of one profiled run (`*_kernel_ms`). `name` and `power_limit`
are nvidia-smi's. bench.py's vs_baseline (its 2 s target was set for the
TPU) and its main() (subprocess probe, CPU fallback) are not ported. It
runs in float32 on the card; --device cpu (FEMX_BENCH_DEVICE=cpu) is for
tests and runs in float64 there, as bench.py does on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from femx_torch.assembly_cluster import SolidOperatorCluster
from femx_torch.assembly_groupell import SolidOperatorGroupELL
from femx_torch.assembly_soa import SolidOperatorSoA
from femx_torch.assembly_tg import SolidOperatorTG
from femx_torch.config import numpy_dtype, resolve_device
from femx_torch.mesh import box_tet10
from femx_torch.modal import shift_invert_refine, solid_modal_structured
from femx_torch.solve.cg import pcg, pcg_refined
from femx_torch.solve.lattice_precond import LatticePreconditioner
from femx_torch.solve.multigrid import StructuredMultigrid

H = 1.6 / 96  # uniform cell size
E_MOD, NU, RHO = 2e11, 0.3, 7850.0
UNSTRUCTURED_OPS = {"groupell": SolidOperatorGroupELL, "cluster": SolidOperatorCluster,
                    "tg": SolidOperatorTG}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, device: torch.device):
    """(fn(), wall seconds, device ms): the wall on the host clock with the
    device synchronized on both sides; on CUDA the device time between
    events recorded on the current stream before and after fn (None on the
    CPU)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, None
    torch.cuda.synchronize(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0, e0.elapsed_time(e1)


def profiled(fn, device: torch.device):
    """One run of fn under torch.profiler on CUDA: (wall s, summed device
    kernel ms, the profiler's event averages); (wall, None, None) on the
    CPU."""
    if device.type != "cuda":
        return timed(fn, device)[1], None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall, _ = timed(fn, device)
    events = prof.key_averages()
    # kernel events only (the aten ops above them carry the same time again)
    kernel_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    return wall, kernel_ms, events


def card(device: torch.device):
    """(name, power limit) of the card as nvidia-smi reports them; the
    CPU's ("cpu", None)."""
    if device.type != "cuda":
        return "cpu", None
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", f"--id={device.index or 0}"],
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[0]
        name, power = (s.strip() for s in line.rsplit(",", 1))
        return name, power
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return torch.cuda.get_device_name(device), None


@dataclasses.dataclass
class Problem:
    """bench.py's cantilever: the box of `grid` cells clamped at z = 0 with
    1 kN spread over the tip face nodes (-y)."""

    grid: tuple
    dims: tuple
    mesh: object
    mask: np.ndarray  # (3N,) 1 free / 0 clamped
    f: np.ndarray  # (3N,) load

    @property
    def ndof(self) -> int:
        return 3 * self.mesh.num_nodes


def flagship_problem(grid=(24, 24, 96)) -> Problem:
    nx, ny, nz = (int(v) for v in grid)
    dims = (nx * H, ny * H, nz * H)
    mesh = box_tet10(*dims, mesh_size=H)
    if mesh.structured.n_cells != (nx, ny, nz):
        raise ValueError(f"box of {mesh.structured.n_cells} cells, not {(nx, ny, nz)}")
    ndof = 3 * mesh.num_nodes
    mask = np.ones(ndof)
    fixed = np.where(mesh.points[:, 2] < 1e-9)[0]
    mask[(3 * fixed[:, None] + np.arange(3)).ravel()] = 0
    f = np.zeros(ndof)
    tip = np.where(mesh.points[:, 2] > dims[2] - 1e-9)[0]
    f[3 * tip + 1] = -1000.0 / len(tip)
    return Problem((nx, ny, nz), dims, mesh, mask, f)


@dataclasses.dataclass
class StructuredBench:
    """The structured flow's state: V-cycle, operators and loads."""

    problem: Problem
    mg: StructuredMultigrid
    op: object  # mg.fine_op, in dtype
    op64: object  # the same operator in float64 (refinement residuals)
    fj: torch.Tensor  # load, internal layout, dtype
    f64j: torch.Tensor  # the same in float64
    tol: float  # 1e-5 in float32, 1e-8 in float64

    @property
    def dtype(self) -> torch.dtype:
        return self.fj.dtype


def setup_structured(problem: Problem, dtype, device) -> StructuredBench:
    """StructuredMultigrid on the problem (operators, cell matrices, coarse
    factor) and the internal-layout loads."""
    dt = numpy_dtype(dtype)
    mg = StructuredMultigrid(problem.dims, problem.grid, E_MOD, NU, problem.mask,
                             dtype=dt.type, device=device)
    op = mg.fine_op
    f_int = op.to_internal(problem.f * problem.mask)
    return StructuredBench(
        problem=problem, mg=mg, op=op, op64=op.astype(np.float64),
        fj=torch.as_tensor(f_int.astype(dt), device=op.device),
        f64j=torch.as_tensor(f_int, dtype=torch.float64, device=op.device),
        tol=1e-5 if dt == np.float32 else 1e-8)


def f32_solve(sb: StructuredBench):
    """MG-PCG in the flow's dtype to sb.tol (bench.py's f32 solve)."""
    return pcg(sb.op.apply_constrained, sb.fj, M_inv_diag=sb.mg, tol=sb.tol, maxiter=200)


def refined_solve(sb: StructuredBench):
    """The accurate solve: MG-PCG inner solves with float64 refinement to a
    true residual of 1e-8."""
    return pcg_refined(sb.op.apply_constrained, sb.fj, M_inv_diag=sb.mg, tol=sb.tol,
                       maxiter=200, refine_steps=6, A_residual=sb.op64.apply_constrained,
                       b_residual=sb.f64j, outer_tol=1e-8)


def lanczos(sb: StructuredBench):
    """10 modes by shift-invert Lanczos with MG-PCG inner solves."""
    return solid_modal_structured(sb.op, sb.mg, rho=RHO, n_modes=10, inner_tol=sb.tol,
                                  inner_maxiter=200, tol=1e-4, maxiter=60)


def refine_modes(sb: StructuredBench, mres, solves: Optional[list] = None):
    """shift_invert_refine of a Lanczos result through 1e-9-refined solves;
    returns (omega, Ritz bounds, modes) and appends (inner iterations, true
    residual) of every solve to `solves`."""
    solves = [] if solves is None else solves

    def ks_tight(b):
        r = pcg_refined(sb.op.apply_constrained, b.to(sb.dtype), M_inv_diag=sb.mg, tol=sb.tol,
                        maxiter=200, refine_steps=6, A_residual=sb.op64.apply_constrained,
                        b_residual=b, outer_tol=1e-9)
        solves.append((r.iterations, r.residual_norm))
        return r.x

    return shift_invert_refine(ks_tight, sb.op.lumped_mass_diagonal(RHO), mres.modes)


def relabelled(problem: Problem, seed: int = 0):
    """The problem's mesh arrays with nodes relabelled by
    default_rng(seed).permutation (no structured metadata survives):
    (points, conn, mask, f)."""
    pts, conn = problem.mesh.points, problem.mesh.cells["tetra10"]
    relabel = np.random.default_rng(seed).permutation(len(pts))
    pts_s = np.empty_like(pts)
    pts_s[relabel] = pts
    mask_s = np.empty_like(problem.mask)
    mask_s.reshape(-1, 3)[relabel] = problem.mask.reshape(-1, 3)
    f_s = np.empty_like(problem.f)
    f_s.reshape(-1, 3)[relabel] = problem.f.reshape(-1, 3)
    return pts_s, relabel[conn], mask_s, f_s


@dataclasses.dataclass
class UnstructuredBench:
    """The unstructured flow's state and its setup times."""

    kind: str
    op: object  # the constrained unstructured operator, internal layout
    lp: LatticePreconditioner
    fu: torch.Tensor  # load, internal layout
    tol: float
    points: np.ndarray  # relabelled mesh
    conn: np.ndarray
    assembly_s: float
    assembly_device_ms: Optional[float]
    setup_s: float  # assembly + preconditioner
    setup_device_ms: Optional[float]


def setup_unstructured(problem: Problem, kind: str, dtype, device) -> UnstructuredBench:
    """The relabelled problem's operator `kind` and lattice-MG
    preconditioner (bench.py:223-290)."""
    if kind not in UNSTRUCTURED_OPS:
        raise ValueError(f"FEMX_UNSTRUCTURED_OP={kind!r} not in {tuple(UNSTRUCTURED_OPS)}")
    dev = resolve_device(device)
    dt = numpy_dtype(dtype)
    pts_s, conn_s, mask_s, f_s = relabelled(problem)

    def assemble():
        return UNSTRUCTURED_OPS[kind].from_mesh(pts_s, conn_s, E_MOD, NU, dtype=dt, device=dev)[0]

    def precondition(op):
        op = op.with_free_mask(op.to_internal(mask_s).astype(dt))
        if kind == "tg":
            bj_data, bj_fn = op.soa.block_jacobi_tensors(), SolidOperatorSoA.apply_block_jacobi
        else:
            bj_data, bj_fn = op.block_jacobi_tensors(), type(op).apply_block_jacobi
        lp = LatticePreconditioner(pts_s, conn_s, E_MOD, NU, mask_s, dtype=dt.type,
                                   node_perm=op.new_of_old, bj_fn=bj_fn, bj_data=bj_data,
                                   n_caller=getattr(op, "n_pad", None), device=dev)
        return op, lp

    op, t_asm, d_asm = timed(assemble, dev)
    (op, lp), t_pre, d_pre = timed(lambda: precondition(op), dev)
    fu = torch.as_tensor(op.to_internal(f_s * mask_s).astype(dt), device=dev)
    return UnstructuredBench(
        kind=kind, op=op, lp=lp, fu=fu, tol=1e-5 if dt == np.float32 else 1e-8, points=pts_s,
        conn=conn_s, assembly_s=t_asm, assembly_device_ms=d_asm, setup_s=t_asm + t_pre,
        setup_device_ms=None if d_asm is None else d_asm + d_pre)


def unstructured_solve(ub: UnstructuredBench):
    """Lattice-MG PCG on the unstructured operator to ub.tol."""
    return pcg(ub.op.apply_constrained, ub.fu, M_inv_diag=ub.lp, tol=ub.tol, maxiter=2000)


def run_bench(grid=None, device=None) -> dict:
    """bench.py's flow on `device` (FEMX_BENCH_DEVICE, default CUDA) at
    `grid` (FEMX_BENCH_GRID, default 24,24,96 cells); returns the JSON
    record."""
    dev = resolve_device(device or os.environ.get("FEMX_BENCH_DEVICE") or None)
    grid = tuple(int(v) for v in (grid or os.environ.get("FEMX_BENCH_GRID", "24,24,96")
                                  .split(",")))
    dt = np.dtype(np.float32 if dev.type == "cuda" else np.float64)
    unstructured = os.environ.get("FEMX_BENCH_UNSTRUCTURED", "1") == "1"
    op_kind = os.environ.get("FEMX_UNSTRUCTURED_OP", "groupell")
    if unstructured and op_kind not in UNSTRUCTURED_OPS:
        # fail fast: a record naming one operator must not measure another
        raise ValueError(f"FEMX_UNSTRUCTURED_OP={op_kind!r} not in {tuple(UNSTRUCTURED_OPS)}")
    name, power = card(dev)
    out = {"metric": "solid_cantilever_accurate_solve_wall", "name": name,
           "power_limit": power, "device": str(dev), "dtype": dt.name, "grid": list(grid)}

    problem, t_mesh, _ = timed(lambda: flagship_problem(grid), dev)
    log(f"mesh: {problem.mesh.num_nodes} nodes / {problem.ndof} DOF, cells {grid} "
        f"({t_mesh:.2f} s host)")
    sb, t_setup, d_setup = timed(lambda: setup_structured(problem, dt, dev), dev)
    log(f"MG setup: {t_setup:.3f} s; levels {[lv.op.n_cells for lv in sb.mg.levels]}")

    res, t_first, d_first = timed(lambda: f32_solve(sb), dev)
    warm = [timed(lambda: f32_solve(sb), dev) for _ in range(3)]
    res, t_f32, d_f32 = min(warm, key=lambda w: w[1])
    t_prof, k_f32, _ = profiled(lambda: f32_solve(sb), dev)
    log(f"f32 solve: first {t_first:.3f} s, warm {[round(w[1], 4) for w in warm]} s, "
        f"{res.iterations} iterations, residual {res.residual_norm:.2e}")
    rr, t_ref, d_ref = timed(lambda: refined_solve(sb), dev)
    if not (rr.converged and rr.residual_norm <= 1e-8):
        raise RuntimeError(f"accurate solve missed 1e-8: {rr.residual_norm}")
    log(f"accurate solve: {t_ref:.3f} s, {rr.iterations} inner iterations, true residual "
        f"{rr.residual_norm:.2e}")

    mres, t_modal_first, d_modal_first = timed(lambda: lanczos(sb), dev)
    mres, t_modal, d_modal = timed(lambda: lanczos(sb), dev)
    f_hz = mres.omega.cpu().numpy() / (2 * np.pi)
    (om_ref, eta, _), t_val, d_val = timed(lambda: refine_modes(sb, mres), dev)
    f_ref = om_ref.cpu().numpy() / (2 * np.pi)
    eta = eta.cpu().numpy()
    log(f"modal first-10: {t_modal:.3f} s steady / {t_modal_first:.3f} s first, "
        f"{mres.iterations} inner solves; refined f1 {f_ref[0]:.6f} Hz (Lanczos "
        f"{f_hz[0]:.6f}), bound max {eta.max():.2e} ({t_val:.3f} s)")
    out.update({
        "value": t_ref, "value_device_ms": d_ref,
        "unit": (f"s @ {problem.ndof} DOF (true residual {rr.residual_norm:.1e}, "
                 f"{rr.iterations} inner {dt.name} MG-PCG iters)"),
        "ndof": problem.ndof, "setup_s": t_setup, "setup_device_ms": d_setup,
        "first_solve_s": t_first, "first_solve_device_ms": d_first,
        "f32_solve_s": t_f32, "f32_solve_device_ms": d_f32,
        "f32_solve_runs_s": [w[1] for w in warm], "f32_solve_kernel_ms": k_f32,
        "f32_solve_profiled_s": t_prof, "f32_iters": res.iterations,
        "f32_residual": res.residual_norm, "refined_inner_iters": rr.iterations,
        "true_residual": rr.residual_norm,
        "modal10_s": t_modal, "modal10_device_ms": d_modal,
        "modal10_first_s": t_modal_first, "modal10_first_device_ms": d_modal_first,
        "modal10_inner_solves": mres.iterations,
        "modal_f1_hz": float(f_ref[0]), "modal_f1_lanczos_hz": float(f_hz[0]),
        # Ritz bounds on the relative eigenvalue error; the frequency's is half
        "modal_f1_err_est": float(eta[0] / 2), "modal_max_err_est": float(eta.max() / 2),
        "modal_validation_s": t_val, "modal_validation_device_ms": d_val,
    })
    del sb

    if unstructured:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ub = setup_unstructured(problem, op_kind, dt, dev)
        log(f"unstructured setup ({op_kind} + lattice precond): {ub.setup_s:.3f} s (operator "
            f"assembly {ub.assembly_s:.3f} s)")
        ru, t_ufirst, d_ufirst = timed(lambda: unstructured_solve(ub), dev)
        ru, t_u, d_u = timed(lambda: unstructured_solve(ub), dev)
        t_uprof, k_u, _ = profiled(lambda: unstructured_solve(ub), dev)
        if not ru.converged:
            raise RuntimeError(f"unstructured solve did not converge: {ru.residual_norm}")
        log(f"unstructured lattice-MG PCG: {t_u:.3f} s ({ru.iterations} iterations, residual "
            f"{ru.residual_norm:.2e})")
        out.update({
            "unstructured_solve_s": t_u, "unstructured_solve_device_ms": d_u,
            "unstructured_first_solve_s": t_ufirst,
            "unstructured_first_solve_device_ms": d_ufirst,
            "unstructured_solve_kernel_ms": k_u, "unstructured_solve_profiled_s": t_uprof,
            "unstructured_iters": ru.iterations, "unstructured_residual": ru.residual_norm,
            "unstructured_setup_s": ub.setup_s, "unstructured_setup_device_ms": ub.setup_device_ms,
            "unstructured_assembly_s": ub.assembly_s,
            "unstructured_assembly_device_ms": ub.assembly_device_ms,
            "assembly_mdof_per_s": problem.ndof / 1e6 / ub.assembly_s,
            "unstructured_peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                               if dev.type == "cuda" else None),
        })
    out.update({"structured_apply": "slot",
                "mg_smoother": os.environ.get("FEMX_MG_SMOOTHER", "jacobi"),
                "unstructured_op": op_kind})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", help="cuda (default) or cpu, for tests (FEMX_BENCH_DEVICE)")
    print(json.dumps(run_bench(device=ap.parse_args(argv).device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
