"""Rank functions for `launch`: each runs one distributed path on every
rank of the group from host inputs and returns host arrays (rank 0's reach
the caller). The CPU parity tests hold them against femx, and chip_smoke.py
runs them on the card; living here, they spawn without the tests' imports.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from femx_torch.assembly import SolidOperator
from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.config import torch_dtype
from femx_torch.elements.tet10 import material_matrix
from femx_torch.parallel import comm


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def collectives(n: int = 4099, seed: int = 0, device="cuda") -> dict:
    """Every collective of comm on tensors of `device` (float32 and
    float64), against numpy on the same inputs; and whether the backend
    takes torch.distributed.reduce_scatter_tensor (gloo may refuse it).
    Returns the largest error of each and the backend."""
    import torch.distributed as dist

    r, w = comm.rank(), comm.world_size()
    dev = torch.device(device)
    out = {"backend": comm.backend(), "world": w}
    for dt in (torch.float32, torch.float64):
        ndt = np.float32 if dt == torch.float32 else np.float64
        host = [np.random.default_rng(seed + k).standard_normal(n * w).astype(ndt)
                for k in range(w)]
        mine = torch.as_tensor(host[r], device=dev)
        tot = np.sum(host, axis=0, dtype=np.float64)
        name = str(dt).removeprefix("torch.")
        out[f"all_reduce/{name}"] = float(np.abs(_np(comm.all_reduce(mine.clone())) - tot).max())
        g = _np(comm.all_gather(mine))
        out[f"all_gather/{name}"] = float(max(np.abs(g[k] - host[k]).max() for k in range(w)))
        rs = _np(comm.reduce_scatter(mine))
        out[f"reduce_scatter/{name}"] = float(np.abs(rs - tot[r * n:(r + 1) * n]).max())
        lo, hi = mine[:n].contiguous(), mine[n:2 * n].contiguous()
        fb, fa = comm.exchange(lo, hi)
        want_b = host[r - 1][n:2 * n] if r > 0 else np.zeros(n)
        want_a = host[r + 1][:n] if r + 1 < w else np.zeros(n)
        out[f"exchange/{name}"] = float(max(np.abs(_np(fb) - want_b).max(),
                                            np.abs(_np(fa) - want_a).max()))
    try:
        o = torch.empty(n, dtype=torch.float64, device=dev)
        dist.reduce_scatter_tensor(o, torch.ones(n * w, dtype=torch.float64, device=dev))
        out["reduce_scatter_tensor_accepted"] = bool((o == w).all())
    except Exception as e:  # noqa: BLE001 - the point is which backends refuse it
        out["reduce_scatter_tensor_accepted"] = f"refused: {type(e).__name__}: {str(e)[:120]}"
    return out


def _structured_op(n_cells, spacing, mask_global, dtype, device, E=2e11, nu=0.3):
    op = StructuredSolidOperator.from_lattice(n_cells, spacing, E, nu, dtype=dtype,
                                              device=device)
    return op.with_free_mask(op.to_internal(mask_global))


def structured_apply(n_cells, spacing, mask_global, u_int, dtype="float64",
                     device="cuda", repeats: int = 1) -> dict:
    """The constrained halo apply and the constrained all_reduce sharded
    apply of K (full internal vectors in and out); `repeats` halo applies
    (the last one returned) with their mean wall time."""
    import time

    from femx_torch.parallel.halo import HaloStructuredOperator
    from femx_torch.parallel.structured import ShardedStructuredOperator

    op = _structured_op(n_cells, spacing, mask_global, dtype, device)
    halo = HaloStructuredOperator(op)
    u_loc = halo.to_local(u_int)
    y = halo.apply_constrained_local(u_loc)
    comm.all_reduce(torch.zeros(1, device=op.device))
    t0 = time.perf_counter()
    for _ in range(repeats):
        y = halo.apply_constrained_local(u_loc)
    comm.all_reduce(torch.zeros(1, device=op.device))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    t = (time.perf_counter() - t0) / max(repeats, 1)
    sharded = ShardedStructuredOperator(op).apply_constrained(
        torch.as_tensor(np.asarray(u_int), dtype=torch_dtype(dtype), device=op.device))
    return {"halo": _np(halo.gather_local(y)), "sharded": _np(sharded), "halo_apply_s": t}


def structured_solve(n_cells, spacing, mask_global, f_int, dtype="float64", tol=1e-10,
                     device="cuda", maxiter: int = 10000) -> dict:
    """pcg_halo with block-Jacobi and with the distributed V-cycle."""
    from femx_torch.parallel.halo import DistributedMultigrid, HaloStructuredOperator, pcg_halo
    from femx_torch.solve.multigrid import StructuredMultigrid

    op = _structured_op(n_cells, spacing, mask_global, dtype, device)
    x, k, res, ok = pcg_halo(HaloStructuredOperator(op), f_int, tol=tol, maxiter=maxiter)
    mg = StructuredMultigrid(None, n_cells, 2e11, 0.3, mask_global, spacing=spacing,
                             dtype=np.dtype(dtype).type, fine_op=op, device=device)
    dmg = DistributedMultigrid(mg)
    x2, k2, res2, ok2 = pcg_halo(dmg.halo, f_int, tol=tol, maxiter=maxiter, preconditioner=dmg)
    return {"bj": (x, k, res, ok), "mg": (x2, k2, res2, ok2), "distributed_levels": dmg.n_dist}


def dist_vcycle_graph(n_cells, spacing, mask_global, calls: int = 5, tol: float = 1e-8,
                      device="cuda", seed: int = 0) -> dict:
    """The float32 DistributedMultigrid called on `calls` residuals with
    tracing on (under NCCL: an eager call, a capture, replays), each output
    against the eager V-cycle's on the same input, and the bytes one eager
    V-cycle hands the collectives; then float64 pcg_halo to `tol` on a
    seeded right-hand side, preconditioned by the DistributedMultigrid and
    by its eager V-cycle alone."""
    from femx_torch import profiling
    from femx_torch.parallel.halo import DistributedMultigrid, HaloStructuredOperator, pcg_halo
    from femx_torch.solve.multigrid import StructuredMultigrid

    op = _structured_op(n_cells, spacing, mask_global, "float32", device)
    mg = StructuredMultigrid(None, n_cells, 2e11, 0.3, mask_global, spacing=spacing,
                             dtype=np.float32, fine_op=op, device=device)
    dmg = DistributedMultigrid(mg)
    rng = np.random.default_rng(seed)
    rs = [dmg.halo.to_local(rng.standard_normal(op.ndof)) for _ in range(calls)]
    profiling.enable()
    try:
        got = [dmg(r) for r in rs]
        calls_rec = profiling.collect()
        dmg._vcycle_local(0, rs[0])
        eager_rec = profiling.collect()
    finally:
        profiling.disable()
    want = [dmg._vcycle_local(0, r) for r in rs]
    halo64 = HaloStructuredOperator(_structured_op(n_cells, spacing, mask_global, "float64",
                                                   device))
    f_int = rng.standard_normal(op.ndof) * op.free_mask_host
    solves = {}
    for name, minv in (("replayed", dmg), ("eager", lambda r: dmg._vcycle_local(0, r))):
        x, k, res, ok = pcg_halo(halo64, f_int, tol=tol, preconditioner=minv,
                                 low_dtype=torch.float32)
        solves[name] = {"x": x, "iterations": k, "residual": res, "converged": ok}
    names = [s["name"] for s in calls_rec["spans"]]
    return {"bitwise": [bool(torch.equal(g, w)) for g, w in zip(got, want)],
            "counters": calls_rec["counters"],
            "spans": {n: names.count(n) for n in set(names)},
            "eager_bytes": eager_rec["counters"].get("comm.bytes", 0),
            "captured": dmg._route.graph is not None and dmg._route.graph.captured,
            "backend": comm.backend(), "distributed_levels": dmg.n_dist,
            "levels": len(mg.levels), "solves": solves}


def modal_halo(n_cells, spacing, mask_global, rho, v0, n_modes=3, dtype="float64",
               tol=1e-8, inner_tol=1e-10, device="cuda") -> dict:
    """modal_shift_invert_halo from start vector v0 (internal layout)."""
    from femx_torch.parallel.halo import DistributedMultigrid
    from femx_torch.parallel.modal import modal_shift_invert_halo
    from femx_torch.solve.multigrid import StructuredMultigrid

    op = _structured_op(n_cells, spacing, mask_global, dtype, device)
    mg = StructuredMultigrid(None, n_cells, 2e11, 0.3, mask_global, spacing=spacing,
                             dtype=np.dtype(dtype).type, fine_op=op, device=device)
    res = modal_shift_invert_halo(DistributedMultigrid(mg), op.lumped_mass_diagonal(rho),
                                  op.free_mask_host, n_modes=n_modes, tol=tol,
                                  inner_tol=inner_tol, v0=v0)
    return {"omega": _np(res.omega), "iterations": res.iterations,
            "inner_iterations": res.inner_iterations}


def element_ops(points, conn, mask, u, f_cases, device="cuda") -> dict:
    """ShardedSolidOperator's element-parallel and DOF-sharded applies, and
    batched_solve_cg over the load cases (float64, block-Jacobi)."""
    from femx_torch.parallel.ops import ShardedSolidOperator, batched_solve_cg

    op, _ = SolidOperator.from_mesh(points, conn, material_matrix(2e11, 0.3), device=device)
    op = op.with_free_mask(mask)
    sop = ShardedSolidOperator.create(op)
    ut = torch.as_tensor(np.asarray(u), dtype=torch.float64, device=op.device)
    n = comm.world_size()
    pad = (-op.ndof) % n
    u_pad = torch.cat([ut, ut.new_zeros(pad)])
    chunk = u_pad.shape[0] // n
    mine = u_pad[comm.rank() * chunk:(comm.rank() + 1) * chunk]
    dof = comm.all_gather(sop.apply_dof_sharded(mine)).reshape(-1)[:op.ndof]
    F = torch.as_tensor(np.asarray(f_cases), dtype=torch.float64, device=op.device)
    X = batched_solve_cg(op, F * op.free_mask, op.block_jacobi_preconditioner(), tol=1e-10)
    return {"apply": _np(sop.apply(ut)), "apply_constrained": _np(sop.apply_constrained(ut)),
            "dof_sharded": _np(dof), "cases": _np(X)}


def tg_ops(points, conn, mask, u, f, dtype="float64", tol=1e-10, device="cuda",
           cells_per_axis: Optional[Sequence[int]] = None) -> dict:
    """ShardedTGOperator's constrained apply, pcg_tg_sharded, and the distributed
    lattice-MG solve (DistributedUnstructuredSolver)."""
    from femx_torch.parallel.tg_lattice import DistributedUnstructuredSolver
    from femx_torch.parallel.tg_sharded import ShardedTGOperator, pcg_tg_sharded

    top = ShardedTGOperator.from_mesh(points, conn, 2e11, 0.3, dtype=dtype,
                                      free_mask_global=mask, device=device)
    out = {"apply_constrained": top.gather_local(top.apply_constrained_local(top.to_local(u)))}
    out["bj"] = pcg_tg_sharded(top, np.asarray(f) * mask, tol=tol)
    solver = DistributedUnstructuredSolver.build(points, conn, 2e11, 0.3, mask, dtype=dtype,
                                                 device=device, cells_per_axis=cells_per_axis)
    out["lattice"] = solver.solve(np.asarray(f) * mask, tol=tol, maxiter=2000)
    out["lattice_cells"] = solver.n_cells
    return out


def solid_analysis(mesh, force_data, fix_data, kwargs: dict, cases=None, modal=None,
                   attrs: Optional[dict] = None, stresses: bool = False) -> dict:
    """SolidReactionAnalysis(mesh, ..., **kwargs).run_simulation() on every
    rank, then solve_cases(cases) and modal(**modal) when given. `mesh` is
    a Mesh or a .msh path; attrs are set on the instance first (e.g.
    MG_DOF_THRESHOLD). Returns rank 0's u, reactions, solve_info,
    equilibrium residual and the extras."""
    import time

    from femx_torch.analysis.solid import SolidReactionAnalysis

    t0 = time.perf_counter()
    fa = SolidReactionAnalysis(mesh, force_data, fix_data, verbose=comm.rank() == 0, **kwargs)
    for k, v in (attrs or {}).items():
        setattr(fa, k, v)
    fa.run_simulation()
    out = {"u": fa.u, "reactions": fa.reaction_forces, "solve_info": dict(fa.solve_info),
           "equilibrium": fa.equilibrium_residual(), "stage_times": dict(fa.stage_times),
           "fixed_nodes": [i["node_idx"] for i in fa.fixed_nodes_info],
           "wall_s": time.perf_counter() - t0}
    if cases is not None:
        out["cases"] = fa.solve_cases(cases)
        out["case_solve_info"] = fa.case_solve_info
    if modal is not None:
        res = fa.modal(**modal)
        out["omega"] = _np(res.omega)
        out["modal_info"] = dict(fa.modal_info)
        out["modal_error_bounds"] = getattr(fa, "modal_error_bounds", None)
    if stresses:
        out["von_mises"] = fa.compute_stresses()[1]
    return out


def replayed_and_eager(mesh, force_data, fix_data, kwargs: dict, cases,
                       modal: Optional[dict] = None,
                       checkpoint_dir: Optional[str] = None) -> dict:
    """SolidReactionAnalysis(mesh, ..., **kwargs) on every rank, its solve,
    load cases and modal(**modal) (when given) run twice: first as the
    program runs them, tracing on (under NCCL every DistributedMultigrid
    replays its V-cycle from its second call on), then with every
    DistributedMultigrid call eager. With checkpoint_dir the second pass
    builds and solves anew (a structured solver's build gives the same
    bits), each pass checkpointing its solve to a file of its own there;
    without, it runs the cases and modal of the first pass's analysis (a
    TG operator's build sums element blocks with atomics, so a rebuild need
    not give the same bits). Returns rank 0's two passes and the first
    pass's dmg.* counters."""
    from femx_torch import profiling
    from femx_torch.analysis.solid import SolidReactionAnalysis
    from femx_torch.parallel.halo import DistributedMultigrid

    def solve(name):
        kw = dict(kwargs)
        if checkpoint_dir is not None:
            kw.update(checkpoint=f"{checkpoint_dir}/{name}", checkpoint_chunk=10)
        fa = SolidReactionAnalysis(mesh, force_data, fix_data, verbose=False, **kw)
        fa.run_simulation()
        return fa, {"u": fa.u, "reactions": fa.reaction_forces,
                    "solve_info": dict(fa.solve_info)}

    def cases_and_modal(fa):
        out = {"cases": fa.solve_cases(cases), "case_solve_info": list(fa.case_solve_info)}
        if modal is not None:
            m = fa.modal(**modal)
            out.update(omega=_np(m.omega), modes=_np(m.modes), modal_info=dict(fa.modal_info))
        return out

    profiling.enable()
    try:
        fa, replayed = solve("replayed")
        replayed.update(cases_and_modal(fa))
    finally:
        profiling.disable()
    counters = profiling.collect()["counters"]
    call = DistributedMultigrid.__call__
    DistributedMultigrid.__call__ = lambda self, r: self._vcycle_local(0, r)
    try:
        eager = {}
        if checkpoint_dir is not None:
            fa, eager = solve("eager")
        eager.update(cases_and_modal(fa))
    finally:
        DistributedMultigrid.__call__ = call
    return {"replayed": replayed, "eager": eager, "backend": comm.backend(),
            "counters": {k: v for k, v in counters.items() if k.startswith("dmg.")}}


def traced_cases(mesh, force_data, fix_data, kwargs: dict, cases) -> dict:
    """SolidReactionAnalysis(mesh, ..., **kwargs).run_simulation() on every
    rank, then solve_cases(cases) twice: with tracing off, then on
    (femx_torch.profiling). Returns rank 0's answers and records of both
    passes, the case infos, and the shapes of the distributed structured
    solver: the cells of each distributed level (the local slab's), the
    hand-off's, its smoothing sweeps and the ranks."""
    from femx_torch import profiling
    from femx_torch.analysis.solid import SolidReactionAnalysis

    fa = SolidReactionAnalysis(mesh, force_data, fix_data, verbose=False, **kwargs)
    fa.run_simulation()
    profiling.disable()
    profiling.collect()
    u_off = fa.solve_cases(cases)
    off = profiling.collect()
    profiling.enable()
    try:
        u_on = fa.solve_cases(cases)
    finally:
        profiling.disable()
    on = profiling.collect()
    dmg = fa._dist_solver.dmg
    return {"u_off": u_off, "u_on": u_on, "off": off, "on": on,
            "case_solve_info": list(fa.case_solve_info), "solve_info": dict(fa.solve_info),
            "local_cells": [tuple(h.local.n_cells) for h in dmg.halos],
            "handoff_cells": tuple(dmg.mg.levels[dmg.handoff].op.n_cells),
            "n_smooth": int(dmg.mg.n_smooth), "ranks": comm.world_size()}
