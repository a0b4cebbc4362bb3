"""One-call multi-rank structured solve (port of femx/parallel/driver.py):
what SolidReactionAnalysis(..., devices=N).solve() and ``python -m
femx_torch solid --devices N`` run on a structured box.

The lattice is ghost-padded in z up to the next multiple of 2 * ranks, so
the slabs decompose and the first z-restriction stays local: the padded
cells carry z_weight 0 and their nodes are fixed, so the solution on the
real lattice is unchanged.

Precision: float64 CG over the halo apply of the float64-assembled padded
operator, preconditioned by the distributed V-cycle in the analysis dtype
(float32: the distributed counterpart of femx_torch.solve.cg.pcg_mixed).
femx instead refines float32 CG against the float32 operator cast up
(femx/parallel/driver.py:148-151), whose rounded cell matrix moves the
solution off the float64 equilibrium (ROADMAP Queue 3).

Checkpoints (checkpoint_path=) save CG's r and p beside x, gathered to the
full internal order of the padded operator, and continue the recurrences
on resume; a file with x alone (femx's) restarts CG from x.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from femx_torch import checkpoint as ckpt
from femx_torch.assembly_structured import StructuredSolidOperator, pad_z_raster, unpad_z_raster
from femx_torch.config import resolve_device
from femx_torch.parallel import comm
from femx_torch.parallel.cg import pcg_dist
from femx_torch.parallel.halo import DistributedMultigrid, HaloStructuredOperator
from femx_torch.profiling import span
from femx_torch.solve.multigrid import StructuredMultigrid


class DistributedStructuredSolver:
    """Builds the padded operators and the distributed multigrid once, then
    solves any number of right-hand sides (solve(), and solve_cases after
    a distributed solve). Every rank of an n-rank group builds it alike.

    Raises ValueError when the group's size differs from `devices`, or
    when the lattice cannot be slab-distributed (nx or ny odd: no uniform
    first coarsening); callers fall back to the single-device path."""

    def __init__(self, n_cells, spacing, E, nu, mask_global, weight=None,
                 dtype=np.float32, devices=None, device=None, apply_form=None):
        ndev = comm.world_size() if devices is None else int(devices)
        if ndev < 2:
            raise ValueError("distributed solve needs >= 2 ranks")
        comm.require_world(ndev)
        dev = resolve_device(device)
        nx, ny, nz = (int(c) for c in n_cells)
        sp = tuple(float(s) for s in spacing)
        self.ndev, self.dtype = ndev, np.dtype(dtype)
        step = 2 * ndev
        nz_p = -(-nz // step) * step
        self.nz_p = nz_p
        self.grid_old = (2 * nx + 1, 2 * ny + 1, 2 * nz + 1)
        self.grid_new = (2 * nx + 1, 2 * ny + 1, 2 * nz_p + 1)
        self.mask_global = np.asarray(mask_global, dtype=np.float64)
        mask_p = pad_z_raster(self.mask_global, self.grid_old, self.grid_new)
        zw = None
        if nz_p != nz:
            zw = np.zeros(nz_p)
            zw[:nz] = 1.0

        def padded_op(dt):
            base = StructuredSolidOperator.from_lattice((nx, ny, nz_p), sp, E, nu, weight=weight,
                                                        dtype=dt, device=dev,
                                                        apply_form=apply_form)
            if zw is not None:
                base = StructuredSolidOperator.from_host(
                    base.Kcell_host, base.n_cells, base.weight, spacing=base.spacing,
                    z_weight=zw, device=dev, apply_form=base.apply_form)
            return base.with_free_mask(base.to_internal(mask_p))

        self.op_p = padded_op(self.dtype)
        self.mg = StructuredMultigrid(None, (nx, ny, nz_p), E, nu, mask_p, weight=weight,
                                      spacing=sp, dtype=self.dtype.type, fine_op=self.op_p,
                                      device=dev)
        self.dmg = DistributedMultigrid(self.mg)  # raises on lattices it cannot slab
        self.mixed = self.dtype == np.float32
        self.op64 = padded_op(np.float64) if self.mixed else self.op_p
        self.halo = HaloStructuredOperator(self.op64) if self.mixed else self.dmg.halo

    def _minv(self, r: torch.Tensor) -> torch.Tensor:
        if self.mixed:
            return self.dmg(r.to(torch.float32)).to(r.dtype)
        return self.dmg(r)

    def _pcg(self, b, tol, maxiter, x0=None, r0=None, p0=None):
        return pcg_dist(self.halo.apply_constrained_local, b, self._minv, tol=tol,
                        maxiter=maxiter, x0=x0, weight=self.halo.weights_local, r0=r0, p0=p0)

    def solve(self, f_global, tol: float = 1e-8, maxiter: int = 10000,
              checkpoint_path: Optional[str] = None, checkpoint_chunk: int = 500,
              checkpoint_maxiter: int = 50000) -> Tuple[np.ndarray, dict]:
        """Solve for one global-raster RHS (the same on every rank); returns
        (u_global on the UNPADDED lattice, info), on every rank.

        checkpoint_path: CG runs in checkpoint_chunk-iteration segments,
        rank 0 persisting (x, r, p, iterations) between them; a re-run
        resumes from the file (femx_torch.checkpoint's format).

        Traced: `dist.rhs` (the host's pad and permutation of f, its upload
        and this rank's slab of it) and `dist.gather` (the all_gather of x,
        its copy to the host, and the host's inverse permutation and
        unpadding)."""
        with span("dist.rhs"):
            f_p = pad_z_raster(np.asarray(f_global, dtype=np.float64) * self.mask_global,
                               self.grid_old, self.grid_new)
            f_int = self.op_p.to_internal(f_p)
            b = self.halo.to_local(f_int)
        resumed = None
        if checkpoint_path:
            res, resumed = self._solve_checkpointed(b, f_int.shape, tol, checkpoint_path,
                                                    checkpoint_chunk, checkpoint_maxiter)
        else:
            res = self._pcg(b, tol, maxiter)
        with span("dist.gather"):
            x_int = self.halo.gather_local(res.x).cpu().numpy()
            u = unpad_z_raster(self.op_p.to_global(x_int), self.grid_old, self.grid_new)
        info = {
            "method": f"distributed_halo_mg_pcg[{self.ndev}xz]"
                      + ("_mixed" if self.mixed else ""),
            "devices": self.ndev,
            "distributed_levels": self.dmg.n_dist,
            "padded_nz": self.nz_p,
            "iterations": int(res.iterations),
            "residual": float(res.residual_norm),
            "converged": bool(res.converged),
            "backend": comm.backend(),
        }
        if resumed is not None:
            info.update(checkpoint=checkpoint_path, resumed_iterations=resumed)
        return u, info

    def reactions(self, u_global) -> np.ndarray:
        """K u on the unpadded lattice, in global raster DOF order, through
        the padded float64 operator (the ghost cells have z weight 0 and
        add nothing), on every rank."""
        u_p = pad_z_raster(np.asarray(u_global, dtype=np.float64), self.grid_old,
                           self.grid_new)
        u_int = torch.as_tensor(self.op64.to_internal(u_p), device=self.op64.device)
        r_p = self.op64.to_global(self.op64.apply(u_int).cpu().numpy())
        return unpad_z_raster(r_p, self.grid_old, self.grid_new)

    def _solve_checkpointed(self, b, shape, tol, path, chunk, maxiter):
        halo = self.halo
        arrays, meta = ckpt.load_state(path)
        x0 = r0 = p0 = None
        done = 0
        if arrays is not None and arrays["x"].shape == shape:
            x0 = halo.to_local(arrays["x"])
            done = int((meta or {}).get("iterations", 0))
            if all(arrays.get(k, np.empty(0)).shape == shape for k in ("r", "p")):
                r_file = halo.to_local(arrays["r"])
                d = r_file - (b - halo.apply_constrained_local(x0))
                dd, bb = comm.dots((d, d), (b, b), weight=halo.weights_local)
                if float(dd) <= 1e-12 * float(bb):
                    r0, p0 = r_file, halo.to_local(arrays["p"])
        resumed = done
        res = None
        while done < maxiter:
            res = self._pcg(b, tol, chunk, x0=x0, r0=r0, p0=p0)
            done += res.iterations
            state = {k: halo.gather_local(v) for k, v in (("x", res.x), ("r", res.r),
                                                          ("p", res.p))}
            if comm.rank() == 0:
                ckpt.save_state(path, state, {"iterations": done,
                                              "residual": float(res.residual_norm)})
            if res.converged or res.iterations == 0:
                break
            x0, r0, p0 = res.x, res.r, res.p
        return res._replace(iterations=done), resumed


def distributed_structured_solve(n_cells, spacing, E: float, nu: float, mask_global,
                                 f_global, weight: Optional[float] = None, dtype=np.float32,
                                 tol: float = 1e-8, devices: Optional[int] = None,
                                 device=None) -> Tuple[np.ndarray, dict]:
    """Solve K u = f on a structured lattice over the ranks of the current
    group (a one-shot DistributedStructuredSolver). mask_global, f_global:
    (ndof,) in global raster DOF order; returns (u_global on the unpadded
    lattice, info)."""
    solver = DistributedStructuredSolver(n_cells, spacing, E, nu, mask_global, weight=weight,
                                         dtype=dtype, devices=devices, device=device)
    return solver.solve(f_global, tol=tol)
