"""Distributed lattice-MG preconditioned CG for unstructured meshes (port
of femx/parallel/tg_lattice.py): the sharded transpose-gather apply
(ShardedTGOperator, its node slabs aligned with the auxiliary lattice's
z-slabs), the distributed V-cycle on the embedding lattice
(DistributedMultigrid) and slab-local trilinear transfers.

Ownership: a mesh node belongs to the rank whose lattice z-slab holds its
interpolation cell's lower plane, so its 8 trilinear corners lie within
that rank's local lattice planes (the owned ones plus the shared plane the
halo layout carries as a ghost): the transfers read and write only local
lattice values, and one halo reduce-and-sync completes the shared planes.
Every transfer gather is the take_rows kernel on the card.

Precision: CG runs in float64 on the float64 sharded operator; block-Jacobi,
the transfers and the V-cycle run in `dtype` (float32: the mixed scheme of
the port's single-device routes; femx refines float32 CG against the
float32 operator cast up, femx/analysis/solid.py:1000-1030).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.config import resolve_device, torch_dtype
from femx_torch.gather import index_tensor, take_rows
from femx_torch.parallel import comm
from femx_torch.parallel.halo import DistributedMultigrid
from femx_torch.parallel.tg_sharded import ShardedTGOperator
from femx_torch.solve.cg import pcg
from femx_torch.solve.lattice_precond import _even_cells, build_lattice_activity_mask
from femx_torch.solve.multigrid import StructuredMultigrid


def _corner_tables(i0_loc: np.ndarray, f: np.ndarray, gs_loc: Tuple[int, int, int]):
    """Per corner slot (phase, local phase-flat index, weight) of each node,
    on local z-plane indices (slab offsets are even, so parities agree)."""
    P_ = np.asarray(gs_loc)
    n = len(i0_loc)
    phase = np.empty((8, n), dtype=np.int64)
    flat = np.empty((8, n), dtype=np.int64)
    w = np.empty((8, n))
    s = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                gx, gy, gz = i0_loc[:, 0] + dx, i0_loc[:, 1] + dy, i0_loc[:, 2] + dz
                phase[s] = (gx % 2) * 4 + (gy % 2) * 2 + (gz % 2)
                w[s] = ((f[:, 0] if dx else 1.0 - f[:, 0]) * (f[:, 1] if dy else 1.0 - f[:, 1])
                        * (f[:, 2] if dz else 1.0 - f[:, 2]))
                py_ = (P_[1] + 1 - (gy % 2)) // 2
                pz_ = (P_[2] + 1 - (gz % 2)) // 2
                flat[s] = ((gx // 2) * py_ + (gy // 2)) * pz_ + (gz // 2)
                s += 1
    return phase, flat, w


def _phase_counts(gs) -> List[int]:
    return [int(np.prod([(gs[a] + 1 - p) // 2 for a, p in enumerate((px, py, pz))]))
            for px in (0, 1) for py in (0, 1) for pz in (0, 1)]


class DistributedUnstructuredSolver:
    """One-call distributed unstructured solve; every rank builds it alike:

        solver = DistributedUnstructuredSolver.build(points, conn, E, nu, mask)
        x, iters, res, ok = solver.solve(f_global, tol=1e-8)
    """

    @classmethod
    def build(cls, points, conn, E_mod, nu, free_mask_global, mesh=None, dtype=np.float32,
              cells_per_axis: Optional[Tuple[int, int, int]] = None,
              coarse_weight: float = 1.0, n_cycles: int = 2, device=None,
              weight: Optional[float] = None):
        self = cls.__new__(cls)
        dev = resolve_device(device)
        pts = np.asarray(points, dtype=np.float64)
        conn = np.asarray(conn)
        N = len(pts)
        ndev = comm.world_size() if mesh is None else mesh.size
        me = comm.rank()
        self.dtype = torch_dtype(dtype)

        lo, hi = pts.min(axis=0), pts.max(axis=0)
        span = np.where(hi - lo > 0, hi - lo, 1.0)
        if cells_per_axis is None:
            # grid-matched pitch: the median of each element's shortest edge
            c4 = pts[conn[:, :4]]
            pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
            edges = np.stack([np.linalg.norm(c4[:, a] - c4[:, b], axis=1) for a, b in pairs],
                             axis=1)
            h_el = np.median(edges.min(axis=1))
            cells_per_axis = tuple(_even_cells(span[a] / max(h_el, 1e-30)) for a in range(3))
        n_cells = [int(c) for c in cells_per_axis]
        m = 2 * ndev  # level-0 slabs need nz % (2 * ranks) == 0
        n_cells[2] = -(-n_cells[2] // m) * m
        self.n_cells = n_cells = tuple(n_cells)
        spacing = tuple(span[a] / n_cells[a] for a in range(3))
        gs = tuple(2 * c + 1 for c in n_cells)
        half_h = np.asarray(spacing) / 2.0

        mu = np.asarray(free_mask_global, dtype=np.float64).reshape(N, 3)
        mask_l = build_lattice_activity_mask(pts, mu, lo, half_h, gs).reshape(-1)
        latt_op = StructuredSolidOperator.from_lattice(n_cells, spacing, E_mod, nu, dtype=dtype,
                                                       device=dev)
        mg = StructuredMultigrid(None, n_cells, E_mod, nu, mask_l, spacing=spacing, dtype=dtype,
                                 fine_op=latt_op.with_free_mask(latt_op.to_internal(mask_l)),
                                 device=dev)
        self.dmg = dmg = DistributedMultigrid(mg, mesh)

        # ---- lattice-aligned node ownership
        t = (pts - lo[None, :]) / half_h[None, :]
        i0 = np.clip(np.floor(t).astype(np.int64), 0, np.asarray(gs) - 2)
        fr = np.clip(t - i0, 0.0, 1.0)
        nzl = n_cells[2] // ndev
        owner = np.clip(i0[:, 2] // (2 * nzl), 0, ndev - 1)
        zperm = np.argsort(pts[:, 2], kind="stable")
        if not (np.diff(owner[zperm]) >= 0).all():
            raise ValueError("slab ownership is not monotone in z-sorted node order: the "
                             "mesh/lattice alignment assumption is violated")
        bounds = np.searchsorted(owner[zperm], np.arange(ndev + 1))
        # the CG operator in float64; its block-Jacobi in `dtype`
        self.top = top = ShardedTGOperator.from_mesh(
            pts, conn, E_mod, nu, mesh, weight=weight, dtype=np.float64,
            free_mask_global=np.asarray(free_mask_global), rank_bounds=bounds, device=dev)
        self.binv = top.binv.to(self.dtype)
        self.mask = top.mask.to(self.dtype)
        Nl = top.Nl

        # ---- this rank's slab-local transfers
        gs_loc = (gs[0], gs[1], 2 * nzl + 1)
        cnts = _phase_counts(gs_loc)
        ids = zperm[bounds[me]:bounds[me + 1]]
        i0_d = i0[ids].copy()
        i0_d[:, 2] -= 2 * me * nzl
        if len(ids) and not ((i0_d[:, 2] >= 0).all() and (i0_d[:, 2] < 2 * nzl).all()):
            raise ValueError(f"rank {me}: owned nodes fall outside the local slab cell range "
                             f"[0, {2 * nzl}) after offsetting")
        phase, flat, w = _corner_tables(i0_d, fr[ids], gs_loc)
        n_d = len(ids)
        interp_idx = np.zeros((8, Nl), dtype=np.int64)
        interp_w = np.zeros((8, Nl))
        for s in range(8):  # each node hits each phase once
            for p in range(8):
                sel = phase[s] == p
                interp_idx[p, :n_d][sel] = flat[s][sel]
                interp_w[p, :n_d][sel] = w[s][sel]
        self.interp_idx = [index_tensor(interp_idx[p], cnts[p], dev) for p in range(8)]
        self.interp_w = torch.as_tensor(interp_w, dtype=self.dtype, device=dev)
        self.rest_idx, self.rest_w = [], []
        for p in range(8):
            sl, fl = np.nonzero(phase == p)  # (corner slot, node) incidences of phase p
            nodes, dsts, ws = fl, flat[sl, fl], w[sl, fl]
            counts = np.bincount(dsts, minlength=cnts[p])
            D = max(1, int(counts.max()) if counts.size else 1)
            order = np.argsort(dsts, kind="stable")
            starts = np.zeros(cnts[p] + 1, dtype=np.int64)
            np.cumsum(counts, out=starts[1:])
            pos = np.arange(len(order)) - starts[dsts[order]]
            ridx = np.full((cnts[p], D), Nl, dtype=np.int64)  # Nl: the zero pad row
            rw = np.zeros((cnts[p], D))
            ridx[dsts[order], pos] = nodes[order]
            rw[dsts[order], pos] = ws[order]
            self.rest_idx.append(index_tensor(ridx, Nl + 1, dev))
            self.rest_w.append(torch.as_tensor(rw, dtype=self.dtype, device=dev))
        self.latt_mask = dmg.halo.mask_local
        self.coarse_weight = float(coarse_weight)
        self.n_cycles = int(n_cycles)
        return self

    # ---- transfers ---------------------------------------------------------
    def _interp_local(self, e_loc: torch.Tensor) -> torch.Tensor:
        """Local lattice vector -> (Nl, 3) owned mesh values."""
        loc = self.dmg.halo.local
        offs = loc._phase_offsets()
        out = 0.0
        for p in range(8):
            g = e_loc[offs[p]:offs[p + 1]].view(3, -1).T.contiguous()
            out = out + self.interp_w[p][:, None] * take_rows(g, self.interp_idx[p])
        return out

    def _restrict_local(self, r_own: torch.Tensor) -> torch.Tensor:
        """(Nl, 3) owned mesh residual -> local lattice vector (shared planes
        incomplete until a halo reduce-and-sync)."""
        r_pad = torch.cat([r_own, r_own.new_zeros((1, 3))])
        parts = [(rw[..., None] * take_rows(r_pad, ridx)).sum(dim=1).T.reshape(-1)
                 for ridx, rw in zip(self.rest_idx, self.rest_w)]
        return torch.cat(parts)

    def _coarse_correct(self, r_own: torch.Tensor) -> torch.Tensor:
        halo0, lmask, dmg = self.dmg.halo, self.latt_mask, self.dmg
        rl = halo0.halo_reduce_and_sync(self._restrict_local(r_own * self.mask)) * lmask
        el = dmg(rl) * lmask
        for _ in range(self.n_cycles - 1):
            resid = rl - halo0.apply_constrained_local(el, lmask)
            el = el + dmg(resid * lmask) * lmask
        return self._interp_local(el) * self.mask

    def precondition(self, r_own: torch.Tensor) -> torch.Tensor:
        """Block-Jacobi plus the lattice coarse correction, in `dtype`."""
        z = torch.einsum("ncd,nd->nc", self.binv, r_own)
        return z + self.coarse_weight * self._coarse_correct(r_own)

    # ---- solve -------------------------------------------------------------
    def solve(self, f_global, tol: float = 1e-5, maxiter: int = 2000, x0_global=None):
        """Distributed lattice-MG PCG (float64 CG); returns (x_global,
        iterations, residual, converged), x on every rank."""
        top = self.top
        shape = (top.Nl, 3)

        def A(v):
            return top.apply_constrained_local(v.view(shape)).reshape(-1)

        def minv(r):
            return self.precondition(r.view(shape).to(self.dtype)).to(r.dtype).reshape(-1)

        b = top.to_local(f_global).reshape(-1)
        x0 = None if x0_global is None else top.to_local(x0_global).reshape(-1)
        res = pcg(A, b, minv, x0=x0, tol=tol, maxiter=maxiter, dots=comm.dots)
        return top.gather_local(res.x), res.iterations, res.residual_norm, res.converged
