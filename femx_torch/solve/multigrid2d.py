"""Geometric multigrid preconditioner for structured 2D Tri6 lattices (port
of femx/solve/multigrid2d.py).

`rect_tri6_from_cells` meshes have the full regular half-step node grid
(2 nx + 1, 2 ny + 1) in row-major order, so:

  * coarsening halves the cell grid, and the coarse nodes are the even-even
    fine nodes: the Dirichlet mask transfers by injection;
  * bilinear prolongation and full-weighting restriction (exact adjoints)
    are strided slices of the (Px, Py, 2) grid, no gathers;
  * each level rebuilds the plane or axisymmetric Tri6 operator on its
    lattice (its applies run the take_rows kernel on the card);
  * damped block-Jacobi smoothing with the operators' masked nodal 2x2
    inverses, and a dense masked inverse at the bottom, built once on the
    device in float64 (femx inverts on the host with numpy).

The V-cycle is symmetric, so it serves as pcg's preconditioner:
``pcg(op.apply_constrained, b, M_inv_diag=mg)``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from femx_torch.assembly_plane import AxisymOperator, PlaneOperator, apply_block_inverses
from femx_torch.config import resolve_device, torch_dtype
from femx_torch.mesh.generators2d import rect_tri6_from_cells


def prolong2d(uc: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation (Pxc, Pyc, 2) -> (2Pxc-1, 2Pyc-1, 2)."""
    pxc, pyc, c = uc.shape
    uf = uc.new_zeros((2 * pxc - 1, 2 * pyc - 1, c))
    uf[0::2, 0::2] = uc
    uf[1::2, 0::2] = 0.5 * (uc[:-1, :] + uc[1:, :])
    uf[0::2, 1::2] = 0.5 * (uc[:, :-1] + uc[:, 1:])
    uf[1::2, 1::2] = 0.25 * (uc[:-1, :-1] + uc[1:, :-1] + uc[:-1, 1:] + uc[1:, 1:])
    return uf


def restrict2d(rf: torch.Tensor) -> torch.Tensor:
    """Full weighting, the exact adjoint of :func:`prolong2d`,
    (Pxf, Pyf, 2) -> ((Pxf+1)/2, (Pyf+1)/2, 2)."""
    p = F.pad(rf, (0, 0, 1, 1, 1, 1))
    # padded row/col 2i+1 is fine index 2i; the strided slices pick the
    # (2i-1, 2i, 2i+1) x (2j-1, 2j, 2j+1) neighbourhoods for all i, j at once
    xm, x0, xp = p[0:-2:2], p[1:-1:2], p[2::2]
    out = x0[:, 1:-1:2]
    out = out + 0.5 * (xm[:, 1:-1:2] + xp[:, 1:-1:2] + x0[:, 0:-2:2] + x0[:, 2::2])
    out = out + 0.25 * (xm[:, 0:-2:2] + xm[:, 2::2] + xp[:, 0:-2:2] + xp[:, 2::2])
    return out


def _make_operator(kind: str, n_cells, spacing, origin, C, thickness, dtype, device):
    mesh = rect_tri6_from_cells(n_cells, spacing, origin=origin)
    conn = mesh.cells["triangle6"]
    if kind == "plane":
        op, _ = PlaneOperator.from_mesh(mesh.points, conn, C, thickness=thickness,
                                        dtype=dtype, device=device)
    elif kind == "axisym":
        op, _ = AxisymOperator.from_mesh(mesh.points, conn, C, dtype=dtype, device=device)
    else:
        raise ValueError(f"unknown operator kind {kind!r}")
    return op


class Multigrid2D:
    """Symmetric V-cycle preconditioner M^-1 for CG on a rect Tri6 lattice.

    Args:
      kind: "plane" or "axisym" (the level operator family).
      n_cells, spacing, origin: the FINE lattice (mesh.lattice2d).
      C: material matrix (3x3 plane / 4x4 axisym).
      free_mask: (ndof,) fine Dirichlet mask (1 = free).
      thickness: plane only.
      n_smooth: damped block-Jacobi sweeps pre and post (equal: symmetric).
      omega: smoother damping.
      coarse_dof_limit: stop coarsening once ndof fits a dense inverse.
      fine_op: the pipeline's fine operator, reused (must match kind,
        n_cells and C); its device is then the V-cycle's.
      device: where the hierarchy lives without fine_op (None = CUDA).

    Coarsening halves both axes while both cell counts are even; a hierarchy
    that bottoms out above `coarse_dense_limit` DOF raises (callers fall back
    to block-Jacobi).
    """

    def __init__(self, kind, n_cells, spacing, origin, C, free_mask,
                 thickness=1.0, n_smooth=2, omega=0.7,
                 coarse_dof_limit=3000, coarse_dense_limit=20000,
                 dtype=None, fine_op=None, device=None):
        nx, ny = (int(v) for v in n_cells)
        hx, hy = (float(v) for v in spacing)
        dt = torch_dtype(dtype or np.float64)
        dev = fine_op.device if fine_op is not None else resolve_device(device)
        C = torch.as_tensor(C, dtype=dt, device=dev)

        def _ndof(cx, cy):
            return 2 * (2 * cx + 1) * (2 * cy + 1)

        specs: List[Tuple[int, int, float, float]] = [(nx, ny, hx, hy)]
        while (_ndof(specs[-1][0], specs[-1][1]) > coarse_dof_limit
               and specs[-1][0] % 2 == 0 and specs[-1][1] % 2 == 0):
            cx, cy, chx, chy = specs[-1]
            specs.append((cx // 2, cy // 2, 2 * chx, 2 * chy))
        coarse_ndof = _ndof(specs[-1][0], specs[-1][1])
        if coarse_ndof > coarse_dense_limit:
            raise ValueError(
                f"2D multigrid hierarchy stuck at {specs[-1][:2]} cells "
                f"({coarse_ndof} DOF > dense limit {coarse_dense_limit}); "
                "prefer even (ideally 2^k-divisible) cell counts, or use "
                "block-Jacobi PCG")
        # one level is legal: the "V-cycle" is then one dense solve

        self.specs = tuple(specs)
        self.n_smooth = int(n_smooth)
        self.omega = float(omega)
        ops, binvs, masks = [], [], []
        mask = torch.as_tensor(np.asarray(free_mask) if not isinstance(free_mask, torch.Tensor)
                               else free_mask, dtype=dt, device=dev)
        for lvl, (cx, cy, chx, chy) in enumerate(specs):
            if lvl == 0 and fine_op is not None:
                op = fine_op
            else:
                op = _make_operator(kind, (cx, cy), (chx, chy), origin, C, thickness, dt, dev)
            if lvl > 0:
                # coarse nodes ARE the even-even fine nodes: inject the mask
                mask = mask.reshape(4 * cx + 1, 4 * cy + 1, 2)[::2, ::2].reshape(-1)
            op = op.with_free_mask(mask)
            ops.append(op)
            binvs.append(op.block_jacobi_inverse_blocks())
            masks.append(mask)
        # the dense MASKED inverse at the bottom: S K S + (I - S), float64
        Kc = ops[-1].dense().to(torch.float64)
        s = masks[-1].to(torch.float64)
        Kc = s[:, None] * Kc * s[None, :] + torch.diag(1.0 - s)
        self._coarse_inv = torch.linalg.inv(Kc).to(dt)
        self._ops = tuple(ops)
        self._binvs = tuple(binvs)
        self._masks = tuple(masks)

    @property
    def fine_op(self):
        return self._ops[0]

    @property
    def n_levels(self) -> int:
        return len(self.specs)

    def level_shapes(self) -> List[Tuple[int, int]]:
        return [(cx, cy) for cx, cy, _, _ in self.specs]

    def _grid(self, k: int) -> Tuple[int, int]:
        cx, cy, _, _ = self.specs[k]
        return 2 * cx + 1, 2 * cy + 1

    def _smooth(self, k: int, x, b, sweeps: int):
        op, binv = self._ops[k], self._binvs[k]
        for _ in range(sweeps):
            r = b - op.apply_constrained(x)
            x = x + self.omega * apply_block_inverses(binv, r)
        return x

    def _vcycle(self, k: int, b):
        if k == self.n_levels - 1:
            return self._coarse_inv @ b
        x = self._smooth(k, torch.zeros_like(b), b, self.n_smooth)
        r = b - self._ops[k].apply_constrained(x)
        px, py = self._grid(k)
        rc = restrict2d(r.reshape(px, py, 2)).reshape(-1) * self._masks[k + 1]
        xc = self._vcycle(k + 1, rc)
        pxc, pyc = self._grid(k + 1)
        x = x + prolong2d(xc.reshape(pxc, pyc, 2)).reshape(-1) * self._masks[k]
        return self._smooth(k, x, b, self.n_smooth)

    def applies_per_cycle(self) -> int:
        """Operator applies (each one take_rows launch) in one V-cycle:
        2 n_smooth + 1 on every level above the dense bottom."""
        return (2 * self.n_smooth + 1) * (self.n_levels - 1)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """One symmetric V-cycle: z ~= K^-1 r."""
        return self._vcycle(0, r)
