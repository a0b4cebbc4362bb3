"""SoA (element-last) matrix-free solid operator (port of
femx/assembly_soa.py).

Same interface as femx_torch.assembly.SolidOperator (apply /
apply_constrained / diagonal / block-Jacobi), with femx's element-last
arrays: dNg (4, 3, 10, E), wdet (4, E), DOF table (30, E). The production
unstructured operator, femx_torch.assembly_tg.SolidOperatorTG, wraps this
one's element kernel and block-Jacobi but replaces its scalar gather and
``index_add_`` scatter with row gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from femx_torch.config import numpy_dtype, resolve_device, torch_dtype
from femx_torch.elements import tet10_soa as soa
from femx_torch.elements.tet10 import GAUSS_WEIGHT_CORRECT, material_matrix


@dataclasses.dataclass(eq=False)
class SolidOperatorSoA:
    dofs: torch.Tensor  # (30, E) int64 global DOF table
    dNg: torch.Tensor  # (4, 3, 10, E)
    wdet: torch.Tensor  # (4, E)
    C6: np.ndarray  # (6, 6) host, in the operator's dtype
    n_nodes: int
    weight: float
    free_mask: Optional[torch.Tensor] = None

    @classmethod
    def from_mesh(cls, points, conn, E_mod, nu, weight=GAUSS_WEIGHT_CORRECT,
                  dtype=np.float32, device=None):
        """Geometry factors from host mesh arrays, computed on `device` in
        `dtype` from one (10, 3, E) coordinate upload. Returns (op, detJ)
        with detJ (4, E) host numpy."""
        dev = resolve_device(device)
        conn = np.asarray(conn)
        coords = torch.as_tensor(soa.coords_soa(np.asarray(points), conn, numpy_dtype(dtype)),
                                 device=dev)
        dNg, wdet, detJ = soa.geometry(coords)
        op = cls(dofs=torch.as_tensor(soa.dof_table(conn), dtype=torch.int64, device=dev),
                 dNg=dNg, wdet=wdet,
                 C6=material_matrix(float(E_mod), float(nu)).astype(numpy_dtype(dtype)),
                 n_nodes=len(points), weight=float(weight))
        return op, detJ.cpu().numpy()

    @property
    def ndof(self) -> int:
        return 3 * self.n_nodes

    @property
    def n_elements(self) -> int:
        return self.dofs.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.dNg.dtype

    @property
    def device(self) -> torch.device:
        return self.dNg.device

    def with_free_mask(self, free_mask) -> "SolidOperatorSoA":
        m = (free_mask.to(device=self.device, dtype=self.dtype)
             if isinstance(free_mask, torch.Tensor)
             else torch.tensor(np.asarray(free_mask), dtype=self.dtype, device=self.device))
        return dataclasses.replace(self, free_mask=m)

    def astype(self, dtype) -> "SolidOperatorSoA":
        """The same operator with its geometry factors cast to `dtype`."""
        dt = torch_dtype(dtype)
        return dataclasses.replace(
            self, dNg=self.dNg.to(dt), wdet=self.wdet.to(dt),
            C6=self.C6.astype(numpy_dtype(dt)),
            free_mask=None if self.free_mask is None else self.free_mask.to(dt))

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        fe = soa.apply_element_forces(self.dNg, self.wdet, self.C6, u[self.dofs], self.weight)
        return torch.zeros_like(u).index_add_(0, self.dofs.reshape(-1), fe.reshape(-1))

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.free_mask
        return self.apply(u * s) * s + u * (1.0 - s)

    def _block_entries(self) -> torch.Tensor:
        return soa.block_diagonal_entries(self.dNg, self.wdet, soa.chat_numpy(self.C6),
                                          self.weight)

    def diagonal(self) -> torch.Tensor:
        bke = self._block_entries()  # (10, 3, 3, E)
        diag_e = torch.diagonal(bke, dim1=1, dim2=2).permute(0, 2, 1).reshape(30, -1)
        return torch.zeros(self.ndof, dtype=bke.dtype, device=bke.device).index_add_(
            0, self.dofs.reshape(-1), diag_e.reshape(-1))

    def block_jacobi_tensors(self) -> torch.Tensor:
        """(3, 3, N) inverse constrained nodal blocks, the data of
        `apply_block_jacobi`."""
        return self._block_jacobi_cols()

    @staticmethod
    def apply_block_jacobi(binv_cols: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """r -> M^-1 r given `block_jacobi_tensors` output."""
        rn = r.reshape(-1, 3)
        z = [binv_cols[i][0] * rn[:, 0] + binv_cols[i][1] * rn[:, 1]
             + binv_cols[i][2] * rn[:, 2] for i in range(3)]
        return torch.stack(z, dim=1).reshape(-1)

    def block_jacobi_preconditioner(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """r -> M^-1 r with M = constrained nodal 3x3 block diagonal."""
        return BlockJacobiPrecond(self._block_jacobi_cols())

    def _block_jacobi_cols(self) -> torch.Tensor:
        bke = self._block_entries()  # (10, 3, 3, E)
        node_of = self.dofs[::3] // 3  # (10, E) node of each local slot
        blocks = torch.zeros((self.n_nodes, 3, 3), dtype=bke.dtype, device=bke.device)
        for n in range(10):
            blocks.index_add_(0, node_of[n], bke[n].permute(2, 0, 1))
        s = self.free_mask.reshape(self.n_nodes, 3)
        blocks = blocks * s[:, :, None] * s[:, None, :]
        blocks = blocks + (1.0 - s)[:, :, None] * torch.eye(3, dtype=blocks.dtype,
                                                            device=blocks.device)
        a = [[blocks[:, i, j] for j in range(3)] for i in range(3)]
        det = (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
               - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
               + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
        # a free node referenced by no element has a zero block: identity
        # instead of inf/NaN
        big = det.abs() > 1e-30
        valid = big.to(det.dtype)
        inv_det = valid / torch.where(big, det, torch.ones_like(det))
        inv = [
            [(a[1][1] * a[2][2] - a[1][2] * a[2][1]), (a[0][2] * a[2][1] - a[0][1] * a[2][2]),
             (a[0][1] * a[1][2] - a[0][2] * a[1][1])],
            [(a[1][2] * a[2][0] - a[1][0] * a[2][2]), (a[0][0] * a[2][2] - a[0][2] * a[2][0]),
             (a[0][2] * a[1][0] - a[0][0] * a[1][2])],
            [(a[1][0] * a[2][1] - a[1][1] * a[2][0]), (a[0][1] * a[2][0] - a[0][0] * a[2][1]),
             (a[0][0] * a[1][1] - a[0][1] * a[1][0])],
        ]
        cols = torch.stack([torch.stack([v * inv_det for v in row]) for row in inv])
        for i in range(3):  # identity blocks for degenerate (unused) nodes
            cols[i, i] += 1.0 - valid
        return cols


class BlockJacobiPrecond:
    """Callable wrapper of the SoA block-Jacobi tensors (a preconditioner
    object for pcg, as femx's pytree wrapper)."""

    def __init__(self, tensors: torch.Tensor):
        self.tensors = tensors

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return SolidOperatorSoA.apply_block_jacobi(self.tensors, r)
