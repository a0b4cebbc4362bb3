"""Element batches -> global operators (port of femx/assembly.py).

- dense scatter assembly for small systems (``index_put_`` with
  accumulation), feeding the dense Cholesky route of SolidReactionAnalysis;
- the generic matrix-free SolidOperator (gather -> batched einsum ->
  ``index_add_``), in global DOF order.

femx's ``assemble_bcoo`` (JAX sparse export) is not ported: no solve path
uses it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from femx_torch.config import resolve_device, torch_dtype
from femx_torch.elements import tet10 as tet10_el


def dof_map(conn: torch.Tensor, dofs_per_node: int) -> torch.Tensor:
    """(E, n_nodes) connectivity -> (E, n_nodes*dpn) global DOF indices,
    node-major / component-minor (the layout both reference solvers use)."""
    comp = torch.arange(dofs_per_node, dtype=conn.dtype, device=conn.device)
    return (conn[..., None] * dofs_per_node + comp).reshape(conn.shape[0], -1)


def assemble_dense(ke: torch.Tensor, edofs: torch.Tensor, ndof: int) -> torch.Tensor:
    """Scatter-add element matrices (E, d, d) into a dense (ndof, ndof) K."""
    K = torch.zeros((ndof, ndof), dtype=ke.dtype, device=ke.device)
    d = edofs.shape[1]
    rows = edofs[:, :, None].expand(-1, d, d).long()
    cols = edofs[:, None, :].expand(-1, d, d).long()
    return K.index_put_((rows, cols), ke, accumulate=True)


def assemble_vector(fe: torch.Tensor, edofs: torch.Tensor, ndof: int) -> torch.Tensor:
    f = torch.zeros(ndof, dtype=fe.dtype, device=fe.device)
    return f.index_add_(0, edofs.reshape(-1).long(), fe.reshape(-1))


@dataclasses.dataclass(eq=False)
class SolidOperator:
    """Matrix-free global stiffness operator for a Tetra10 mesh.

    Per-element, per-Gauss-point global shape gradients and masked Jacobian
    factors are computed once (``tet10.jacobians``); each apply is gather ->
    batched einsum -> ``index_add_``. ``free_mask`` (3N,) imposes Dirichlet
    BCs as apply_constrained(u) = S K S u + (I-S) u, S = diag(free_mask).
    """

    conn: torch.Tensor  # (E, 10) int64
    dN: torch.Tensor  # (E, 4, 3, 10)
    wdet: torch.Tensor  # (E, 4)
    C: torch.Tensor  # (6, 6)
    n_nodes: int
    weight: float
    free_mask: Optional[torch.Tensor] = None  # (3N,) 1 free / 0 fixed

    @classmethod
    def from_mesh(cls, points, conn, C, weight=tet10_el.GAUSS_WEIGHT_CORRECT,
                  dtype=np.float64, device=None):
        """Returns (op, detJ); detJ (E, 4) on the device."""
        dev = resolve_device(device)
        dt = torch_dtype(dtype)
        pts = torch.as_tensor(np.asarray(points), dtype=dt, device=dev)
        conn_t = torch.as_tensor(np.asarray(conn), dtype=torch.int64, device=dev)
        dN, wdet, detJ = tet10_el.jacobians(pts[conn_t])
        op = cls(conn=conn_t, dN=dN, wdet=wdet,
                 C=torch.as_tensor(np.asarray(C), dtype=dt, device=dev),
                 n_nodes=pts.shape[0], weight=float(weight))
        return op, detJ

    @property
    def ndof(self) -> int:
        return 3 * self.n_nodes

    @property
    def dtype(self) -> torch.dtype:
        return self.dN.dtype

    @property
    def device(self) -> torch.device:
        return self.dN.device

    def with_free_mask(self, free_mask) -> "SolidOperator":
        return dataclasses.replace(self, free_mask=torch.tensor(
            np.asarray(free_mask), dtype=self.dtype, device=self.dN.device))

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u for u of shape (ndof,). Unconstrained (full K)."""
        un = u.reshape(self.n_nodes, 3)
        fe = tet10_el.element_apply(self.dN, self.wdet, self.C, un[self.conn], self.weight)
        f = torch.zeros_like(un).index_add_(0, self.conn.reshape(-1), fe.reshape(-1, 3))
        return f.reshape(-1)

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.free_mask
        return self.apply(u * s) * s + u * (1.0 - s)

    def _block_entries(self, eq: str) -> torch.Tensor:
        chat = tet10_el.chat_tensor(self.C)
        return torch.einsum(eq, self.dN, chat, self.dN, self.weight * self.wdet)

    def diagonal(self) -> torch.Tensor:
        """diag(K), assembled matrix-free."""
        dke = self._block_entries("egkn,ckcl,egln,eg->enc")
        d = torch.zeros((self.n_nodes, 3), dtype=dke.dtype, device=dke.device)
        return d.index_add_(0, self.conn.reshape(-1), dke.reshape(-1, 3)).reshape(-1)

    def constrained_diagonal(self) -> torch.Tensor:
        """diag of the constrained operator: diag(K) on free DOFs, 1 on fixed
        ones."""
        s = self.free_mask
        return self.diagonal() * s + (1.0 - s)

    def block_diagonal(self) -> torch.Tensor:
        """Nodal 3x3 diagonal blocks of K, (n_nodes, 3, 3), matrix-free."""
        bke = self._block_entries("egkn,ckdl,egln,eg->encd")
        out = torch.zeros((self.n_nodes, 3, 3), dtype=bke.dtype, device=bke.device)
        return out.index_add_(0, self.conn.reshape(-1), bke.reshape(-1, 3, 3))

    def block_jacobi_preconditioner(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """r -> M^-1 r with M the constrained nodal 3x3 block diagonal."""
        blocks = self.block_diagonal()
        s = self.free_mask.reshape(self.n_nodes, 3)
        blocks = blocks * s[:, :, None] * s[:, None, :]
        eye = torch.eye(3, dtype=blocks.dtype, device=blocks.device)
        blocks = blocks + (1.0 - s)[:, :, None] * eye
        binv, _det = tet10_el._inv3x3(blocks)

        def apply_minv(r):
            return torch.einsum("ncd,nd->nc", binv, r.reshape(self.n_nodes, 3)).reshape(-1)

        return apply_minv

    def element_stiffness(self) -> torch.Tensor:
        """(E, 30, 30) element matrices (small-mesh path)."""
        ke = self._block_entries("egki,ckdl,eglj,eg->eicjd")
        return ke.reshape(self.conn.shape[0], 30, 30)
