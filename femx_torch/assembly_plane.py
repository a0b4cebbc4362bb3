"""Matrix-free global operators for 2D Tri6 meshes, plane and axisymmetric
(port of femx/assembly_plane.py).

The per-element Gauss data is computed once; each K @ u is the element
gather ``un[conn]`` (femx_torch.gather.take_rows: the hand-written take_rows
kernel on the card, rows of 2), the batched element action
(femx_torch.elements.tri6) and the overlap-add by ``index_add_``, femx's
``.at[conn].add``. On the card that overlap-add is one launch of atomic adds,
so the order of each node's sum (at most six element contributions) varies
between runs by rounding; a transpose gather, as SolidOperatorTG does, would
be deterministic at the price of a launch per node-degree bucket.
Dirichlet BCs are full-size masks: apply_constrained(u) = S K S u + (I-S) u.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from femx_torch.assembly import assemble_dense, dof_map
from femx_torch.config import resolve_device, torch_dtype
from femx_torch.elements import tri6 as tri6_el
from femx_torch.gather import index_tensor, take_rows


def _setup(points, conn, C, dtype, device):
    """(coords (E, 6, 2), conn index tensor, C) on the device, in dtype."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    points = np.asarray(points)
    pts = torch.as_tensor(points[:, :2], dtype=dt, device=dev)
    conn_t = index_tensor(np.asarray(conn), len(points), dev)
    C = torch.as_tensor(C, dtype=dt, device=dev)
    return pts[conn_t.long()], conn_t, C


def apply_block_inverses(binv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z[n] = binv[n] @ r[n] for the nodal 2x2 blocks; a broadcast product
    summed over one axis (a batched matmul of 2x2 tiles is a cuBLAS gemv
    call per batch chunk on the card)."""
    return (binv * r.reshape(-1, 1, 2)).sum(-1).reshape(-1)


def _masked_block_inverses(blocks: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """Inverses of the nodal 2x2 blocks S B S + (I - S), (n_nodes, 2, 2)."""
    s = free_mask.reshape(-1, 2)
    blocks = blocks * s[:, :, None] * s[:, None, :]
    blocks = blocks + (1.0 - s)[:, :, None] * torch.eye(2, dtype=blocks.dtype,
                                                        device=blocks.device)
    binv, _ = tri6_el._inv2x2(blocks)
    return binv


class _Operator2D:
    """What the plane and axisymmetric operators share: DOF layout
    node-major / component-minor, ndof = 2 * n_nodes."""

    conn: torch.Tensor
    n_nodes: int
    free_mask: Optional[torch.Tensor]

    @property
    def ndof(self) -> int:
        return 2 * self.n_nodes

    @property
    def dtype(self) -> torch.dtype:
        return self.dN.dtype

    @property
    def device(self) -> torch.device:
        return self.dN.device

    def with_free_mask(self, free_mask):
        return dataclasses.replace(self, free_mask=torch.as_tensor(
            np.asarray(free_mask) if not isinstance(free_mask, torch.Tensor) else free_mask,
            dtype=self.dtype, device=self.device))

    def to(self, dtype) -> "_Operator2D":
        """The same operator with its float tensors cast to dtype (the
        float32 preconditioner's operator of a float64 analysis)."""
        dt = torch_dtype(dtype)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dt) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
            and getattr(self, f.name).is_floating_point()})

    def element_values(self, nodal) -> torch.Tensor:
        """A host nodal array (n_nodes, ...) as float64 element values
        (E, 6, ...) on the operator's device."""
        t = torch.as_tensor(np.asarray(nodal, dtype=np.float64), device=self.device)
        return t[self.conn.long()]

    def _gather(self, u: torch.Tensor) -> torch.Tensor:
        """ue (E, 6, 2) = u.reshape(n_nodes, 2)[conn]: one take_rows."""
        return take_rows(u.reshape(self.n_nodes, 2), self.conn)

    def _scatter(self, fe: torch.Tensor) -> torch.Tensor:
        """The overlap-add of element rows fe (E, 6, *tail) onto the nodes."""
        out = torch.zeros((self.n_nodes, *fe.shape[2:]), dtype=fe.dtype, device=fe.device)
        return out.index_add_(0, self.conn.reshape(-1), fe.reshape(-1, *fe.shape[2:]))

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.free_mask
        return self.apply(u * s) * s + u * (1.0 - s)

    def block_jacobi_preconditioner(self) -> Callable[[torch.Tensor], torch.Tensor]:
        binv = self.block_jacobi_inverse_blocks()
        return lambda r: apply_block_inverses(binv, r)

    def dense(self) -> torch.Tensor:
        """The dense unconstrained K (small meshes)."""
        return assemble_dense(self.element_stiffness(), dof_map(self.conn, 2), self.ndof)


@dataclasses.dataclass(eq=False)
class PlaneOperator(_Operator2D):
    """Matrix-free stiffness operator of a Tri6 plane-elasticity mesh."""

    conn: torch.Tensor  # (E, 6) index tensor
    dN: torch.Tensor  # (E, 3, 2, 6)
    wdet: torch.Tensor  # (E, 3), the Gauss weight included
    C: torch.Tensor  # (3, 3)
    n_nodes: int
    thickness: float
    free_mask: Optional[torch.Tensor] = None

    @classmethod
    def from_mesh(cls, points, conn, C, thickness=1.0, dtype=np.float64, device=None):
        """points (N, >=2), columns (0, 1) used; conn (E, 6). Returns (op,
        detJ) with detJ (E, 3) on the device."""
        coords, conn_t, C = _setup(points, conn, C, dtype, device)
        dN, wdet, detJ = tri6_el.jacobians(coords)
        return cls(conn=conn_t, dN=dN, wdet=wdet, C=C, n_nodes=len(points),
                   thickness=float(thickness)), detJ

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u, unconstrained."""
        fe = tri6_el.element_apply_plane(self.dN, self.wdet, self.C, self._gather(u),
                                         self.thickness)
        return self._scatter(fe).reshape(-1)

    def block_diagonal(self) -> torch.Tensor:
        """Nodal 2x2 diagonal blocks of K, (n_nodes, 2, 2), matrix-free."""
        d = torch.einsum("egkn,egln,eg->enkl", self.dN, self.dN, self.thickness * self.wdet)
        bke = torch.einsum("enkl,ckdl->encd", d, tri6_el.chat_tensor_plane(self.C))
        return self._scatter(bke)

    def block_jacobi_inverse_blocks(self) -> torch.Tensor:
        """Masked nodal 2x2 block inverses, (n_nodes, 2, 2)."""
        return _masked_block_inverses(self.block_diagonal(), self.free_mask)

    def element_stiffness(self) -> torch.Tensor:
        return tri6_el._stiffness_from(self.dN, self.thickness * self.wdet,
                                       tri6_el.chat_tensor_plane(self.C))


@dataclasses.dataclass(eq=False)
class AxisymOperator(_Operator2D):
    """Matrix-free stiffness operator of an axisymmetric Tri6 mesh:
    coordinates (r, z), DOFs (u_r, u_z) per node, every integral with the
    2*pi*r measure (full-revolution loads and reactions)."""

    conn: torch.Tensor  # (E, 6) index tensor
    dN: torch.Tensor  # (E, 3, 2, 6)
    wdet_r: torch.Tensor  # (E, 3) weight * detJ * 2*pi*r
    n_over_r: torch.Tensor  # (E, 3, 6)
    C: torch.Tensor  # (4, 4)
    n_nodes: int
    free_mask: Optional[torch.Tensor] = None

    @classmethod
    def from_mesh(cls, points, conn, C, dtype=np.float64, device=None):
        coords, conn_t, C = _setup(points, conn, C, dtype, device)
        dN, wdet_r, n_over_r, detJ = tri6_el.axisym_gauss_data(coords)
        return cls(conn=conn_t, dN=dN, wdet_r=wdet_r, n_over_r=n_over_r, C=C,
                   n_nodes=len(points)), detJ

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        fe = tri6_el.element_apply_axisym(self.dN, self.wdet_r, self.n_over_r, self.C,
                                          self._gather(u))
        return self._scatter(fe).reshape(-1)

    def element_stiffness(self) -> torch.Tensor:
        return tri6_el.axisym_stiffness_from(self.dN, self.wdet_r, self.n_over_r, self.C)

    def block_jacobi_inverse_blocks(self) -> torch.Tensor:
        """Masked nodal 2x2 block inverses from the element matrices'
        nodal diagonal blocks, (n_nodes, 2, 2)."""
        kee = self.element_stiffness().reshape(-1, 6, 2, 6, 2)
        blk = torch.diagonal(kee, dim1=1, dim2=3).permute(0, 3, 1, 2)  # (E, 6, 2, 2)
        return _masked_block_inverses(self._scatter(blk), self.free_mask)
