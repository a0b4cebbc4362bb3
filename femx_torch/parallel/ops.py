"""Element- and DOF-sharded solid operator, batched load cases (port of
femx/parallel/ops.py).

- Element parallelism: each rank holds a contiguous 1/N of the (padded)
  element batch, applies it against the replicated u and the partial nodal
  forces are summed with one all_reduce per apply.
- DOF partitioning: u lives sharded; all_gather -> local element apply ->
  reduce_scatter back to this rank's chunk.
- Batch parallelism: load cases split over the ranks, solved with no
  communication; one all_gather returns them all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from femx_torch.assembly import SolidOperator
from femx_torch.elements import tet10 as tet10_el
from femx_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The process group seen as femx's 1-D device mesh: `size` ranks along
    `axis`, this process being rank `index` on `device`."""

    axis: str
    size: int
    index: int
    backend: Optional[str]
    device: torch.device


def device_mesh(n_devices: Optional[int] = None, axis: str = "elem", device=None) -> RankMesh:
    """The current process group as a 1-D mesh of its ranks (femx's
    device_mesh). n_devices, when given, must equal the group's size (one
    rank per device: start them with femx_torch.parallel.launch)."""
    from femx_torch.config import resolve_device

    n = comm.world_size()
    if n_devices is not None and int(n_devices) != n:
        comm.require_world(int(n_devices))
    return RankMesh(axis=axis, size=n, index=comm.rank(), backend=comm.backend(),
                    device=resolve_device(device))


def pad_elements(op: SolidOperator, multiple: int) -> SolidOperator:
    """Pad the element batch to a multiple of `multiple` with zero-weight
    dummy elements (wdet == 0 contributes nothing; conn points at node 0)."""
    E = op.conn.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return op

    def z(t):
        return torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)

    return dataclasses.replace(op, conn=torch.cat([op.conn, z(op.conn)]),
                               dN=torch.cat([op.dN, z(op.dN)]),
                               wdet=torch.cat([op.wdet, z(op.wdet)]))


@dataclasses.dataclass(eq=False)
class ShardedSolidOperator:
    """Element-sharded matrix-free stiffness operator: this rank's
    contiguous share of the padded element batch (rank r holds elements
    [r E/N, (r+1) E/N), as femx's P(axis) shards them)."""

    op: SolidOperator  # this rank's elements; free_mask over all DOFs
    n_ranks: int

    @classmethod
    def create(cls, op: SolidOperator, mesh: Optional[RankMesh] = None) -> "ShardedSolidOperator":
        n = comm.world_size() if mesh is None else mesh.size
        op = pad_elements(op, n)
        per = op.conn.shape[0] // n
        r = comm.rank()
        sl = slice(r * per, (r + 1) * per)
        return cls(op=dataclasses.replace(op, conn=op.conn[sl], dN=op.dN[sl],
                                          wdet=op.wdet[sl]), n_ranks=n)

    def _local_apply(self, u: torch.Tensor) -> torch.Tensor:
        un = u.reshape(self.op.n_nodes, 3)
        fe = tet10_el.element_apply(self.op.dN, self.op.wdet, self.op.C, un[self.op.conn],
                                    self.op.weight)
        return torch.zeros_like(un).index_add_(0, self.op.conn.reshape(-1),
                                               fe.reshape(-1, 3)).reshape(-1)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u with element-parallel evaluation; u and result replicated."""
        return comm.all_reduce(self._local_apply(u))

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.op.free_mask
        return self.apply(u * s) * s + u * (1.0 - s)

    def apply_dof_sharded(self, u_shard: torch.Tensor) -> torch.Tensor:
        """K @ u with u sharded over the ranks (each holds a contiguous
        chunk of the vector padded to a multiple of the rank count):
        all_gather u -> local element apply -> reduce_scatter."""
        u = comm.all_gather(u_shard).reshape(-1)
        ndof = 3 * self.op.n_nodes
        f = self._local_apply(u[:ndof])
        pad = u.shape[0] - ndof
        if pad:
            f = torch.cat([f, torch.zeros(pad, dtype=f.dtype, device=f.device)])
        return comm.reduce_scatter(f)


def batched_solve_cg(op, rhs_batch: torch.Tensor, M_inv, tol: float = 1e-8,
                     maxiter: int = 5000) -> torch.Tensor:
    """Solve K u = f for a batch of load cases, rhs_batch (n_cases, ndof):
    each rank runs CG on its contiguous share of the cases with no
    communication; one all_gather returns every case to every rank.
    `op` is any operator with apply_constrained (a plain one: each rank
    solves on its own)."""
    from femx_torch.solve.cg import pcg

    n, r = comm.world_size(), comm.rank()
    n_cases = rhs_batch.shape[0]
    per = -(-n_cases // n)
    mine = rhs_batch[r * per:(r + 1) * per]
    xs = [pcg(op.apply_constrained, f, M_inv_diag=M_inv, tol=tol, maxiter=maxiter).x
          for f in mine]
    out = torch.zeros((per,) + tuple(rhs_batch.shape[1:]), dtype=rhs_batch.dtype,
                      device=rhs_batch.device)
    if xs:
        out[:len(xs)] = torch.stack(xs)
    return comm.all_gather(out).reshape(n * per, -1)[:n_cases]
