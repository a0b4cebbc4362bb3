"""Multi-rank structured operator: z-slab cell decomposition with one
all_reduce per apply (port of femx/parallel/structured.py).

The cell grid is split into contiguous z-slabs, one per rank. Each rank
applies its slab's cells (the port's gather-free structured apply: the
structured_cell_matmul kernel on the card) against the replicated
displacement vector, and the per-rank nodal forces are summed with one
all_reduce of the solution-sized vector. The shared lattice plane between
two slabs gets both ranks' contributions from that sum.
"""

from __future__ import annotations

from typing import List

import torch

from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.parallel import comm


class ShardedStructuredOperator:
    """K @ u for a structured box mesh with its cells z-slab-sharded over
    the ranks. Built from the single-device operator; needs nz % ranks ==
    0 and no per-layer cell weights (the ghost-padded distributed path is
    femx_torch.parallel.driver). apply / apply_constrained take and return
    the full internal phase vector, replicated."""

    def __init__(self, op: StructuredSolidOperator, mesh=None):
        nx, ny, nz = op.n_cells
        ndev = comm.world_size() if mesh is None else mesh.size
        if nz % ndev:
            raise ValueError(f"nz={nz} cells must divide the rank count {ndev}")
        if op.z_weight is not None or op.x_weight is not None or op.y_weight is not None:
            raise ValueError(
                "ShardedStructuredOperator does not support per-layer cell weights "
                "(x/y/z_weight); use femx_torch.parallel.driver for ghost-padded "
                "distributed solves")
        self.op = op
        self.ndev = ndev
        self.nzl = nz // ndev
        self.local = StructuredSolidOperator.from_host(
            op.Kcell_host, (nx, ny, self.nzl), op.weight, spacing=op.spacing,
            device=op.device, apply_form=op.apply_form)

    def _slab_phases(self, phases: List[torch.Tensor], d: int) -> List[torch.Tensor]:
        """Rank d's slab of each phase grid: phase-z indices from k0 = d*nzl,
        nzl+1 of them for pz=0 and nzl for pz=1."""
        k0 = d * self.nzl
        return [g[..., k0:k0 + self.nzl + 1 - (i % 2)] for i, g in enumerate(phases)]

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u (internal layout, replicated in and out)."""
        d = comm.rank()
        phases = self.op._split_phases(u)
        slab = torch.cat([g.reshape(-1) for g in self._slab_phases(phases, d)])
        f_slab = self.local._split_phases(self.local.apply(slab))
        out = torch.zeros_like(u)
        for g, s in zip(self._slab_phases(self.op._split_phases(out), d), f_slab):
            g.copy_(s)
        return comm.all_reduce(out)

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.op.free_mask
        return self.apply(u * s) * s + u * (1.0 - s)
