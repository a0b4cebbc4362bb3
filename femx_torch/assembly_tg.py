"""Transpose-gather (scatter-free) unstructured solid operator (port of
femx/assembly_tg.py) — the operator of arbitrary Tet10 meshes.

K @ u without a scatter:

  1. ue rows:   u3[connT]                 (10, E, 3) row gather
  2. physics:   femx_torch.elements.tet10_soa element kernel (einsums)
  3. transpose: each node SUMS the fe rows that reference it, as a row
     gather from fe3 (10E, 3) by precomputed inverse indices. Nodes are
     relabelled by degree at setup so equal-degree nodes are contiguous:
     each degree d is one dense (n_d, d) gather plus a sum over d, and the
     per-degree results concatenate back in node order.

Every row gather (step 1 and each bucket of step 3) is
femx_torch.gather.take_rows, the hand-written CUDA kernel on the card; the
bucket sums and the concatenation stay torch ops, as they stay XLA in femx.
The operator runs in its internal degree-sorted node order; `to_internal` /
`to_global` convert once per solve on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from femx_torch.assembly_soa import SolidOperatorSoA
from femx_torch.config import resolve_device
from femx_torch.elements import tet10_soa
from femx_torch.elements.tet10 import GAUSS_WEIGHT_CORRECT
from femx_torch.gather import index_tensor, take_rows


def degree_buckets(node_of_pos: np.ndarray, n_nodes: int):
    """Transpose structure of an incidence list: node_of_pos[p] is the
    (internal, degree-sorted) node of incidence p. Returns, per degree d in
    ascending order, (d, (n_d, d) incidence positions): the positions of
    the n_d consecutive nodes of degree d, each row in position order."""
    degrees = np.bincount(node_of_pos, minlength=n_nodes)
    if np.any(np.diff(degrees) < 0):
        raise ValueError("nodes are not sorted by degree")
    order = np.argsort(node_of_pos, kind="stable")
    out, pos = [], 0
    for d in np.unique(degrees):
        n_d, d = int((degrees == d).sum()), int(d)
        out.append((d, order[pos:pos + n_d * d].reshape(n_d, d)))
        pos += n_d * d
    return out


@dataclasses.dataclass(eq=False)
class SolidOperatorTG:
    """Matrix-free K for unstructured Tet10 meshes, scatter-free apply."""

    soa: SolidOperatorSoA  # on the relabelled mesh (internal order)
    connT: torch.Tensor  # (10, E) internal node ids (int32 on the card)
    bucket_idx: List[torch.Tensor]  # per degree (n_d, d) rows into fe3
    bucket_degrees: List[int]
    new_of_old: np.ndarray  # node relabel old -> internal
    free_mask: Optional[torch.Tensor] = None  # internal DOF layout

    @classmethod
    def from_mesh(cls, points, conn, E_mod, nu, weight=None, dtype=np.float32,
                  device=None):
        """Build from host mesh arrays on `device`. Returns (op, detJ)."""
        if weight is None:
            weight = GAUSS_WEIGHT_CORRECT
        dev = resolve_device(device)
        points = np.asarray(points)
        conn = np.asarray(conn)
        n_nodes = len(points)

        # degree-sorted relabelling (stable: keeps the input's order, and so
        # its locality, within a degree class)
        degrees = np.bincount(conn.reshape(-1), minlength=n_nodes)
        new_of_old = np.argsort(np.argsort(degrees, kind="stable"), kind="stable")
        old_of_new = np.argsort(new_of_old, kind="stable")
        conn_int = new_of_old[conn]
        soa, detJ = SolidOperatorSoA.from_mesh(points[old_of_new], conn_int, E_mod, nu,
                                               weight=weight, dtype=dtype, device=dev)
        # fe3 row of (element e, local slot s) = s * E + e
        buckets = degree_buckets(conn_int.T.reshape(-1), n_nodes)
        op = cls.from_arrays(soa, conn_int.T, [b for _, b in buckets],
                             [d for d, _ in buckets], new_of_old)
        return op, detJ

    @classmethod
    def from_arrays(cls, soa: SolidOperatorSoA, connT, bucket_idx, bucket_degrees,
                    new_of_old) -> "SolidOperatorTG":
        """The operator from its host index arrays (range-checked once
        here: the gather kernel trusts them) around a built SoA operator."""
        dev = soa.device
        connT = np.asarray(connT)
        n_pos = connT.size
        degs = [int(d) for d in bucket_degrees]
        blocks = [np.asarray(b) for b in bucket_idx]
        if any(b.ndim != 2 or b.shape[1] != d for b, d in zip(blocks, degs)):
            raise ValueError("each bucket must be an (n_d, d) index block")
        if sum(b.size for b in blocks) != n_pos:
            raise ValueError("bucket indices do not cover every incidence once")
        idx = [index_tensor(b, n_pos, dev) for b in blocks]
        return cls(soa=soa, connT=index_tensor(connT, soa.n_nodes, dev), bucket_idx=idx,
                   bucket_degrees=degs, new_of_old=np.asarray(new_of_old))

    # -- layout ------------------------------------------------------------
    @property
    def ndof(self) -> int:
        return self.soa.ndof

    @property
    def n_nodes(self) -> int:
        return self.soa.n_nodes

    @property
    def n_elements(self) -> int:
        return self.soa.n_elements

    @property
    def dtype(self) -> torch.dtype:
        return self.soa.dtype

    @property
    def device(self) -> torch.device:
        return self.soa.device

    @property
    def gathers_per_apply(self) -> int:
        """take_rows launches of one apply: u3[connT] and one per nonempty
        degree bucket."""
        return 1 + sum(1 for d in self.bucket_degrees if d > 0)

    def to_internal(self, x: np.ndarray) -> np.ndarray:
        """Global (3*node+comp) vector -> internal degree-sorted order."""
        x3 = np.asarray(x).reshape(self.n_nodes, 3)
        out = np.empty_like(x3)
        out[self.new_of_old] = x3
        return out.reshape(-1)

    def to_global(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y).reshape(self.n_nodes, 3)[self.new_of_old].reshape(-1)

    def with_free_mask(self, free_mask_internal) -> "SolidOperatorTG":
        soa = self.soa.with_free_mask(free_mask_internal)
        return dataclasses.replace(self, soa=soa, free_mask=soa.free_mask)

    def astype(self, dtype) -> "SolidOperatorTG":
        """The same operator with its geometry factors and mask cast."""
        soa = self.soa.astype(dtype)
        if soa.dtype == self.dtype:
            return self
        return dataclasses.replace(self, soa=soa, free_mask=soa.free_mask)

    # -- core ----------------------------------------------------------------
    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u (internal layout), no scatters."""
        E = self.n_elements
        ue3 = take_rows(u.reshape(self.n_nodes, 3), self.connT)  # (10, E, 3)
        ue = ue3.transpose(1, 2).reshape(30, E)
        fe = tet10_soa.apply_element_forces(self.soa.dNg, self.soa.wdet, self.soa.C6, ue,
                                            self.soa.weight)  # (30, E)
        fe3 = fe.reshape(10, 3, E).transpose(1, 2).reshape(10 * E, 3)
        parts = [take_rows(fe3, idx).sum(dim=1) if d else
                 torch.zeros((idx.shape[0], 3), dtype=fe3.dtype, device=fe3.device)
                 for idx, d in zip(self.bucket_idx, self.bucket_degrees)]
        return torch.cat(parts).reshape(-1)

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.free_mask
        return self.apply(u * s) * s + u * (1.0 - s)

    # -- preconditioning ------------------------------------------------------
    def diagonal(self) -> torch.Tensor:
        return self.soa.diagonal()

    def block_jacobi_preconditioner(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return self.soa.block_jacobi_preconditioner()
