"""Carry operator and preconditioner state across from numpy arrays.

The "weights" of a solve are the operator and preconditioner data. These
builders take plain numpy arrays — for example read off femx objects with
``np.asarray`` — so two implementations can run the very same operator and
hierarchy (cell matrices, masks, block-Jacobi inverses, damping, coarse
inverse; unstructured geometry factors, connectivity, degree buckets and
relabelling; lattice transfer indices, weights, buckets and ranks) and be
compared iterate by iterate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from femx_torch.assembly_soa import SolidOperatorSoA
from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.assembly_tg import SolidOperatorTG
from femx_torch.config import numpy_dtype, resolve_device
from femx_torch.elements.tet10_soa import dof_table
from femx_torch.solve.lattice_precond import (
    LatticePreconditioner, LatticeTransfer, LatticeTransferPruned)
from femx_torch.solve.multigrid import StructuredMultigrid, _Level


def structured_operator_from_arrays(
    Kcell, n_cells, grid_shape, weight, spacing, free_mask=None,
    x_weight=None, y_weight=None, z_weight=None, device=None,
) -> StructuredSolidOperator:
    """A StructuredSolidOperator from its arrays; Kcell's dtype is the
    operator's. grid_shape must be 2 * n_cells + 1."""
    op = StructuredSolidOperator.from_host(
        np.asarray(Kcell), n_cells, weight, spacing=spacing,
        free_mask=None if free_mask is None else np.asarray(free_mask),
        x_weight=x_weight, y_weight=y_weight, z_weight=z_weight, device=device)
    if tuple(int(g) for g in grid_shape) != op.grid_shape:
        raise ValueError(f"grid_shape {tuple(grid_shape)} does not match "
                         f"n_cells {op.n_cells}")
    return op


def multigrid_from_arrays(
    levels: Sequence[dict], omegas, coarse_inv, coarsen_axes, pad_nodes,
    crop_nodes=(0, 0, 0), n_smooth: int = 2, smoother: str = "jacobi",
    lmaxs: Optional[Sequence[float]] = None, cheb_lower: float = 1.0 / 30.0,
    cheb_upper: float = 1.1, device=None,
) -> StructuredMultigrid:
    """A StructuredMultigrid from its arrays.

    levels: one dict per level, finest first, with the keyword arguments of
    structured_operator_from_arrays (Kcell, n_cells, grid_shape, weight,
    spacing, free_mask and optional x/y/z_weight) plus "binv", the 8
    per-phase (3, 3, cnt) block-Jacobi inverse tensors.
    """
    dev = resolve_device(device)
    lv = []
    for spec in levels:
        spec = dict(spec)
        binv = spec.pop("binv")
        op = structured_operator_from_arrays(**spec, device=dev)
        lv.append(_Level(op=op, binv=[torch.tensor(np.asarray(b), device=dev)
                                      for b in binv]))
    return StructuredMultigrid.from_parts(
        lv, omegas, torch.tensor(np.asarray(coarse_inv), device=dev),
        coarsen_axes, pad_nodes, crop_nodes=crop_nodes, n_smooth=n_smooth,
        smoother=smoother, lmaxs=lmaxs, cheb_lower=cheb_lower,
        cheb_upper=cheb_upper)


def soa_operator_from_arrays(dNg, wdet, C6, connT, n_nodes, weight, free_mask=None,
                             device=None) -> SolidOperatorSoA:
    """A SolidOperatorSoA from femx's arrays: dNg (4, 3, 10, E) and wdet
    (4, E) set the dtype; connT (10, E) is the element connectivity."""
    dev = resolve_device(device)
    dNg = torch.tensor(np.asarray(dNg), device=dev)
    op = SolidOperatorSoA(
        dofs=torch.as_tensor(dof_table(np.asarray(connT).T), dtype=torch.int64, device=dev),
        dNg=dNg, wdet=torch.tensor(np.asarray(wdet), dtype=dNg.dtype, device=dev),
        C6=np.asarray(C6).astype(numpy_dtype(dNg.dtype)), n_nodes=int(n_nodes),
        weight=float(weight))
    return op if free_mask is None else op.with_free_mask(np.asarray(free_mask))


def tg_operator_from_arrays(dNg, wdet, C6, connT, bucket_idx, bucket_degrees, new_of_old,
                            weight, free_mask=None, device=None) -> SolidOperatorTG:
    """A SolidOperatorTG from femx's arrays (its .soa geometry, connT, the
    per-degree buckets and the node relabelling; free_mask in the internal
    layout)."""
    soa = soa_operator_from_arrays(dNg, wdet, C6, connT, len(new_of_old), weight,
                                   device=device)
    op = SolidOperatorTG.from_arrays(soa, connT, bucket_idx, bucket_degrees, new_of_old)
    return op if free_mask is None else op.with_free_mask(np.asarray(free_mask))


def lattice_transfer_from_arrays(arrays: dict, dtype=np.float64, device=None):
    """A lattice transfer from femx's arrays: the pruned form for the keys
    n_idx, n_w, node_rank, l_idx, l_w, lat_rank, phase_counts; the dense
    form for idx, w, bucket_idx, bucket_w, perm_back, phase_counts."""
    cls = LatticeTransferPruned if "n_idx" in arrays else LatticeTransfer
    return cls.from_host(**arrays, dtype=dtype, device=device)


def lattice_preconditioner_from_arrays(
    multigrid: dict, transfer: dict, mask_cal, bj_data, n_nodes, n_cells, spacing,
    dtype=np.float64, coarse_weight: float = 1.0, mode: str = "add", op=None,
    omega: Optional[float] = None, n_cycles: int = 2, n_cal: Optional[int] = None,
    device=None,
) -> LatticePreconditioner:
    """A LatticePreconditioner from femx's arrays: `multigrid` holds the
    keyword arguments of multigrid_from_arrays, `transfer` those of
    lattice_transfer_from_arrays, bj_data the (3, 3, N) block-Jacobi
    tensors of SolidOperatorSoA (applied with its apply_block_jacobi)."""
    dev = resolve_device(device)
    mg = multigrid_from_arrays(**multigrid, device=dev)
    tdt = mg.fine_op.Kcell.dtype
    return LatticePreconditioner.from_parts(
        mg, lattice_transfer_from_arrays(transfer, dtype=dtype, device=dev),
        torch.tensor(np.asarray(mask_cal), dtype=tdt, device=dev),
        SolidOperatorSoA.apply_block_jacobi,
        torch.tensor(np.asarray(bj_data), dtype=tdt, device=dev),
        n_nodes=n_nodes, n_cells=n_cells, spacing=spacing, coarse_weight=coarse_weight,
        mode=mode, op=op, omega=omega, n_cycles=n_cycles, n_cal=n_cal)
