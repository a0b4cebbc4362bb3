"""Carry operator and preconditioner state across from numpy arrays.

The "weights" of a structured solve are the operator and preconditioner
data. These builders take plain numpy arrays — for example read off femx
objects with ``np.asarray`` — so two implementations can run the very same
hierarchy (the same cell matrices, masks, block-Jacobi inverses, damping
and coarse inverse) and be compared iterate by iterate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.config import resolve_device
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
