"""Distributed solid modal analysis: shift-invert Lanczos whose inner
K-solves run z-slab-distributed (port of femx/parallel/modal.py).

femx_torch.modal.modal_shift_invert with pcg_halo + DistributedMultigrid
as the inner solve: each Lanczos step is one distributed MG-PCG call, and
the Lanczos recurrence runs replicated on every rank in the full internal
layout, the same math as the single-device path.
"""

from __future__ import annotations

import numpy as np

from femx_torch.config import torch_dtype
from femx_torch.modal import ModalResult, modal_shift_invert
from femx_torch.parallel.halo import DistributedMultigrid, pcg_halo


def modal_shift_invert_halo(dmg: DistributedMultigrid, m_diag_internal, free_mask_internal,
                            n_modes: int = 10, tol: float = 1e-4, maxiter: int = 100,
                            inner_tol: float = 1e-6, inner_maxiter: int = 4000,
                            preconditioner=None, v0=None) -> ModalResult:
    """First n_modes of K v = lambda M v with distributed inner solves.

    dmg: DistributedMultigrid over the constrained structured operator (its
    fine level is the K inverted). m_diag_internal, free_mask_internal:
    (ndof,) lumped mass and 1/0 mask, internal layout, host. v0: an optional
    start vector (femx's, for iteration parity). Returns a ModalResult in
    the internal layout (convert modes with op.to_global), its
    inner_iterations the inner solves' counts."""
    prec = dmg if preconditioner is None else preconditioner
    its = []

    def k_solve(b):
        x, it, res, ok = pcg_halo(dmg.halo, b, tol=inner_tol, maxiter=inner_maxiter,
                                  preconditioner=prec, as_tensor=True)
        # a stalled inner solve is not K^-1 b: femx's 10x slack, then raise
        if not ok and (not np.isfinite(res) or res > 10 * inner_tol):
            raise RuntimeError(f"distributed inner solve did not converge (residual "
                               f"{res:.3e}, tol {inner_tol:.1e}); raise inner_maxiter "
                               "or loosen inner_tol")
        its.append(it)
        return x

    op = dmg.mg.levels[0].op
    res = modal_shift_invert(k_solve, m_diag_internal, free_mask_internal, n_modes=n_modes,
                             tol=tol, maxiter=maxiter, dtype=torch_dtype(op.dtype), v0=v0,
                             device=op.device)
    return res._replace(inner_iterations=its)
