"""Dense direct solves for small systems (port of femx/solve/dense.py):
Cholesky with the Dirichlet mask imposed as S K S + (I - S), through
torch.linalg on the matrix's device."""

from __future__ import annotations

import numpy as np
import torch

from femx_torch.config import resolve_device


def apply_dirichlet_dense(K: torch.Tensor, f: torch.Tensor, free_mask):
    """Masked imposition (femx/bc.py:220): K~ = S K S + (I-S), f~ = S f.
    The solve of K~ u = f~ returns u == 0 on fixed DOFs."""
    s = torch.as_tensor(np.asarray(free_mask) if not isinstance(free_mask, torch.Tensor)
                        else free_mask, dtype=K.dtype, device=K.device)
    return K * s[:, None] * s[None, :] + torch.diag(1.0 - s), f * s


def solve_dense(K: torch.Tensor, f, free_mask=None, assume_spd: bool = True) -> torch.Tensor:
    """Solve K u = f, optionally under a Dirichlet mask (1 free / 0 fixed).
    SPD systems use Cholesky, others LU."""
    f = torch.as_tensor(f, dtype=K.dtype, device=K.device)
    if free_mask is not None:
        K, f = apply_dirichlet_dense(K, f, free_mask)
    if assume_spd:
        L = torch.linalg.cholesky(K)
        return torch.cholesky_solve(f[:, None], L)[:, 0]
    return torch.linalg.solve(K, f)


def partitioned_solve(K, f, fixed_dofs, prescribed=None, device=None) -> np.ndarray:
    """Host-partitioned solve (femx/solve/dense.py:32, the reference's
    BeamSolver.py:409-418): reduce to the free-free block with numpy
    indexing, solve it with solve_dense on `device` (None = CUDA), return
    the full displacement vector (host numpy, float64)."""
    dev = resolve_device(device)
    K = np.asarray(K, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    ndof = K.shape[0]
    fixed = np.asarray(fixed_dofs, dtype=np.int64)
    free = np.setdiff1d(np.arange(ndof), fixed)
    u = np.zeros(ndof)
    if prescribed is not None:
        u[fixed] = np.asarray(prescribed)
    rhs = f[free] - K[np.ix_(free, fixed)] @ u[fixed]
    u[free] = solve_dense(torch.as_tensor(K[np.ix_(free, free)], device=dev),
                          torch.as_tensor(rhs, device=dev)).cpu().numpy()
    return u
