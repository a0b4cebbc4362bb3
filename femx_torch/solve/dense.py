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
    SPD systems use Cholesky (NaNs when K is not positive definite), others
    LU."""
    f = torch.as_tensor(f, dtype=K.dtype, device=K.device)
    if free_mask is not None:
        K, f = apply_dirichlet_dense(K, f, free_mask)
    if assume_spd:
        # as jax.scipy's cho_factor, a matrix that is not positive definite
        # gives NaNs, not an exception (femx's shaft with free_torsion=True
        # solves its singular, unloaded static problem this way)
        L, info = torch.linalg.cholesky_ex(K)
        u = torch.cholesky_solve(f[:, None], L)[:, 0]
        return u if int(info) == 0 else torch.full_like(u, float("nan"))
    return torch.linalg.solve(K, f)


def _free_block(K, rows: np.ndarray, cols: np.ndarray, dev) -> torch.Tensor:
    """K[rows][:, cols] as a float64 tensor on dev; a tensor K is indexed
    where it lies, a host array on the host."""
    if isinstance(K, torch.Tensor):
        r = torch.as_tensor(rows, device=K.device)
        c = torch.as_tensor(cols, device=K.device)
        return K.index_select(0, r).index_select(1, c).to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.asarray(K, dtype=np.float64)[np.ix_(rows, cols)], device=dev)


def partitioned_solve(K, f, fixed_dofs, prescribed=None, device=None) -> np.ndarray:
    """Partitioned solve (femx/solve/dense.py:32, the reference's
    BeamSolver.py:409-418): reduce to the free-free block, solve it with
    solve_dense on `device` (None = CUDA), return the full displacement
    vector (host numpy, float64). K is a host array or a tensor (a tensor
    is partitioned on its own device, so an assembled K never leaves it)."""
    dev = resolve_device(device)
    f = np.asarray(f, dtype=np.float64)
    ndof = K.shape[0]
    fixed = np.asarray(fixed_dofs, dtype=np.int64)
    free = np.setdiff1d(np.arange(ndof), fixed)
    u = np.zeros(ndof)
    if prescribed is not None:
        u[fixed] = np.asarray(prescribed)
    rhs = (torch.as_tensor(f[free], device=dev)
           - _free_block(K, free, fixed, dev) @ torch.as_tensor(u[fixed], device=dev))
    u[free] = solve_dense(_free_block(K, free, free, dev), rhs).cpu().numpy()
    return u
