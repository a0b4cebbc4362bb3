"""Preconditioned conjugate gradients, matrix-free (port of femx/solve/cg.py).

The loop is a Python loop with one host read per iteration for the stopping
test; every other scalar (alpha, beta, rz) stays a 0-d tensor on the
vectors' device and in their dtype, so float32 solves stay float32.

pcg is the multi-rank routes' CG too: their `dots` sum over the ranks, as
femx's psum'd dots in its shard_map CG loops (femx/parallel/halo.py:316).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from femx_torch.profiling import count, span


class CGResult(NamedTuple):
    x: torch.Tensor  # solution
    iterations: int
    residual_norm: float  # ||b - A x|| / ||b||
    converged: bool
    # pcg's recurrence state at exit (residual and search direction), from
    # which pcg(..., x0=x, r0=r, p0=p) continues as if never stopped
    r: Optional[torch.Tensor] = None
    p: Optional[torch.Tensor] = None


def _as_precond(M_inv) -> Callable[[torch.Tensor], torch.Tensor]:
    if M_inv is None:
        return lambda r: r
    if callable(M_inv):
        return M_inv
    return lambda r: M_inv * r


def _local_dots(*pairs) -> List[torch.Tensor]:
    """dot(a, b) for each (a, b), one 0-d tensor each."""
    return [torch.dot(a, b) for a, b in pairs]


def pcg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    M_inv_diag=None,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    maxiter: int = 10000,
    r0: Optional[torch.Tensor] = None,
    p0: Optional[torch.Tensor] = None,
    dots: Callable[..., Sequence[torch.Tensor]] = _local_dots,
) -> CGResult:
    """Preconditioned CG for SPD A.

    Args:
      A: linear operator (ndof,) -> (ndof,).
      b: right-hand side.
      M_inv_diag: preconditioner — an inverse diagonal tensor (Jacobi) or a
        callable r -> M^-1 r; identity if None.
      tol: relative residual target ||r|| <= tol * ||b||.
      r0, p0: with x0, a previous call's exit state (CGResult.r, .p): the
        recurrences continue from it (no initial residual apply), giving
        the iterates of one uninterrupted run.
      dots: dots((a, b), ...) -> one 0-d tensor per pair. On vectors split
        over ranks, comm.dots with the ownership weight: one all_reduce a
        call, two an iteration (r.r and r.z are formed together).

    The stopping test and breakdown guards are femx's: continue while
    ||r||^2 is finite, r.z > 0, ||r||^2 > (tol ||b||)^2 and k < maxiter;
    alpha = 0 when p.Ap <= 0, beta = 0 when the previous r.z <= 0.
    """
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    Minv = _as_precond(M_inv_diag)

    (bb,) = dots((b, b))
    bnorm = torch.sqrt(bb)
    bnorm_safe = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    atol2 = (tol * bnorm_safe) ** 2

    if r0 is None:
        with span("cg.apply"):
            r = b - A(x)
    else:
        r = r0.clone()
    with span("cg.precond"):
        z = Minv(r)
    p = z if r0 is None else p0.clone()
    rr, rz = dots((r, r), (r, z))
    k = 0
    while k < maxiter:
        go = torch.isfinite(rr) & (rz > 0) & (rr > atol2)
        with span("cg.wait"):
            stop = not bool(go)  # the one host read per iteration
        if stop:
            break
        with span("cg.apply"):
            Ap = A(p)
        (pAp,) = dots((p, Ap))
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        x = x + alpha * p
        r = r + (-alpha) * Ap
        with span("cg.precond"):
            z = Minv(r)
        rr, rz_new = dots((r, r), (r, z))
        beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        k += 1
    count("cg.iterations", k)
    res = float(torch.sqrt(rr) / bnorm_safe)
    return CGResult(x=x, iterations=k, residual_norm=res, converged=res <= tol, r=r, p=p)


def fcg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    M_inv=None,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    maxiter: int = 10000,
) -> CGResult:
    """Flexible preconditioned CG (Notay's FCG(1), femx.solve.cg.fcg):
    pcg with the Polak-Ribiere beta = (z, r - r_prev) / (z_prev, r_prev),
    which stays convergent when M^-1 varies between iterations or is mildly
    nonsymmetric (the one-sided multiplicative lattice preconditioner,
    mode="mult"). Same operator and preconditioner calls as pcg, one extra
    dot product per iteration."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    Minv = _as_precond(M_inv)

    bnorm = torch.sqrt(torch.dot(b, b))
    bnorm_safe = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    atol2 = (tol * bnorm_safe) ** 2

    r = b - A(x)
    z = Minv(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter:
        rr = torch.dot(r, r)
        go = torch.isfinite(rr) & (rz > 0) & (rr > atol2)
        if not bool(go):
            break
        Ap = A(p)
        pAp = torch.dot(p, Ap)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        x = x + alpha * p
        r_new = r + (-alpha) * Ap
        z = Minv(r_new)
        rz_new = torch.dot(r_new, z)
        beta = torch.where(rz > 0, (rz_new - torch.dot(r, z)) / rz, torch.zeros_like(rz))
        p = z + beta * p
        r, rz = r_new, rz_new
        k += 1
    res = float(torch.sqrt(torch.dot(r, r)) / bnorm_safe)
    return CGResult(x=x, iterations=k, residual_norm=res, converged=res <= tol)


def pcg_refined(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    M_inv_diag=None,
    tol: float = 1e-8,
    maxiter: int = 10000,
    refine_steps: int = 2,
    A_residual: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    residual_dtype: torch.dtype = torch.float64,
    b_residual: Optional[torch.Tensor] = None,
    outer_tol: float = 0.0,
) -> CGResult:
    """Mixed-precision PCG: low-precision inner solves + high-precision
    outer iterative refinement, with adaptive early exit and a divergence
    guard (femx.solve.cg.pcg_refined):

      r_k = b - A x_k        in residual_dtype (float64)
      d_k = A^-1 r_k         inner PCG in b's (low) precision
      x_{k+1} = x_k + d_k    accumulated in residual_dtype

    A pure-f32 residual is useless here: with K entries ~E*h and b ~O(1),
    f32 evaluation of b - A x carries ~1e-2 relative cancellation noise. A
    pass is accepted only if it lowers the true residual; otherwise it is
    dropped and the loop stops (past the f64 evaluation floor the inner CG
    on a noise residual can diverge).

    Args:
      A_residual: high-precision operator for the residuals (default A).
      b_residual: the unrounded right-hand side for the residuals (default b
        cast up).
      refine_steps: maximum number of refinement passes.
      outer_tol: true-residual target; passes stop once
        ||b - A x|| <= outer_tol ||b||.

    Returns x in residual_dtype; residual_norm is the true relative
    residual, iterations the total inner iterations, and converged tests
    outer_tol when one was given, else tol.
    """
    if A_residual is None:
        A_residual = A
    low_dtype = b.dtype

    result = pcg(A, b, M_inv_diag, tol=tol, maxiter=maxiter)
    b_h = (b if b_residual is None else b_residual).to(residual_dtype)
    bnorm = float(torch.sqrt(torch.dot(b_h, b_h)))
    bnorm_safe = bnorm if bnorm > 0 else 1.0

    x = result.x.to(residual_dtype)
    r = b_h - A_residual(x)
    rn = float(torch.sqrt(torch.dot(r, r))) / bnorm_safe
    total_it = result.iterations
    k = 0
    stop = False
    while not stop and rn > outer_tol and k < refine_steps:
        corr = pcg(A, r.to(low_dtype), M_inv_diag, tol=tol, maxiter=maxiter)
        x_new = x + corr.x.to(residual_dtype)
        r_new = b_h - A_residual(x_new)
        rn_new = float(torch.sqrt(torch.dot(r_new, r_new))) / bnorm_safe
        stop = not rn_new < rn
        if not stop:
            x, r, rn = x_new, r_new, rn_new
        total_it += corr.iterations
        k += 1
    target = outer_tol if outer_tol > 0 else tol
    return CGResult(x=x, iterations=total_it, residual_norm=rn, converged=rn <= target)


def pcg_mixed(
    A_high: Callable[[torch.Tensor], torch.Tensor],
    b_high: torch.Tensor,
    M_inv_low: Callable[[torch.Tensor], torch.Tensor],
    tol: float = 1e-8,
    maxiter: int = 10000,
    low_dtype: torch.dtype = torch.float32,
    x0: Optional[torch.Tensor] = None,
    r0: Optional[torch.Tensor] = None,
    p0: Optional[torch.Tensor] = None,
    dots: Callable[..., Sequence[torch.Tensor]] = _local_dots,
) -> CGResult:
    """High-precision PCG with a low-precision preconditioner
    (femx.solve.cg.pcg_mixed): the CG recurrences, the operator and the
    residual run in b_high's precision (float64); the preconditioner runs
    in low_dtype on the residual cast down, its result cast back up.

    Unlike pcg_refined, the Krylov method runs on the exact high-precision
    operator, so the low-precision operator inside the preconditioner may
    differ from it (a float32-rounded cell matrix) and only the rate pays.
    x0 (with r0, p0: pcg's exit state) resumes it, as pcg does (the chunks
    of a checkpointed solve); dots is pcg's.
    """
    def minv(r):
        return M_inv_low(r.to(low_dtype)).to(b_high.dtype)

    return pcg(A_high, b_high, M_inv_diag=minv, x0=x0, tol=tol, maxiter=maxiter, r0=r0,
               p0=p0, dots=dots)
