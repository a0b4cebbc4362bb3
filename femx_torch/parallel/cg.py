"""Preconditioned CG on rank-local vectors: femx_torch.solve.cg.pcg with
every dot product summed over the ranks (femx's psum'd dots inside its
shard_map CG loops, femx/parallel/halo.py:316-360).

Two all_reduces per iteration: p.Ap, and (r.r, r.z) together; the stopping
test reads r.r on the host once per iteration, as pcg does. The stopping
test and breakdown guards are femx's. Traced, it records pcg's spans and
counter: cg.apply, cg.precond and cg.wait for the start and each iteration,
and cg.iterations.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from femx_torch.parallel import comm
from femx_torch.profiling import count, span
from femx_torch.solve.cg import CGResult


def pcg_dist(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             minv: Callable[[torch.Tensor], torch.Tensor], tol: float = 1e-8,
             maxiter: int = 10000, x0: Optional[torch.Tensor] = None,
             weight: Optional[torch.Tensor] = None, r0: Optional[torch.Tensor] = None,
             p0: Optional[torch.Tensor] = None) -> CGResult:
    """PCG for an SPD operator whose vectors are split over the ranks.

    A, minv: local callables (their own exchanges inside). weight: 1/0 per
    local entry so a summed dot counts every DOF once (None: each entry is
    owned by one rank). x0 with r0, p0 (a previous call's CGResult.r, .p)
    continues its recurrences. The result's x, r, p are local."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    (bb,) = comm.dots((b, b), weight=weight)
    bnorm = torch.sqrt(bb)
    bnorm_safe = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    atol2 = (tol * bnorm_safe) ** 2
    if r0 is None:
        with span("cg.apply"):
            r = b - A(x)
    else:
        r = r0.clone()
    with span("cg.precond"):
        z = minv(r)
    p = z if r0 is None else p0.clone()
    rr, rz = comm.dots((r, r), (r, z), weight=weight)
    k = 0
    while k < maxiter:
        go = torch.isfinite(rr) & (rz > 0) & (rr > atol2)
        with span("cg.wait"):
            stop = not bool(go)  # the one host read per iteration
        if stop:
            break
        with span("cg.apply"):
            Ap = A(p)
        (pAp,) = comm.dots((p, Ap), weight=weight)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        x = x + alpha * p
        r = r + (-alpha) * Ap
        with span("cg.precond"):
            z = minv(r)
        rr, rz_new = comm.dots((r, r), (r, z), weight=weight)
        beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        k += 1
    count("cg.iterations", k)
    res = float(torch.sqrt(rr) / bnorm_safe)
    return CGResult(x=x, iterations=k, residual_norm=res, converged=res <= tol, r=r, p=p)
