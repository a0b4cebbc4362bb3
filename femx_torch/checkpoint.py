"""Checkpoint / resume for long iterative solves (port of femx/checkpoint.py).

The chunked CG driver persists its state between segments and resumes from
it after a crash or preemption. The file format is femx's, so a checkpoint
written by either package resumes in the other: `path`.npz holds the
arrays and `path`.json the metadata ({"iterations", "residual"}), both
written to a temporary file and renamed into place. The arrays are femx's
iterate "x" (the solver's internal DOF layout) and, from this package, the
CG recurrence state "r" and "p" as well (femx reads "x" alone): with them a
resumed solve continues the recurrences where they stopped, instead of
restarting CG from x (femx's scheme), which on the block-Jacobi default
case takes 16,894 iterations in chunks of 100 against 740 unchunked.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from femx_torch.solve.cg import CGResult, pcg


def save_state(path: str, arrays: dict, meta: Optional[dict] = None) -> None:
    """Atomically persist arrays (+ JSON-able metadata) to `path`.npz/.json."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")  # .npz so savez writes in place
    os.close(fd)
    np.savez(tmp, **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(v)) for k, v in arrays.items()})
    os.replace(tmp, path + ".npz")
    if meta is not None:
        with open(path + ".json.tmp", "w") as f:
            json.dump(meta, f)
        os.replace(path + ".json.tmp", path + ".json")


def load_state(path: str):
    """Returns (arrays dict, meta dict) or (None, None) if absent."""
    if not os.path.exists(path + ".npz"):
        return None, None
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return arrays, meta


def pcg_checkpointed(
    A: Optional[Callable],
    b: torch.Tensor,
    M_inv=None,
    tol: float = 1e-8,
    maxiter: int = 50000,
    chunk: int = 500,
    checkpoint_path: Optional[str] = None,
    verbose: bool = False,
    solve_chunk: Optional[Callable] = None,
) -> CGResult:
    """Chunked, checkpointable CG.

    Runs `chunk`-iteration CG segments, each continuing the previous one's
    recurrences, persisting (x, r, p, total_iterations) to
    `checkpoint_path` after each and resuming from it when present (an
    iterate of another shape is ignored). A file's recurrence state is used
    only when A is given and its residual r agrees with b - A x to 1e-6
    ||b||; otherwise (a femx file, or another system's) CG restarts from
    its x. `maxiter` counts the resumed iterations too.

    `solve_chunk(b, x0, r0, p0) -> CGResult` may be supplied (a route's own
    preconditioned or mixed-precision chunk, continuing from r0 and p0 when
    they are not None); otherwise one is built from (A, M_inv) with `pcg`.
    """
    x = torch.zeros_like(b)
    r = p = None
    done = 0
    if checkpoint_path:
        arrays, meta = load_state(checkpoint_path)
        if arrays is not None and arrays["x"].shape == tuple(b.shape):
            x = torch.as_tensor(arrays["x"], dtype=b.dtype, device=b.device)
            done = int(meta.get("iterations", 0))
            if A is not None and all(arrays.get(k, np.empty(0)).shape == x.shape
                                     for k in ("r", "p")):
                r_file = torch.as_tensor(arrays["r"], dtype=b.dtype, device=b.device)
                if float(torch.linalg.norm(r_file - (b - A(x)))) <= 1e-6 * float(
                        torch.linalg.norm(b)):
                    r = r_file
                    p = torch.as_tensor(arrays["p"], dtype=b.dtype, device=b.device)
            if verbose:
                how = "continuing CG" if r is not None else "restarting CG from x"
                print(f"[femx_torch.checkpoint] resumed at iteration {done}, {how}")

    if solve_chunk is None:
        def solve_chunk(fv, x0, r0, p0):
            return pcg(A, fv, M_inv_diag=M_inv, x0=x0, tol=tol, maxiter=chunk, r0=r0, p0=p0)

    res = None
    while done < maxiter:
        res = solve_chunk(b, x, r, p)
        x, r, p = res.x, res.r, res.p
        done += int(res.iterations)
        if checkpoint_path:
            state = {"x": x, "r": r, "p": p} if r is not None else {"x": x}
            save_state(checkpoint_path, state,
                       {"iterations": done, "residual": float(res.residual_norm)})
        if verbose:
            print(f"[femx_torch.checkpoint] {done} iters, residual "
                  f"{float(res.residual_norm):.3e}")
        if res.converged or res.iterations == 0:
            break
    return CGResult(
        x=x,
        iterations=done,
        residual_norm=res.residual_norm if res else float("inf"),
        converged=res.converged if res else False,
        r=r,
        p=p,
    )
