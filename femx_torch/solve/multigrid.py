"""Geometric multigrid preconditioner for the structured solid operator
(port of femx/solve/multigrid.py).

A symmetric V-cycle — damped block-Jacobi (or Chebyshev) smoothing,
trilinear transfers on the nested half-spaced lattices, a dense coarsest
inverse — used as the preconditioner of CG. Grid hierarchy: per level, every
axis whose cell count is even and > 2 halves (semi-coarsening, exact
rediscretisation); when no even axis is left and the level is still too big
for the dense coarsest solve, odd axes are ghost-padded to even (fractional
straddle-cell weights + zero-embed/slice transfers) and coarsening goes on.
Uniform 2x steps reuse the cell stiffness by exact rescaling (K(2h) = 2K(h));
semi-coarsened steps re-assemble the one (81, 81) cell matrix.

Setup (cell matrices, block-Jacobi blocks, power iterations, the coarse
inverse) runs on the host; each level's operator, block-Jacobi tensors and
the coarse inverse then move to the device once. Restriction is exactly the
transpose of prolongation, which keeps the V-cycle SPD for CG.

On a CUDA device a hierarchy replays its V-cycle as one CUDA graph: its
first call runs the V-cycle eagerly (which fills the caches a capture must
not fill: the packed cell matrices, the launch plans), its second captures
it and replays it, and every later call replays it. The graph reads the
caller's residual and writes its result through two addresses held on the
device (`_VcycleGraph`), so between calls it keeps 16 bytes allocated and
no vector. Its buffers, the V-cycle's transients and a cuBLAS workspace
live in one memory pool per device that every V-cycle graph shares
(`_capture_place`): free between replays, but reserved for the graphs
alone for as long as the process runs, about what one eager V-cycle of the
largest hierarchy needs (on the H100, the 1.6M-DOF box's: PERF.md). The
eager V-cycle and the replay launch the same kernels in the same order and
return the same bits. The CPU, an input unlike the captured one, and a call
inside another capture stay eager: `_VcycleRoute`, DistributedMultigrid's
too.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from femx_torch import gather
from femx_torch.assembly_structured import (
    _SLOTS, StructuredSolidOperator, _cell_stiffness)
from femx_torch.config import resolve_device
from femx_torch.profiling import count, span, tally


# ---------------------------------------------------------------------------
# Persistent hierarchy cache (femx/solve/multigrid.py:42-140): the setup
# products that cost seconds at the flagship (per-level block-Jacobi
# inverses, smoother damping, the dense coarse inverse) are pure functions
# of (n_cells, spacing, E, nu, weight, dtype, smoother parameters, fine
# mask), so they are saved as .npz and reloaded by later runs. femx's key
# and payload; the directory is FEMX_MG_CACHE, by default the port's build
# directory (build/femx_torch/mg_cache in the checkout; femx's default is
# ~/.cache/femx_mg). FEMX_MG_CACHE=0 (or off, or empty) disables it.
# ---------------------------------------------------------------------------
_MG_CACHE_VERSION = 5


def _mg_cache_dir() -> Optional[str]:
    from femx_torch.build import BUILD_DIR

    d = os.environ.get("FEMX_MG_CACHE", str(BUILD_DIR / "mg_cache"))
    return None if d in ("0", "off", "") else d


def _mg_cache_key(n, sp, E, nu, weight, dtype, n_smooth, omega, coarse_dof_limit, mask_grid,
                  extra: str = "") -> str:
    """femx's key: the hierarchy's inputs and the fine mask's bits."""
    h = hashlib.sha256()
    key = (_MG_CACHE_VERSION, tuple(n), tuple(sp), float(E), float(nu),
           None if weight is None else float(weight), np.dtype(dtype).name, int(n_smooth),
           float(omega), int(coarse_dof_limit))
    h.update(repr(key + ((extra,) if extra else ())).encode())
    h.update(np.packbits(np.ascontiguousarray(mask_grid > 0.5).reshape(-1)).tobytes())
    return h.hexdigest()[:32]


def _mg_cache_load(key: str) -> Optional[dict]:
    d = _mg_cache_dir()
    path = None if d is None else os.path.join(d, f"hier_{key}.npz")
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception:  # noqa: BLE001 - a corrupt or partial file is a miss
        return None


def _mg_cache_save(key: str, payload: dict) -> None:
    d = _mg_cache_dir()
    if d is None:
        return
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")  # .npz: savez writes in place
        os.close(fd)
        np.savez(tmp, **payload)
        os.replace(tmp, os.path.join(d, f"hier_{key}.npz"))
        _mg_cache_trim(d)
    except OSError:
        pass  # best-effort: the solve goes on without it


def _mg_cache_trim(d: str, cap_bytes: int = 8 << 30) -> None:
    """Drop the least recently used entries past `cap_bytes`
    (FEMX_MG_CACHE_GB overrides the 8 GB default)."""
    cap = int(float(os.environ.get("FEMX_MG_CACHE_GB", 0)) * 2**30) or cap_bytes
    entries, total = [], 0
    for name in os.listdir(d):
        if not (name.startswith("hier_") and name.endswith(".npz")):
            continue
        p = os.path.join(d, name)
        try:
            st = os.stat(p)
        except OSError:
            continue
        entries.append((st.st_atime, st.st_size, p))
        total += st.st_size
    for _, size, p in sorted(entries):
        if total <= cap:
            break
        try:
            os.remove(p)
            total -= size
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Contiguity helpers: transfers as reshapes, middle-axis slices and
# concatenations.
# ---------------------------------------------------------------------------
def _axis_split(G: torch.Tensor, axis: int):
    """(..., 2n+1, ...) -> even part (n+1) and odd part (n) along `axis`."""
    n = (G.shape[axis] - 1) // 2
    lead = int(np.prod(G.shape[:axis], dtype=np.int64))
    trail = int(np.prod(G.shape[axis + 1:], dtype=np.int64))
    R = G.reshape(lead, G.shape[axis], trail)
    pairs = R[:, :2 * n, :].reshape(lead, n, 2, trail)
    even = torch.cat([pairs[:, :, 0, :], R[:, 2 * n:, :]], dim=1)
    odd = pairs[:, :, 1, :]
    sh = list(G.shape)
    sh[axis] = n + 1
    sh_o = list(G.shape)
    sh_o[axis] = n
    return even.reshape(sh), odd.reshape(sh_o)


def _axis_interleave(even: torch.Tensor, odd: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of _axis_split: interleave (n+1) evens with (n) odds -> 2n+1."""
    n = odd.shape[axis]
    lead = int(np.prod(even.shape[:axis], dtype=np.int64))
    trail = int(np.prod(even.shape[axis + 1:], dtype=np.int64))
    E = even.reshape(lead, n + 1, trail)
    O = odd.reshape(lead, n, trail)
    inter = torch.stack([E[:, :n, :], O], dim=2).reshape(lead, 2 * n, trail)
    out = torch.cat([inter, E[:, n:, :]], dim=1)
    sh = list(even.shape)
    sh[axis] = 2 * n + 1
    return out.reshape(sh)


def _join_full(op: StructuredSolidOperator, u: torch.Tensor) -> torch.Tensor:
    """Internal phase vector -> (3, Px, Py, Pz) doubled-lattice grid."""
    phases = op._split_phases(u)  # index px*4 + py*2 + pz
    m_z = [_axis_interleave(phases[i], phases[i + 1], 3) for i in (0, 2, 4, 6)]
    m_y = [_axis_interleave(m_z[i], m_z[i + 1], 2) for i in (0, 2)]
    return _axis_interleave(m_y[0], m_y[1], 1)


def _split_full(op: StructuredSolidOperator, G: torch.Tensor) -> torch.Tensor:
    """(3, Px, Py, Pz) doubled-lattice grid -> internal phase vector."""
    parts = []
    for gx in _axis_split(G, 1):
        for gy in _axis_split(gx, 2):
            parts.extend(g.reshape(-1) for g in _axis_split(gy, 3))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Trilinear transfers on nested doubled lattices
# ---------------------------------------------------------------------------
def _interp_axis(G: torch.Tensor, axis: int) -> torch.Tensor:
    """Coarse grid (n points along axis) -> fine (2n-1): copy + midpoints."""
    n = G.shape[axis]
    lead = int(np.prod(G.shape[:axis], dtype=np.int64))
    trail = int(np.prod(G.shape[axis + 1:], dtype=np.int64))
    R = G.reshape(lead, n, trail)
    mid = 0.5 * (R[:, :-1, :] + R[:, 1:, :])
    inter = torch.stack([R[:, :-1, :], mid], dim=2).reshape(lead, 2 * (n - 1), trail)
    out = torch.cat([inter, R[:, -1:, :]], dim=1)
    sh = list(G.shape)
    sh[axis] = 2 * n - 1
    return out.reshape(sh)


def _restrict_axis(G: torch.Tensor, axis: int) -> torch.Tensor:
    """Transpose of _interp_axis: out[q] = F[2q] + 0.5*(F[2q-1] + F[2q+1])."""
    even, odd = _axis_split(G, axis)
    lead = int(np.prod(even.shape[:axis], dtype=np.int64))
    trail = int(np.prod(even.shape[axis + 1:], dtype=np.int64))
    n = odd.shape[axis]
    E = even.reshape(lead, n + 1, trail)
    O = odd.reshape(lead, n, trail)
    zero = torch.zeros((lead, 1, trail), dtype=G.dtype, device=G.device)
    left = torch.cat([zero, O], dim=1)
    right = torch.cat([O, zero], dim=1)
    return (E + 0.5 * (left + right)).reshape(even.shape)


def prolong(G_coarse: torch.Tensor, axes=(1, 2, 3)) -> torch.Tensor:
    for ax in axes:
        G_coarse = _interp_axis(G_coarse, ax)
    return G_coarse


def restrict(G_fine: torch.Tensor, axes=(1, 2, 3)) -> torch.Tensor:
    for ax in axes:
        G_fine = _restrict_axis(G_fine, ax)
    return G_fine


def _pad_end(G: torch.Tensor, pad) -> torch.Tensor:
    """Zero-pad the three lattice axes of (3, X, Y, Z) at their ends."""
    return torch.nn.functional.pad(G, (0, pad[2], 0, pad[1], 0, pad[0]))


# ---------------------------------------------------------------------------
# The V-cycle preconditioner
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class _Level:
    op: StructuredSolidOperator
    binv: List[torch.Tensor]  # per-phase (3, 3, cnt) block-Jacobi inverses

    def minv(self, r):
        return self.op.apply_block_jacobi(self.binv, r)


def _graph_key(r: torch.Tensor) -> tuple:
    """What a captured V-cycle is fixed to: the input's shape, dtype and
    device."""
    return tuple(r.shape), r.dtype, r.device


def _graphable(r: torch.Tensor) -> bool:
    """Whether a call on `r` may take the graph: a contiguous CUDA tensor,
    outside any capture (a call inside another capture runs inline)."""
    return r.is_cuda and r.is_contiguous() and not torch.cuda.is_current_stream_capturing()


# device index -> (side stream, anchor graph) of the V-cycle graphs' captures
_CAPTURE: dict = {}
# CUDA's stream capture mode: "thread_local" forbids the unsafe calls of the
# capturing thread alone, so another thread of the process (NCCL's watchdog,
# querying its events while a distributed V-cycle captures) may call CUDA
# meanwhile; the graph recorded is the one "global" would record
_CAPTURE_MODE = "thread_local"


def _capture_place(device: torch.device):
    """The side stream every V-cycle graph on `device` is captured on, and
    the id of the memory pool they all share (made at the first capture).

    One pool serves every hierarchy, so a dropped hierarchy's memory is
    there for the next one's capture without emptying the allocator's cache
    (a pool of each graph's own is given back only then). Sharing is safe
    because nothing a graph allocates outlives its replay, and replays run
    in the order of the streams they are launched on; two graphs replayed
    on two streams at once would share memory. The pool is that of an
    anchor graph (one fill of a tensor from outside the pool, never
    replayed) kept for the process, so that it outlives every V-cycle graph
    sharing it."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _CAPTURE:
        with torch.cuda.device(idx):
            stream, anchor = torch.cuda.Stream(), torch.cuda.CUDAGraph()
            t = torch.zeros(1, device=torch.device("cuda", idx))
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                anchor.capture_begin(capture_error_mode=_CAPTURE_MODE)
                try:
                    t.zero_()
                finally:
                    anchor.capture_end()
        _CAPTURE[idx] = (stream, anchor)
    stream, anchor = _CAPTURE[idx]
    return stream, anchor.pool()


def _clear_cublas_workspaces() -> None:
    """Give back cuBLAS's workspace of every stream to the allocator (each
    stream is given a new one at its next cuBLAS call). torch has no public
    call for it; its own graph trees use this one."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


class _VcycleGraph:
    """One hierarchy's V-cycle as a CUDA graph, for inputs of one `key`.

    `capture` records in `_CAPTURE_MODE` on the device's capture stream,
    into the shared pool (`_capture_place`): slot_copy_in (the residual at
    the address in slots[0] into a buffer of the pool), the V-cycle, and
    slot_copy_out (its result to the address in slots[1]). `replay` writes the two addresses
    with one kernel on the current stream, then replays there. The graph
    goes with this object; the memory it used stays in the pool.

    cuBLAS keeps a workspace for each stream it runs on (32 MiB on the
    H100), which the coarse solve's matvec would make for the capture stream
    and keep allocated. So the capture clears cuBLAS's workspaces before and
    after: the capture stream's is made inside the pool and is free there
    between replays, and while the capture runs the current stream's is
    free, so the card holds what an eager V-cycle holds at that point (the
    current stream makes its own again at its next cuBLAS call)."""

    def __init__(self, r: torch.Tensor):
        self.key = _graph_key(r)
        self.graph = torch.cuda.CUDAGraph()
        self.slots = torch.zeros(2, dtype=torch.int64, device=r.device)
        self.captured = False

    def capture(self, vcycle) -> None:
        shape, dtype, device = self.key
        stream, pool = _capture_place(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        _clear_cublas_workspaces()
        try:
            with torch.cuda.device(device), torch.cuda.stream(stream):
                self.graph.capture_begin(pool=pool, capture_error_mode=_CAPTURE_MODE)
                try:
                    x = torch.empty(shape, dtype=dtype, device=device)
                    gather.slot_copy_in(self.slots, x)
                    gather.slot_copy_out(self.slots, vcycle(x).contiguous())
                    del x
                finally:
                    self.graph.capture_end()
        finally:
            _clear_cublas_workspaces()
        self.captured = True

    def replay(self, r: torch.Tensor, out: torch.Tensor) -> None:
        gather.slot_set(self.slots, r.data_ptr(), out.data_ptr())
        self.graph.replay()


class _VcycleRoute:
    """A hierarchy's V-cycle policy (StructuredMultigrid's and
    DistributedMultigrid's): eager on an input `eligible` refuses or unlike
    the captured one; else eager at the first call (the warm-up that fills
    what a capture must not: packed cell matrices, plans, NCCL's
    communicator), captured at the second, replayed from then on. Counts
    <name>.vcycle_calls, .graph_captures and .graph_replays, spans
    <name>.replay; a replay counts again what its capture counted (a
    distributed V-cycle's comm.bytes). The eager V-cycle comes with each
    call: held here, it would tie the hierarchy into a reference cycle,
    and a dropped hierarchy's device memory would wait for the cyclic
    garbage collector."""

    def __init__(self, name: str, eligible):
        self.name, self.eligible = name, eligible
        self.graph: Optional[_VcycleGraph] = None  # made by the first eligible call
        self.tally: dict = {}  # what the capture counted

    def __call__(self, r: torch.Tensor, vcycle) -> torch.Tensor:
        count(f"{self.name}.vcycle_calls")
        g = self.graph
        if not self.eligible(r) or (g is not None and g.key != _graph_key(r)):
            return vcycle(r)
        if g is None:
            self.graph = _VcycleGraph(r)
            return vcycle(r)
        if not g.captured:
            with tally() as self.tally:
                g.capture(vcycle)
            count(f"{self.name}.graph_captures")
        out = torch.empty_like(r)
        with span(f"{self.name}.replay"):
            g.replay(r, out)
        count(f"{self.name}.graph_replays")
        for name, n in self.tally.items():
            count(name, n)
        return out


def _axis_support(w, n: int) -> np.ndarray:
    """(2n+1,) 1.0 where a doubled-lattice node touches any cell of positive
    weight along this axis, else 0.0 (such nodes stay fixed: their stiffness
    rows are exactly zero)."""
    if w is None:
        return np.ones(2 * n + 1)
    sup = np.zeros(2 * n + 1)
    for c in range(n):
        if w[c] > 1e-12:
            sup[2 * c:2 * c + 3] = 1.0
    return sup


class StructuredMultigrid:
    """Symmetric V-cycle preconditioner M^-1 for CG on the structured mesh;
    call it on a residual in the finest operator's internal layout (on a
    CUDA device, replayed as a CUDA graph from the second call on: the
    module docstring).

    Args:
      dims: (X, Y, Z) box dimensions (used when `spacing` is None).
      n_cells: finest cell counts (nx, ny, nz).
      E, nu: material; weight: Tet10 quadrature weight.
      free_mask_global: (ndof,) 1/0 mask in mesh (lattice raster) DOF order.
      dtype: numpy float type of every level.
      n_smooth: smoothing sweeps pre and post (equal counts keep symmetry).
      omega: damped-Jacobi damping on isotropic, unweighted levels.
      coarse_dof_limit: stop coarsening at or below this many DOFs.
      fine_op: the caller's finest operator, reused as level 0.
      coarse_dense_limit: largest allowed coarsest dense inverse; a hierarchy
        that bottoms out above it raises ValueError (callers fall back to
        block-Jacobi).
      pad_odd_axes: ghost-pad odd axes when the hierarchy would otherwise
        bottom out above coarse_dense_limit.
      smoother: "jacobi" (damped block-Jacobi) or "chebyshev" (degree
        n_smooth polynomial in M^-1 K on [cheb_lower, cheb_upper] * lmax).
      semi_stop_dof: stop with a dense coarsest solve instead of a semi
        (partial) coarsening step once the level has at most this many DOFs:
        block-Jacobi smooths the anisotropic semi-coarsened operators poorly.
      device: where the levels live (None = CUDA, raising without it).
    """

    def __init__(
        self,
        dims,
        n_cells,
        E,
        nu,
        free_mask_global,
        weight=None,
        dtype=np.float32,
        n_smooth: int = 2,
        omega: float = 0.7,
        coarse_dof_limit: int = 2000,
        fine_op: "StructuredSolidOperator | None" = None,
        spacing=None,
        coarse_dense_limit: int = 15000,
        pad_odd_axes: bool = True,
        smoother: str = "jacobi",
        cheb_lower: float = 1.0 / 30.0,
        cheb_upper: float = 1.1,
        semi_stop_dof: int = 8000,
        device=None,
    ):
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"smoother must be 'jacobi' or 'chebyshev', "
                             f"got {smoother!r}")
        dev = resolve_device(device)
        self._route = _VcycleRoute("mg", _graphable)
        self.smoother = smoother
        self.cheb_lower = float(cheb_lower)
        self.cheb_upper = float(cheb_upper)
        self.n_smooth = n_smooth
        self.levels: List[_Level] = []
        self._coarsen_axes: List[tuple] = []  # grid axes (1..3) per level gap
        self._pad_nodes: List[tuple] = []  # per gap: node padding per axis
        self._crop_nodes = (0, 0, 0)  # gap-0 crop of a lane-padded fine level

        n = tuple(int(v) for v in n_cells)
        if spacing is None:
            spacing = tuple(float(d) / c for d, c in zip(dims, n))
        sp = tuple(float(s) for s in spacing)
        mask_grid = np.asarray(free_mask_global, dtype=np.float64).reshape(
            2 * n[0] + 1, 2 * n[1] + 1, 2 * n[2] + 1, 3)

        # ---- level specs (femx's rules). Ghost padding: an odd axis is
        # padded to c+1 cells before halving; the padding lives in the
        # transfers (zero-embed before restriction, slice after
        # prolongation) and in the coarse levels, whose operators carry
        # per-axis cell weights (the real-volume fraction of straddling
        # cells, 0 for fully-ghost cells) and whose masks fix only ghost
        # nodes with no weighted stiffness support.
        specs = []  # (n, sp, mask_grid, axis_weights)
        real_ext = [float(c) for c in n]
        weights = (None, None, None)
        while True:
            specs.append((n, sp, mask_grid, weights))
            ndof = 3 * (2 * n[0] + 1) * (2 * n[1] + 1) * (2 * n[2] + 1)
            if ndof <= coarse_dof_limit:
                break
            even_axes = tuple(i for i in range(3) if n[i] % 2 == 0 and n[i] > 2)
            if (semi_stop_dof and len(even_axes) < 3
                    and ndof <= min(semi_stop_dof, coarse_dense_limit)):
                break
            if even_axes:
                axes = even_axes
            else:
                odd_axes = tuple(i for i in range(3) if n[i] > 2)
                if not odd_axes or ndof <= coarse_dense_limit or not pad_odd_axes:
                    break
                axes = odd_axes
            pad = tuple(1 if (i in axes and n[i] % 2) else 0 for i in range(3))
            self._pad_nodes.append(tuple(2 * p for p in pad))
            self._coarsen_axes.append(tuple(1 + i for i in axes))
            mask_p = mask_grid
            if any(pad):
                # ghost nodes padded FREE: fixing them imposes a spurious
                # Dirichlet plane next to real free surfaces
                mask_p = np.pad(mask_grid, [(0, 2 * pad[0]), (0, 2 * pad[1]),
                                            (0, 2 * pad[2]), (0, 0)],
                                constant_values=1.0)
            sub = tuple(slice(None, None, 2) if i in axes else slice(None)
                        for i in range(3))
            mask_grid = mask_p[sub]
            n = tuple((c + p) // 2 if i in axes else c
                      for i, (c, p) in enumerate(zip(n, pad)))
            sp = tuple(s * 2.0 if i in axes else s for i, s in enumerate(sp))
            real_ext = [r / 2.0 if i in axes else r for i, r in enumerate(real_ext)]
            weights = tuple(
                None if real_ext[i] >= n[i] - 1e-9
                else np.clip(real_ext[i] - np.arange(n[i]), 0.0, 1.0)
                for i in range(3))
            if any(w is not None for w in weights):
                mask_grid = mask_grid * (
                    _axis_support(weights[0], n[0])[:, None, None, None]
                    * _axis_support(weights[1], n[1])[None, :, None, None]
                    * _axis_support(weights[2], n[2])[None, None, :, None])

        coarse_ndof = 3 * np.prod([2 * c + 1 for c in specs[-1][0]])
        if coarse_ndof > coarse_dense_limit:
            raise ValueError(
                f"multigrid hierarchy bottoms out at {coarse_ndof} DOFs "
                f"(> coarse_dense_limit={coarse_dense_limit}); cell counts "
                f"{tuple(n_cells)} do not coarsen far enough")

        extra = "" if smoother == "jacobi" else f"cheb:{self.cheb_lower}:{self.cheb_upper}"
        if semi_stop_dof != 8000:
            extra += f"|ss:{semi_stop_dof}"
        if fine_op is not None and fine_op._cell_weight_host() is not None:
            # a weighted fine operator (the distributed solver's ghost-padded
            # lattice) has other blocks than an unweighted one on the same
            # mask; femx's key leaves the weights out
            extra += "|fw:" + hashlib.sha256(
                fine_op._cell_weight_host().tobytes()).hexdigest()[:16]
        ck = _mg_cache_key(specs[0][0], specs[0][1], E, nu, weight, dtype, n_smooth, omega,
                           coarse_dof_limit, specs[0][2], extra=extra)
        cached = _mg_cache_load(ck)
        level_cells = np.asarray([sp_[0] for sp_ in specs], dtype=np.int64)
        if cached is not None and (
                int(cached["n_levels"]) != len(specs)
                or not np.array_equal(cached.get("level_cells", np.empty((0, 3), np.int64)),
                                      level_cells)):
            cached = None  # another layout under the same key
        self.setup_cache_hit = cached is not None

        # ---- per-level operators: the caller's fine operator, exact 2x
        # rescaling on uniform steps, a single-cell rebuild on semi steps.
        # Block-Jacobi tensors are built on the host (or read from the
        # cache) and kept there for the power iterations below.
        prev_op = None
        binv_hosts = []
        # the fine operator's apply form reaches every level (each level's
        # own conv gate decides)
        form = None if fine_op is None else fine_op.apply_form
        for i, (ni, spi, mgrid, wts) in enumerate(specs):
            if i == 0 and fine_op is not None:
                if tuple(fine_op.n_cells) != ni:
                    raise ValueError(
                        f"fine_op has n_cells {fine_op.n_cells}, expected {ni}")
                op = fine_op
            elif (prev_op is not None and self._coarsen_axes[i - 1] == (1, 2, 3)
                  and self._pad_nodes[i - 1] == (0, 0, 0)):
                op = prev_op.coarsened()
            else:
                op = StructuredSolidOperator.from_lattice(
                    ni, spi, E, nu, weight=weight, dtype=dtype, device=dev,
                    apply_form=form)
            if any(w is not None for w in wts):
                op = StructuredSolidOperator.from_host(
                    op.Kcell_host, op.n_cells, op.weight, spacing=op.spacing,
                    x_weight=wts[0], y_weight=wts[1], z_weight=wts[2], device=dev,
                    apply_form=op.apply_form)
            prev_op = op
            op = op.with_free_mask(op.to_internal(mgrid.reshape(-1)))
            bh = ([cached[f"binv_{i}_{p}"] for p in range(8)] if cached is not None
                  else [b.astype(dtype) for b in op.block_jacobi_tensors()])
            binv_hosts.append(bh)
            self.levels.append(_Level(op=op, binv=[torch.as_tensor(b, device=dev)
                                                   for b in bh]))

        # ---- smoother damping: isotropic unweighted levels keep omega;
        # damped block-Jacobi diverges on anisotropic (semi-coarsened) and
        # ghost-weighted levels, which get 4 / (3 lambda_max(M^-1 K)) from a
        # host power iteration. Chebyshev needs lambda_max on every level.
        if cached is not None:
            self.omegas = [float(w) for w in cached["omegas"]]
            self.lmaxs = [float(v) for v in cached["lmaxs"]] if "lmaxs" in cached else None
            self._coarse_inv = torch.as_tensor(cached["coarse_kinv"], device=dev)
            return
        self.omegas = []
        self.lmaxs = [] if smoother == "chebyshev" else None
        for (ni, spi, _mg, wts), lvl, binv_h in zip(specs, self.levels, binv_hosts):
            weighted = any(w is not None for w in wts)
            aniso = max(spi) / min(spi) > 1.01
            if smoother == "chebyshev":
                lm = (_power_lambda_max(lvl.op, binv_h) if weighted
                      else _proxy_lambda_max(spi, nu, dtype))
                self.lmaxs.append(float(lm))
                self.omegas.append(min(omega, 4.0 / (3.0 * lm)))
            elif aniso or weighted:
                self.omegas.append(
                    min(omega, 4.0 / (3.0 * _power_lambda_max(lvl.op, binv_h))))
            else:
                self.omegas.append(omega)

        # ---- coarsest: dense masked stiffness in the coarse op's internal
        # order, inverted on the host in f64 and symmetrised. An explicit
        # inverse makes the coarse solve one matvec; symmetry (which CG
        # needs) is exact by construction.
        cn, csp, *_ = specs[-1]
        cop = self.levels[-1].op
        K = _dense_structured_K(cn, csp, E, nu, cop.weight,
                                cell_weights=cop._cell_weight_host())
        perm = cop._permutation()
        Kp = K[np.ix_(perm, perm)]
        m = cop.free_mask_host.astype(np.float64)
        Kp = Kp * m[:, None] * m[None, :] + np.diag(1.0 - m)
        with span("mg.coarse_factor"):
            if Kp.shape[0] <= 2000:
                np.linalg.cholesky(Kp)  # definiteness check (raises on indefinite)
                Kinv = np.linalg.solve(Kp, np.eye(Kp.shape[0], dtype=Kp.dtype))
            else:  # LAPACK potrf + potri, ~3x cheaper than an LU solve here
                try:
                    L = torch.linalg.cholesky(torch.from_numpy(Kp))
                except RuntimeError as e:
                    raise np.linalg.LinAlgError(
                        f"coarse matrix not positive definite: {e}") from e
                Kinv = torch.cholesky_inverse(L).numpy()
            Kinv = 0.5 * (Kinv + Kinv.T)
            self._coarse_inv = torch.as_tensor(Kinv.astype(dtype), device=dev)

        payload = {"n_levels": np.int64(len(specs)), "level_cells": level_cells,
                   "omegas": np.asarray(self.omegas, dtype=np.float64),
                   "coarse_kinv": Kinv.astype(dtype)}
        if self.lmaxs is not None:
            payload["lmaxs"] = np.asarray(self.lmaxs, np.float64)
        for i, bh in enumerate(binv_hosts):
            for p, b in enumerate(bh):
                payload[f"binv_{i}_{p}"] = np.asarray(b)
        _mg_cache_save(ck, payload)

    @classmethod
    def from_parts(cls, levels: List[_Level], omegas, coarse_inv: torch.Tensor,
                   coarsen_axes, pad_nodes, crop_nodes=(0, 0, 0), n_smooth=2,
                   smoother="jacobi", lmaxs=None, cheb_lower=1.0 / 30.0,
                   cheb_upper=1.1) -> "StructuredMultigrid":
        """A hierarchy from ready-made parts (femx_torch.convert)."""
        out = cls.__new__(cls)
        out._route = _VcycleRoute("mg", _graphable)
        out.levels = list(levels)
        out.omegas = [float(w) for w in omegas]
        out._coarse_inv = coarse_inv
        out._coarsen_axes = [tuple(int(a) for a in ax) for ax in coarsen_axes]
        out._pad_nodes = [tuple(int(p) for p in pd) for pd in pad_nodes]
        out._crop_nodes = tuple(int(c) for c in crop_nodes)
        out.n_smooth = int(n_smooth)
        out.smoother = smoother
        out.lmaxs = None if lmaxs is None else [float(v) for v in lmaxs]
        out.cheb_lower = float(cheb_lower)
        out.cheb_upper = float(cheb_upper)
        return out

    def _coarse_solve(self, b: torch.Tensor) -> torch.Tensor:
        return self._coarse_inv @ b

    def _smooth(self, k: int, x, b, sweeps: int):
        lvl = self.levels[k]
        om = self.omegas[k]
        for _ in range(sweeps):
            x = x + om * lvl.minv(b - lvl.op.apply_constrained(x))
        return x

    def _smooth_cheb(self, k: int, x, b, degree: int):
        """Chebyshev(degree) polynomial smoothing in M^-1 K on
        [cheb_lower, cheb_upper] * lambda_max (Saad, Iterative Methods, alg.
        12.1). x=None means a zero initial guess. Recurrence scalars are
        Python floats, so float32 vectors stay float32."""
        lvl = self.levels[k]
        lm = float(self.lmaxs[k])
        a = self.cheb_lower * lm
        bb = self.cheb_upper * lm
        theta = 0.5 * (bb + a)
        delta = 0.5 * (bb - a)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b if x is None else b - lvl.op.apply_constrained(x)
        d = (1.0 / theta) * lvl.minv(r)
        for _ in range(degree - 1):
            x = d if x is None else x + d
            r = r - lvl.op.apply_constrained(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * lvl.minv(r)
            rho = rho_new
        return d if x is None else x + d

    def _presmooth(self, k: int, b, sweeps: int):
        if self.smoother == "chebyshev":
            return self._smooth_cheb(k, None, b, sweeps)
        return self._smooth(k, torch.zeros_like(b), b, sweeps)

    def _postsmooth(self, k: int, x, b, sweeps: int):
        if self.smoother == "chebyshev":
            return self._smooth_cheb(k, x, b, sweeps)
        return self._smooth(k, x, b, sweeps)

    def _vcycle(self, k: int, b: torch.Tensor) -> torch.Tensor:
        with span("mg.level", level=k):
            return self._level(k, b)

    def _level(self, k: int, b: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[k]
        if k == len(self.levels) - 1:
            with span("mg.coarse_solve"):
                return self._coarse_solve(b)
        with span("mg.smooth"):
            x = self._presmooth(k, b, self.n_smooth)
        nxt = self.levels[k + 1]
        axes = self._coarsen_axes[k]
        # ghost padding (odd axes): zero-embed the residual before
        # restriction, slice the prolonged correction back; a lane-padded
        # fine level (gap 0) is cropped to the real lattice instead — both
        # pairs are exact adjoints
        pad = self._pad_nodes[k]
        crop = self._crop_nodes if k == 0 else (0, 0, 0)
        Px, Py, Pz = lvl.op.grid_shape
        rx, ry, rz = Px - crop[0], Py - crop[1], Pz - crop[2]
        with span("mg.restrict"):
            r = b - lvl.op.apply_constrained(x)
            r_full = _join_full(lvl.op, r)
            if any(crop):
                r_full = r_full[:, :rx, :ry, :rz]
            if any(pad):
                r_full = _pad_end(r_full, pad)
            r_coarse = _split_full(nxt.op, restrict(r_full, axes)) * nxt.op.free_mask
        e_coarse = self._vcycle(k + 1, r_coarse)
        with span("mg.prolong"):
            e_full = prolong(_join_full(nxt.op, e_coarse), axes)
            if any(pad):
                e_full = e_full[:, :rx, :ry, :rz]
            if any(crop):
                e_full = _pad_end(e_full, crop)
            x = x + _split_full(lvl.op, e_full) * lvl.op.free_mask
        with span("mg.smooth"):
            return self._postsmooth(k, x, b, self.n_smooth)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """M^-1 r (internal layout of the finest operator)."""
        return self._route(r, functools.partial(self._vcycle, 0))

    @property
    def fine_op(self) -> StructuredSolidOperator:
        return self.levels[0].op


def _power_lambda_max(op: StructuredSolidOperator, binv, iters: int = 15) -> float:
    """Power-iteration estimate of lambda_max(M^-1 K) for smoother damping,
    on the host CPU in the level's dtype. M^-1 K is similar to the SPD
    M^-1/2 K M^-1/2, so power iteration converges to the top eigenvalue; a
    5% pad covers the truncated iteration. `binv` are host numpy arrays."""
    rng = np.random.default_rng(7)
    dt = op.Kcell_host.dtype
    hop = StructuredSolidOperator.from_host(
        op.Kcell_host, op.n_cells, op.weight, spacing=op.spacing,
        free_mask=op.free_mask_host, x_weight=_host(op.x_weight),
        y_weight=_host(op.y_weight), z_weight=_host(op.z_weight), device="cpu",
        apply_form=op.apply_form)
    hbinv = [torch.as_tensor(np.asarray(b)) for b in binv]
    v = torch.as_tensor(rng.standard_normal(hop.ndof).astype(dt))
    lam = None
    for _ in range(iters):
        w = hop.apply_block_jacobi(hbinv, hop.apply_constrained(v))
        lam = torch.sqrt(torch.dot(w, w) / torch.dot(v, v))
        v = w / lam
    return 1.05 * float(lam)


def _host(w):
    return None if w is None else w.cpu().numpy()


_PROXY_LMAX_CACHE: dict = {}


def _proxy_lambda_max(spacing, nu, dtype, cells: int = 4) -> float:
    """lambda_max(M^-1 K) computed on a small all-free proxy lattice with
    the same spacing RATIOS: the quantity is invariant to global scaling of
    K and local (the top of the spectrum lives on interior node patches), so
    a 4^3-cell lattice holds the extremal patch."""
    smin = min(float(s) for s in spacing)
    ratios = tuple(round(float(s) / smin, 9) for s in spacing)
    key = (ratios, round(float(nu), 12), np.dtype(dtype).name, int(cells))
    if key not in _PROXY_LMAX_CACHE:
        op = StructuredSolidOperator.from_lattice(
            (cells,) * 3, ratios, 1.0, nu, dtype=dtype, device="cpu")
        op = op.with_free_mask(np.ones(op.ndof))
        _PROXY_LMAX_CACHE[key] = _power_lambda_max(op, op.block_jacobi_tensors())
    return _PROXY_LMAX_CACHE[key]


def _dense_structured_K(n_cells, spacing, E, nu, weight,
                        cell_weights=None) -> np.ndarray:
    """Dense f64 lattice stiffness in GLOBAL raster DOF order, assembled by
    overlap-adding the single (81,81) cell matrix with one bincount (host).

    cell_weights: optional (nx, ny, nz) per-cell scale (ghost-padded coarse
    levels); must match the level operator."""
    Kc = _cell_stiffness(tuple(spacing), E, nu, weight, np.float64)
    nx, ny, nz = (int(v) for v in n_cells)
    gy, gz = 2 * ny + 1, 2 * nz + 1
    ndof = 3 * (2 * nx + 1) * gy * gz
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    slots = np.asarray(_SLOTS)  # (27, 3)
    nodes = (
        (2 * i[..., None] + slots[:, 0]) * gy + (2 * j[..., None] + slots[:, 1])
    ) * gz + (2 * k[..., None] + slots[:, 2])  # (nx, ny, nz, 27) raster ids
    dofs = (3 * nodes[..., None] + np.arange(3)).reshape(-1, 81)  # (ncell, 81)
    lin = (dofs[:, :, None].astype(np.int64) * ndof + dofs[:, None, :]).ravel()
    w = np.broadcast_to(Kc.ravel(), (dofs.shape[0], 81 * 81))
    if cell_weights is not None:
        w = w * np.asarray(cell_weights, dtype=np.float64).reshape(-1, 1)
    return np.bincount(lin, weights=w.ravel(),
                       minlength=ndof * ndof).reshape(ndof, ndof)
