"""DOF-sharded structured solve: z-slab halo exchange between ranks (port
of femx/parallel/halo.py).

Each rank owns a contiguous z-slab of the lattice (cells [d*nzl,
(d+1)*nzl)); the CG state lives slab-local, in exactly the internal
phase-major layout of an (nx, ny, nzl)-cell StructuredSolidOperator whose
pz=0 phases carry one extra z-plane (the ghost: the next rank's first
plane; on the last rank the real boundary plane). The slab apply is
therefore the port's single-device apply on the slab (the
structured_cell_matmul kernel on the card), followed by one exchange of the
four pz=0 boundary planes:

  1. halo-reduce: the first plane adds the contributions of the cells below
     it, computed by rank d-1 into its ghost plane;
  2. ghost-sync: the ghost plane becomes the next rank's completed first
     plane.

femx does these as two ppermutes; here one all_gather of each rank's
(first, ghost) planes serves both, since a rank's completed first plane is
its own partial plane plus the plane its lower neighbour sent, summed in
the same order on the owner and on the neighbour (so ghosts stay bitwise
equal to their owners). CG is femx_torch.solve.cg's pcg_mixed, whose dot
products are ownership-weighted here (the ghost plane weighs 0) and summed
with all_reduce, two per CG iteration.

DistributedMultigrid runs the V-cycle on the same local vectors: smoothing
with halo applies, the z-restriction with one plane exchange, the
z-prolongation fully local; below a handoff level the residual is gathered
(one all_gather) and the remaining levels of the underlying
StructuredMultigrid run replicated on every rank.

Under NCCL each rank replays its V-cycle as one CUDA graph, by
StructuredMultigrid's route (multigrid._VcycleRoute: eager first call,
capture at the second, replays after) with `_replayable` in place of its
rule (under gloo, on the CPU or with more ranks than cards, the V-cycle
stays eager): the smoothing sweeps with their halo applies and exchanges, the
restrictions, the hand-off's all_gather, the replicated levels with the
dense coarse solve, and the slice back to the rank's slab. The eager first
call also makes NCCL's communicator; every rank captures alike (every slab
has nzl + 1 planes, so the keys agree), in CUDA's thread-local capture mode
(multigrid._CAPTURE_MODE) so that NCCL's watchdog thread may query its
events meanwhile. The captured all_gathers share the communicator with
CG's eager all_reduces and the apply's exchanges; every rank issues them
in one order. The replay launches the eager V-cycle's kernels in the same
order and returns its bits (an all_gather is a copy). Every route that
calls a DistributedMultigrid replays so under NCCL: pcg_halo and
DistributedStructuredSolver (its solves, checkpointed or not, and load
cases), the structured devices=N modal's inner solves, and
DistributedUnstructuredSolver's lattice coarse correction (two calls a
preconditioner call; also the unstructured devices=N modal's inner
solves).

Traced (femx_torch.profiling): `halo.exchange` around each apply's plane
exchange; in an eager V-cycle `dmg.level` (level=k) around each
distributed level, the coarser ones inside it, and `dmg.handoff` around
the hand-off's all_gather, the replicated levels (their own mg.* spans
inside) and the slicing back; a replay records `dmg.replay` (slot_set and
the replay) and no span inside it. Counters: `dmg.vcycle_calls` (every
call), `dmg.graph_captures`, `dmg.graph_replays`; a replay counts in
`comm.bytes` what its capture counted, as an eager V-cycle would.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.config import torch_dtype
from femx_torch.parallel import comm
from femx_torch.profiling import span
from femx_torch.solve.cg import pcg_mixed
from femx_torch.solve.multigrid import (StructuredMultigrid, _graphable, _interp_axis,
                                        _join_full, _restrict_axis, _split_full,
                                        _VcycleRoute)

# pz=0 phase indices (phase index = px*4 + py*2 + pz)
_PZ0 = (0, 2, 4, 6)


def _host(w):
    return None if w is None else w.cpu().numpy()


def _replayable(r: torch.Tensor) -> bool:
    """Whether a distributed V-cycle on `r` may take the graph: `_graphable`,
    and the group's collectives can be captured (NCCL, or a group of one
    rank). Every rank decides alike, from nothing rank-local: a rank that
    captured while another ran eagerly would pair their collectives
    wrongly."""
    return _graphable(r) and (comm.world_size() == 1 or comm.backend() == "nccl")


class HaloStructuredOperator:
    """z-slab DOF-sharded structured operator with plane-only halo exchange.

    op: the full-problem operator (free_mask set; its z_weight, if any, is
    sliced per slab). Every rank builds it from the same full operator."""

    def __init__(self, op: StructuredSolidOperator, mesh=None):
        nx, ny, nz = op.n_cells
        self.ndev = comm.world_size() if mesh is None else mesh.size
        self.rank = comm.rank()
        if nz % self.ndev:
            raise ValueError(f"nz={nz} must divide the rank count ({self.ndev})")
        self.op = op
        self.nzl = nz // self.ndev
        z0 = self.rank * self.nzl
        zw = _host(op.z_weight)
        self.local = StructuredSolidOperator.from_host(
            op.Kcell_host, (nx, ny, self.nzl), op.weight, spacing=op.spacing,
            x_weight=_host(op.x_weight), y_weight=_host(op.y_weight),
            z_weight=None if zw is None else zw[z0:z0 + self.nzl], device=op.device,
            apply_form=op.apply_form)
        self._tdt = torch_dtype(op.dtype)
        self._weights = None
        self._mask = None

    @property
    def device(self) -> torch.device:
        return self.op.device

    # -- layout: full internal vector <-> slab-local vectors -----------------
    def slab(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's slab, ghost plane included, of a full internal
        vector."""
        z0 = self.rank * self.nzl
        phases = self.op._split_phases(v)
        return torch.cat([g[..., z0:z0 + self.nzl + 1 - (i % 2)].reshape(-1)
                          for i, g in enumerate(phases)])

    def to_local(self, v, dtype=None) -> torch.Tensor:
        """This rank's slab of a full internal vector (host or tensor), on
        the operator's device in `dtype` (default the operator's)."""
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                            device=self.device)
        return self.slab(t).to(self._tdt if dtype is None else dtype)

    def assemble(self, stacked: torch.Tensor) -> torch.Tensor:
        """(ndev, ndof_local) slab vectors -> the full internal vector of
        their owned entries."""
        rows = [self.local._split_phases(stacked[d]) for d in range(self.ndev)]
        out = []
        for i in range(8):
            tail = 1 - (i % 2)
            parts = [rows[d][i][..., :self.nzl + (tail if d == self.ndev - 1 else 0)]
                     for d in range(self.ndev)]
            out.append(torch.cat(parts, dim=-1).reshape(-1))
        return torch.cat(out)

    def gather_local(self, x_loc: torch.Tensor) -> torch.Tensor:
        """Every rank's slab vector -> the full internal vector (one
        all_gather), on every rank."""
        return self.assemble(comm.all_gather(x_loc))

    @property
    def weights_local(self) -> torch.Tensor:
        """1/0 weights of the slab's entries, 0 on the ghost plane (all ones
        on the last rank), so a summed dot product counts every DOF once."""
        if self._weights is None:
            parts = []
            for i, s in enumerate(self.local._phase_shapes()):
                w = np.ones((3, *s))
                if i % 2 == 0 and self.rank < self.ndev - 1:
                    w[..., -1] = 0.0
                parts.append(w.reshape(-1))
            self._weights = torch.as_tensor(np.concatenate(parts), dtype=self._tdt,
                                            device=self.device)
        return self._weights

    @property
    def mask_local(self) -> torch.Tensor:
        """This rank's slab of the full operator's free mask."""
        if self._mask is None:
            self._mask = self.to_local(self.op.free_mask_host)
        return self._mask

    # -- the halo apply ------------------------------------------------------
    def halo_reduce_and_sync(self, f: torch.Tensor) -> torch.Tensor:
        """Complete the shared boundary planes of a per-cell accumulated
        slab vector and refresh its ghosts, in place (one exchange)."""
        if self.ndev == 1:
            return f
        with span("halo.exchange"):
            phases = self.local._split_phases(f)
            first = torch.cat([phases[i][..., 0].reshape(-1) for i in _PZ0])
            last = torch.cat([phases[i][..., -1].reshape(-1) for i in _PZ0])
            from_below, from_above = comm.exchange(first, last)
            new_first = first + from_below
            new_last = from_above + last if self.rank < self.ndev - 1 else last
            pos = 0
            for i in _PZ0:
                g = phases[i]
                n = g[..., 0].numel()
                g[..., 0].copy_(new_first[pos:pos + n].view(g[..., 0].shape))
                g[..., -1].copy_(new_last[pos:pos + n].view(g[..., -1].shape))
                pos += n
        return f

    def apply_local(self, u_loc: torch.Tensor) -> torch.Tensor:
        """K @ u on a slab-local vector (ghost-consistent in and out)."""
        return self.halo_reduce_and_sync(self.local.apply(u_loc))

    def apply_constrained_local(self, u_loc: torch.Tensor,
                                mask_loc: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = self.mask_local if mask_loc is None else mask_loc
        return self.apply_local(u_loc * s) * s + u_loc * (1.0 - s)

    # -- block-Jacobi on local vectors ----------------------------------------
    def slab_block_jacobi(self, binv_phases: Sequence) -> List[torch.Tensor]:
        """This rank's slab of per-phase (3, 3, cnt) inverse nodal blocks of
        the full operator (host arrays or tensors), on the device."""
        z0 = self.rank * self.nzl
        out = []
        for i, (b, s) in enumerate(zip(binv_phases, self.op._phase_shapes())):
            t = torch.as_tensor(b, device=self.device).reshape(3, 3, *s)
            out.append(t[..., z0:z0 + self.nzl + 1 - (i % 2)].reshape(3, 3, -1).contiguous())
        return out

    def block_jacobi(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Block-Jacobi on local vectors, its blocks sliced from the full
        operator's diagonal (boundary and ghost blocks complete)."""
        binv = self.slab_block_jacobi(self.op.block_jacobi_tensors())
        return lambda r: self.local.apply_block_jacobi(binv, r)


def pcg_halo(halo: HaloStructuredOperator, f_internal, tol: float = 1e-8,
             maxiter: int = 10000, preconditioner="block_jacobi", x0_internal=None,
             low_dtype=None, as_tensor: bool = False):
    """DOF-sharded PCG on the slab-local vectors: per iteration one halo
    exchange per apply, the preconditioner's, and two all_reduces.

    preconditioner: "block_jacobi", or a callable on slab-local residuals
    (a DistributedMultigrid). low_dtype: run the preconditioner in this
    dtype (the float32 V-cycle under float64 CG; None: the operator's, as
    CG). f_internal, x0_internal:
    full internal vectors (host or tensor), the same on every rank.

    Returns (x_full_internal, iterations, residual_norm, converged); x on
    every rank, host numpy unless as_tensor."""
    b = halo.to_local(f_internal)
    x0 = None if x0_internal is None else halo.to_local(x0_internal)
    minv = halo.block_jacobi() if preconditioner == "block_jacobi" else preconditioner
    if not callable(minv):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    res = pcg_mixed(halo.apply_constrained_local, b, minv, tol=tol, maxiter=maxiter,
                    low_dtype=b.dtype if low_dtype is None else low_dtype, x0=x0,
                    dots=functools.partial(comm.dots, weight=halo.weights_local))
    x = halo.gather_local(res.x)
    return ((x if as_tensor else x.cpu().numpy()), res.iterations, res.residual_norm,
            res.converged)


class DistributedMultigrid:
    """z-slab-distributed V-cycle over StructuredMultigrid levels; call it
    on a slab-local residual of the finest level (pcg_halo takes it as its
    preconditioner, where femx's takes dmg.preconditioner()'s factory).

    Level l runs distributed while its z cell count divides 2 * ranks, its
    coarsening is uniform (all three axes) and its gap is not ghost-padded
    (femx's rule, femx/parallel/halo.py:415-433); the remaining levels run
    replicated after one all_gather.

    Under NCCL a call on a contiguous CUDA input replays the V-cycle as one
    CUDA graph (`_VcycleRoute`, StructuredMultigrid's, with `_replayable`;
    the module's docstring says when)."""

    def __init__(self, mg: StructuredMultigrid, mesh=None):
        if getattr(mg, "smoother", "jacobi") != "jacobi":
            raise ValueError(
                "DistributedMultigrid implements damped block-Jacobi smoothing only "
                f"(got smoother={mg.smoother!r}); build the wrapped StructuredMultigrid "
                "with the defaults")
        self.mg = mg
        self._route = _VcycleRoute("dmg", _replayable)
        self.ndev = comm.world_size() if mesh is None else mesh.size
        self.halos: List[HaloStructuredOperator] = []
        pads = mg._pad_nodes
        for lvl_i, lvl in enumerate(mg.levels):
            nz = lvl.op.n_cells[2]
            if (lvl_i >= len(mg._coarsen_axes) or mg._coarsen_axes[lvl_i] != (1, 2, 3)
                    or (lvl_i < len(pads) and pads[lvl_i] != (0, 0, 0))
                    or nz % (2 * self.ndev)):
                break
            self.halos.append(HaloStructuredOperator(lvl.op, mesh))
        if not self.halos:
            raise ValueError(
                f"finest level {mg.levels[0].op.n_cells} cannot be z-slab distributed over "
                f"{self.ndev} ranks (needs nz % {2 * self.ndev} == 0 and a uniform first "
                "coarsening)")
        self.n_dist = len(self.halos)
        self.handoff = self.n_dist  # first replicated level
        self.binvs = [h.slab_block_jacobi(lvl.binv) for h, lvl in zip(self.halos, mg.levels)]

    @property
    def halo(self) -> HaloStructuredOperator:
        return self.halos[0]

    def __call__(self, r_loc: torch.Tensor) -> torch.Tensor:
        """M^-1 r on a slab-local residual."""
        return self._route(r_loc, functools.partial(self._vcycle_local, 0))

    def _restrict_z_halo(self, G: torch.Tensor) -> torch.Tensor:
        """z-restriction of a local joined grid (3, Px, Py, 2nzl+1) ->
        (3, Px, Py, nzl+1): the local transpose stencil, then plane 0 adds
        half the lower neighbour's last odd plane and the ghost plane
        becomes the upper neighbour's completed plane 0 (one exchange)."""
        out = _restrict_axis(G, 3)
        if self.ndev == 1:
            return out
        odd_last = 0.5 * G[..., -2]
        first = out[..., 0].contiguous()
        from_below, from_above = comm.exchange(first, odd_last.contiguous())
        out = out.clone()
        out[..., 0] = first + from_below
        if comm.rank() < self.ndev - 1:
            out[..., -1] = from_above + odd_last
        return out

    def _vcycle_local(self, k: int, b: torch.Tensor) -> torch.Tensor:
        with span("dmg.level", level=k):
            return self._level_local(k, b)

    def _level_local(self, k: int, b: torch.Tensor) -> torch.Tensor:
        mg = self.mg
        halo = self.halos[k]
        om = mg.omegas[k]
        mask = halo.mask_local
        binv = self.binvs[k]

        def A(v):
            return halo.apply_constrained_local(v, mask)

        def smooth(x, sweeps):
            for _ in range(sweeps):
                x = x + om * halo.local.apply_block_jacobi(binv, b - A(x))
            return x

        x = smooth(torch.zeros_like(b), mg.n_smooth)
        r = b - A(x)
        G = _join_full(halo.local, r)
        G = _restrict_axis(_restrict_axis(G, 1), 2)
        Gc = self._restrict_z_halo(G)
        if k + 1 < self.n_dist:
            nxt = self.halos[k + 1]
            r_c = _split_full(nxt.local, Gc) * nxt.mask_local
            Gce = _join_full(nxt.local, self._vcycle_local(k + 1, r_c))
            Gf = _interp_axis(_interp_axis(_interp_axis(Gce, 3), 2), 1)
        else:
            # handoff: the full coarse grid on every rank (owned planes of
            # each rank, the global last plane from the last rank's ghost),
            # the replicated levels, then this rank's slab of the prolonged
            # correction
            with span("dmg.handoff"):
                allg = comm.all_gather(Gc)
                G_full = torch.cat([allg[d][..., :-1] for d in range(self.ndev)]
                                   + [allg[-1][..., -1:]], dim=-1)
                cop = mg.levels[self.handoff].op
                e_c = mg._vcycle(self.handoff, _split_full(cop, G_full) * cop.free_mask)
                Gf_full = _interp_axis(_interp_axis(_interp_axis(_join_full(cop, e_c), 3), 2),
                                       1)
                z0 = 2 * comm.rank() * halo.nzl
                Gf = Gf_full[..., z0:z0 + 2 * halo.nzl + 1]
        x = x + _split_full(halo.local, Gf) * mask
        return smooth(x, mg.n_smooth)
