"""Structured-lattice multigrid preconditioning for UNSTRUCTURED meshes
(port of femx/solve/lattice_precond.py).

The unstructured mesh is embedded in an auxiliary structured lattice; the
port's StructuredMultigrid V-cycle runs there (its applies are the
structured_cell_matmul kernel on the card), coupled to the mesh by trilinear
transfers:

    mode="add"       M^-1 = D^-1 + omega_c * P Mg P^T
    mode="mult"      z = C r;  z += omega * D^-1 (r - A z)   (use fcg)
    mode="mult_sym"  z = omega*D^-1 r; z += C (r - A z);
                     z += omega*D^-1 (r - A z)

  D^-1   nodal block-Jacobi of the unstructured operator
  P      trilinear interpolation lattice -> mesh nodes, as row gathers
  P^T    its exact transpose, as degree-bucketed weighted row gathers
  Mg     StructuredMultigrid on the lattice, lattice nodes outside the
         mesh's support (and under its Dirichlet constraints) fixed

Every row gather of the transfers is femx_torch.gather.take_rows (the
hand-written CUDA kernel on the card); weights, sums and concatenations are
torch ops. Setup (lattice sizing, activity mask, transfer structure) is host
numpy, as in femx; the transfer arrays then move to the device once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.config import resolve_device, torch_dtype
from femx_torch.gather import index_tensor, take_rows
from femx_torch.profiling import span
from femx_torch.solve.multigrid import StructuredMultigrid


def _even_cells(n: float) -> int:
    """Round a cell-count estimate to an even count >= 2 (MG-friendly)."""
    return max(2, int(2 * round(float(n) / 2.0)))


def build_lattice_activity_mask(pts, mu, lo, half_h, gs) -> np.ndarray:
    """(Px, Py, Pz, 3) free-mask for the auxiliary lattice: component c of a
    lattice corner is active iff some free mesh DOF (n, c) interpolates from
    it with nonzero trilinear weight; a mesh node with component c fixed
    fixes component c of the corners that support it (w > 0), overriding
    activation (femx/solve/lattice_precond.py:69 explains both rules)."""
    gs = tuple(int(g) for g in gs)
    mask_l = np.zeros((gs[0], gs[1], gs[2], 3))
    t = (np.asarray(pts) - np.asarray(lo)[None, :]) / np.asarray(half_h)[None, :]
    i0 = np.clip(np.floor(t).astype(np.int64), 0, np.asarray(gs) - 2)
    fr = np.clip(t - i0, 0.0, 1.0)
    for keep in (True, False):  # activate free support, then fix Dirichlet
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    q = i0 + np.array([dx, dy, dz])
                    w = ((fr[:, 0] if dx else 1.0 - fr[:, 0])
                         * (fr[:, 1] if dy else 1.0 - fr[:, 1])
                         * (fr[:, 2] if dz else 1.0 - fr[:, 2]))
                    sup = w > 1e-12
                    for c in range(3):
                        sel = sup & ((mu[:, c] > 0.5) if keep else (mu[:, c] < 0.5))
                        mask_l[q[sel, 0], q[sel, 1], q[sel, 2], c] = 1.0 if keep else 0.0
    return mask_l


def _weights(w, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(w), dtype=torch_dtype(dtype), device=device)


def _weighted_bucket_sums(tab: torch.Tensor, idx, wts) -> List[torch.Tensor]:
    """Per bucket: (n_d, d, 3) row gather from tab, weighted sum over d."""
    return [(w[..., None].to(tab.dtype) * take_rows(tab, i)).sum(dim=1) if i.shape[1] else
            torch.zeros((i.shape[0], 3), dtype=tab.dtype, device=tab.device)
            for i, w in zip(idx, wts)]


def _nonempty(idx) -> int:
    return sum(1 for i in idx if i.shape[1])


@dataclasses.dataclass(eq=False)
class LatticeTransfer:
    """Trilinear P (lattice internal layout <-> mesh nodes) as gather data.

    Forward: u3[i, c] = sum_p w[p, i] * latt_phase_p[c, idx[p, i]].
    Transpose: per phase, lattice nodes bucketed by incidence count d, one
    (n_d, d) weighted row gather each, then one (cnt_p,)-row gather back to
    phase order."""

    idx: List[torch.Tensor]  # per phase (N,) node index within the phase
    w: torch.Tensor  # (8, N) weights
    bucket_idx: List[List[torch.Tensor]]  # per phase: [(n_d, d) mesh rows]
    bucket_w: List[List[torch.Tensor]]  # per phase: [(n_d, d) weights]
    perm_back: List[torch.Tensor]  # per phase (cnt_p,) bucket order -> phase
    phase_counts: Tuple[int, ...]  # nodes per phase (internal layout order)

    @classmethod
    def from_host(cls, idx, w, bucket_idx, bucket_w, perm_back, phase_counts,
                  dtype=np.float64, device=None) -> "LatticeTransfer":
        """Device transfer from host arrays, each index range-checked once."""
        dev = resolve_device(device)
        counts = tuple(int(c) for c in phase_counts)
        idx = np.asarray(idx)
        n = idx.shape[1]
        return cls(
            idx=[index_tensor(idx[p], counts[p], dev) for p in range(8)],
            w=_weights(w, dtype, dev),
            bucket_idx=[[index_tensor(b, n, dev) for b in bp] for bp in bucket_idx],
            bucket_w=[[_weights(b, dtype, dev) for b in bp] for bp in bucket_w],
            perm_back=[index_tensor(pb, counts[p], dev) for p, pb in enumerate(perm_back)],
            phase_counts=counts)

    def interpolate(self, e_int: torch.Tensor, n_nodes: int) -> torch.Tensor:
        """Lattice internal vector -> (3*n_nodes,) mesh-node vector."""
        pos = 0
        out = 0.0
        for p, cnt in enumerate(self.phase_counts):
            g = e_int[pos:pos + 3 * cnt].reshape(3, cnt).T.contiguous()  # (cnt, 3)
            out = out + self.w[p][:, None].to(g.dtype) * take_rows(g, self.idx[p])
            pos += 3 * cnt
        return out.reshape(-1)

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """(3*n_nodes,) mesh vector -> lattice internal vector (exact P^T)."""
        r3 = r.reshape(-1, 3)
        parts = []
        for p in range(8):
            sorted_out = torch.cat(_weighted_bucket_sums(r3, self.bucket_idx[p],
                                                         self.bucket_w[p]))
            parts.append(take_rows(sorted_out, self.perm_back[p]).T.reshape(-1))
        return torch.cat(parts)

    def gathers_per_call(self) -> Tuple[int, int]:
        """take_rows launches of (interpolate, restrict)."""
        return 8, sum(_nonempty(b) + 1 for b in self.bucket_idx)


@dataclasses.dataclass(eq=False)
class LatticeTransferPruned:
    """Zero-weight-pruned trilinear transfer (the grid-matched fast path):
    only incidences with w > eps, degree-bucketed on both sides (mesh nodes
    by kept-corner count for interpolate, lattice rows by kept-incidence
    count for restrict), plus one rank-permutation row gather per direction.
    The same kept set drives both directions, so restrict stays the exact
    adjoint of interpolate."""

    n_idx: List[torch.Tensor]  # per degree (n_d, d) rows into the (L, 3) cat
    n_w: List[torch.Tensor]
    node_rank: torch.Tensor  # (N,) node -> bucket-concat position
    l_idx: List[torch.Tensor]  # per degree (n_d, d) mesh-node rows
    l_w: List[torch.Tensor]
    lat_rank: torch.Tensor  # (L,) cat row -> bucket-concat position
    phase_counts: Tuple[int, ...]

    @classmethod
    def from_host(cls, n_idx, n_w, node_rank, l_idx, l_w, lat_rank, phase_counts,
                  dtype=np.float64, device=None) -> "LatticeTransferPruned":
        """Device transfer from host arrays, each index range-checked once."""
        dev = resolve_device(device)
        counts = tuple(int(c) for c in phase_counts)
        L, N = int(sum(counts)), len(node_rank)
        return cls(
            n_idx=[index_tensor(b, L, dev) for b in n_idx],
            n_w=[_weights(b, dtype, dev) for b in n_w],
            node_rank=index_tensor(node_rank, N, dev),
            l_idx=[index_tensor(b, N, dev) for b in l_idx],
            l_w=[_weights(b, dtype, dev) for b in l_w],
            lat_rank=index_tensor(lat_rank, L, dev),
            phase_counts=counts)

    def _cat3(self, e_int: torch.Tensor) -> torch.Tensor:
        """Internal per-phase (3, cnt) blocks -> one (L, 3) row table."""
        pos, rows = 0, []
        for cnt in self.phase_counts:
            rows.append(e_int[pos:pos + 3 * cnt].reshape(3, cnt).T)
            pos += 3 * cnt
        return torch.cat(rows)

    def interpolate(self, e_int: torch.Tensor, n_nodes: int) -> torch.Tensor:
        out = torch.cat(_weighted_bucket_sums(self._cat3(e_int), self.n_idx, self.n_w))
        return take_rows(out, self.node_rank).reshape(-1)

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        parts = _weighted_bucket_sums(r.reshape(-1, 3), self.l_idx, self.l_w)
        cat = take_rows(torch.cat(parts), self.lat_rank)  # (L, 3) cat order
        out, pos = [], 0
        for cnt in self.phase_counts:
            out.append(cat[pos:pos + cnt].T.reshape(-1))
            pos += cnt
        return torch.cat(out)

    def kept_incidences(self) -> int:
        return sum(int(b.shape[0]) * int(b.shape[1]) for b in self.n_idx)

    def gathers_per_call(self) -> Tuple[int, int]:
        """take_rows launches of (interpolate, restrict)."""
        return _nonempty(self.n_idx) + 1, _nonempty(self.l_idx) + 1


def _phase_node_counts(P_) -> List[int]:
    out = []
    for px in (0, 1):
        for py in (0, 1):
            for pz in (0, 1):
                s = [(P_[a] + 1 - p) // 2 for a, p in enumerate((px, py, pz))]
                out.append(int(s[0] * s[1] * s[2]))
    return out


def _corners(points, origin, half_h, grid_shape):
    """Per corner (dx, dy, dz) of each mesh point's half-grid cell, (N,)
    arrays: the corner's phase, its flat index within the phase (x-major
    raster, the structured operator's internal layout) and its trilinear
    weight."""
    pts = np.asarray(points, dtype=np.float64)
    P_ = np.asarray(grid_shape)
    t = (pts - origin[None, :]) / half_h[None, :]
    i0 = np.clip(np.floor(t).astype(np.int64), 0, P_[None, :] - 2)
    f = np.clip(t - i0, 0.0, 1.0)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                gx, gy, gz = i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz
                p = (gx % 2) * 4 + (gy % 2) * 2 + (gz % 2)
                wx = f[:, 0] if dx else 1.0 - f[:, 0]
                wy = f[:, 1] if dy else 1.0 - f[:, 1]
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                py_ = (P_[1] + 1 - (gy % 2)) // 2
                pz_ = (P_[2] + 1 - (gz % 2)) // 2
                flat = ((gx // 2) * py_ + (gy // 2)) * pz_ + (gz // 2)
                yield p, flat, wx * wy * wz


def _rank_buckets(counts, incidence_dst, weights, rows_of):
    """Destinations bucketed by incidence count: returns (rank of each
    destination in bucket order, [(n_d, d) rows_of incidences], [(n_d, d)
    weights]), ascending d, d = 0 buckets as empty (n_d, 0) blocks."""
    rank = np.argsort(np.argsort(counts, kind="stable"), kind="stable")
    order = np.argsort(rank[incidence_dst], kind="stable")
    counts_sorted = np.sort(counts, kind="stable")
    b_idx, b_w, pos = [], [], 0
    for d in np.unique(counts_sorted):
        n_d, d = int((counts_sorted == d).sum()), int(d)
        rows = order[pos:pos + n_d * d].reshape(n_d, d)
        b_idx.append(rows_of[rows])
        b_w.append(weights[rows])
        pos += n_d * d
    assert pos == len(order)
    return rank, b_idx, b_w


def build_lattice_transfer_pruned(points, origin, half_h, grid_shape, dtype=np.float64,
                                  eps: float = 1e-6, device=None) -> LatticeTransferPruned:
    """Pruned-transfer construction (see LatticeTransferPruned), host numpy
    then one upload."""
    P_ = np.asarray(grid_shape)
    counts_p = _phase_node_counts(P_)
    off8 = np.concatenate([[0], np.cumsum(counts_p)])[:8]
    L = int(sum(counts_p))
    N = len(points)
    # node-major (N, 8): per-corner columns written contiguously
    G = np.empty((N, 8), dtype=np.int64)  # row in the (L, 3) cat view
    w = np.empty((N, 8))
    for s, (p, flat, wgt) in enumerate(_corners(points, origin, half_h, P_)):
        G[:, s] = off8[p] + flat
        w[:, s] = wgt
    m = w > eps
    w_n = np.where(m, w, 0.0)
    w_n /= w_n.sum(axis=1)[:, None]  # renormalize kept weights per node

    # interpolate buckets: nodes by kept-corner count
    order8 = np.argsort(~m, axis=1, kind="stable")  # kept entries first
    rowsel = np.arange(N)[:, None] * 8 + order8
    g_c = G.reshape(-1)[rowsel]
    w_c = w_n.reshape(-1)[rowsel]
    d_node = m.sum(axis=1)
    order_nodes = np.argsort(d_node, kind="stable")
    node_rank = np.argsort(order_nodes, kind="stable")
    n_idx, n_w, pos = [], [], 0
    for d in np.unique(d_node):
        n_d, d = int((d_node == d).sum()), int(d)
        sel = order_nodes[pos:pos + n_d]
        n_idx.append(g_c[sel, :d])
        n_w.append(w_c[sel, :d])
        pos += n_d

    # restrict buckets: lattice cat rows by kept-incidence count
    n_inc = np.nonzero(m)[0]  # incidence list, node-major
    dst = G[m]
    lat_rank, l_idx, l_w = _rank_buckets(np.bincount(dst, minlength=L), dst, w_n[m], n_inc)
    return LatticeTransferPruned.from_host(n_idx, n_w, node_rank, l_idx, l_w, lat_rank,
                                           counts_p, dtype=dtype, device=device)


def build_lattice_transfer(points, origin, half_h, grid_shape, dtype=np.float64,
                           device=None) -> LatticeTransfer:
    """Dense trilinear transfer: each mesh point takes the 8 surrounding
    half-grid nodes, one of each parity phase (host numpy, then one
    upload)."""
    P_ = np.asarray(grid_shape)
    counts_p = _phase_node_counts(P_)
    N = len(points)
    idx = np.zeros((8, N), dtype=np.int64)
    w = np.zeros((8, N))
    cols = np.arange(N)
    for p, flat, wgt in _corners(points, origin, half_h, P_):
        idx[p, cols] = flat  # every point hits each parity exactly once
        w[p, cols] = wgt
    bucket_idx, bucket_w, perm_back = [], [], []
    for p in range(8):
        rank, b_idx, b_w = _rank_buckets(np.bincount(idx[p], minlength=counts_p[p]),
                                         idx[p], w[p], np.arange(N))
        bucket_idx.append(b_idx)
        bucket_w.append(b_w)
        perm_back.append(rank)
    return LatticeTransfer.from_host(idx, w, bucket_idx, bucket_w, perm_back, counts_p,
                                     dtype=dtype, device=device)


class LatticePreconditioner:
    """Two-level preconditioner for unstructured solid operators; call it on
    a residual in the caller's DOF layout (node_perm maps mesh nodes to it,
    e.g. SolidOperatorTG.new_of_old).

    Args (femx's, plus `device`):
      free_mask_global: (3N,) 1/0 in MESH node order.
      block_jacobi_apply: r -> D^-1 r in the caller's layout; or pass
        bj_fn (a function (bj_data, r) -> z, e.g.
        SolidOperatorSoA.apply_block_jacobi) with its bj_data.
      cells_per_axis: lattice cells; None matches the lattice cell spacing
        to the median per-element shortest corner edge.
      mode: "add", "mult" or "mult_sym"; the multiplicative modes need `op`
        (the unstructured operator, for A inside the residual updates).
      omega: block-Jacobi damping of the multiplicative modes (1.0 for
        "mult" when None).
      n_cycles: lattice V-cycles per coarse correction.
      n_caller: node count of a caller layout padded beyond the mesh.
      device: where the lattice hierarchy and transfers live (None = CUDA).
      structured_apply: the apply form of the lattice operators ("slot" or
        "conv"; None reads FEMX_STRUCTURED_APPLY).
    """

    def __init__(self, points, conn, E: float, nu: float, free_mask_global,
                 block_jacobi_apply=None, cells_per_axis=None, dtype=np.float64,
                 coarse_weight: float = 1.0, node_perm=None, bj_fn=None, bj_data=None,
                 mode: str = "add", op=None, omega: Optional[float] = None,
                 n_cycles: int = 2, n_caller: Optional[int] = None, device=None,
                 structured_apply: Optional[str] = None):
        dev = resolve_device(device)
        pts = np.asarray(points, dtype=np.float64)
        conn = np.asarray(conn)
        self.n_nodes = len(pts)
        if bj_fn is None:
            if block_jacobi_apply is None:
                raise ValueError("provide block_jacobi_apply or (bj_fn, bj_data)")
            bj_fn, bj_data = _call_closure, block_jacobi_apply
        if mode not in ("add", "mult", "mult_sym"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "add" and op is None:
            raise ValueError(f"mode={mode!r} needs the unstructured operator (op=)")

        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        span = np.where(hi - lo > 0, hi - lo, 1.0)
        if cells_per_axis is None:
            # lattice CELL spacing = median of each element's SHORTEST corner
            # edge (on Kuhn-subdivided grids only the min edge recovers h)
            c4 = pts[conn[:, :4]]
            pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
            edges = np.stack([np.linalg.norm(c4[:, a] - c4[:, b], axis=1)
                              for a, b in pairs], axis=1)
            h_el = np.median(edges.min(axis=1))
            cells_per_axis = tuple(_even_cells(span[a] / max(h_el, 1e-30)) for a in range(3))
        n_cells = tuple(int(c) for c in cells_per_axis)
        spacing = tuple(span[a] / n_cells[a] for a in range(3))

        lop = StructuredSolidOperator.from_lattice(n_cells, spacing, E, nu, dtype=dtype,
                                                   device=dev, apply_form=structured_apply)
        gs = lop.grid_shape
        half_h = np.asarray(spacing) / 2.0
        mu = np.asarray(free_mask_global).reshape(self.n_nodes, 3)
        mask_l = build_lattice_activity_mask(pts, mu, lo, half_h, gs).reshape(-1)
        mg = StructuredMultigrid(None, n_cells, E, nu, mask_l, spacing=spacing, dtype=dtype,
                                 fine_op=lop.with_free_mask(lop.to_internal(mask_l)),
                                 device=dev)

        if node_perm is not None:
            # injective mesh -> caller map; unmapped caller slots are dummies
            # with a zero mask
            npm = np.asarray(node_perm)
            n_cal = max(int(npm.max()) + 1, self.n_nodes,
                        0 if n_caller is None else int(n_caller))
            inv = np.zeros(n_cal, dtype=np.int64)
            have = np.zeros(n_cal, dtype=bool)
            inv[npm] = np.arange(len(npm))
            have[npm] = True
            pts_cal = pts[inv]
            mu_cal = np.where(have[:, None], mu[inv], 0.0)
        else:
            n_cal, pts_cal, mu_cal = self.n_nodes, pts, mu
        # the pruned transfer where enough weights are exact zeros to pay for
        # its two rank gathers (grid-matched lattices); else the dense one
        tp = build_lattice_transfer_pruned(pts_cal, lo, half_h, gs, dtype=dtype, device=dev)
        transfer = (tp if tp.kept_incidences() <= 4 * len(pts_cal) else
                    build_lattice_transfer(pts_cal, lo, half_h, gs, dtype=dtype, device=dev))
        self._init(mg, transfer, torch.as_tensor(mu_cal.reshape(-1), dtype=torch_dtype(dtype),
                                                 device=dev),
                   bj_fn, bj_data, n_cal=n_cal, n_cells=n_cells, spacing=spacing,
                   coarse_weight=coarse_weight, mode=mode, op=op, omega=omega,
                   n_cycles=n_cycles)

    def _init(self, mg, transfer, mask_cal, bj_fn, bj_data, n_cal, n_cells, spacing,
              coarse_weight, mode, op, omega, n_cycles):
        self.mg = mg
        self.transfer = transfer
        self._mask_cal = mask_cal
        self._lat_mask = mg.fine_op.free_mask
        self.bj_fn, self.bj_data = bj_fn, bj_data
        self.n_cal = int(n_cal)
        self.n_cells = tuple(int(c) for c in n_cells)
        self.spacing = tuple(float(s) for s in spacing)
        self.coarse_weight = float(coarse_weight)
        self.mode, self.op = mode, op
        self.omega = None if omega is None else float(omega)
        self.n_cycles = int(n_cycles)

    @classmethod
    def from_parts(cls, mg: StructuredMultigrid, transfer, mask_cal: torch.Tensor,
                   bj_fn, bj_data, n_nodes: int, n_cells, spacing,
                   coarse_weight: float = 1.0, mode: str = "add", op=None,
                   omega: Optional[float] = None, n_cycles: int = 2,
                   n_cal: Optional[int] = None) -> "LatticePreconditioner":
        """A preconditioner from ready-made parts (femx_torch.convert)."""
        out = cls.__new__(cls)
        out.n_nodes = int(n_nodes)
        out._init(mg, transfer, mask_cal, bj_fn, bj_data,
                  n_nodes if n_cal is None else n_cal, n_cells, spacing, coarse_weight,
                  mode, op, omega, n_cycles)
        return out

    # -- application ---------------------------------------------------------
    def coarse_correct(self, r: torch.Tensor) -> torch.Tensor:
        """P Mg P^T r (caller layout in and out, constrained both sides)."""
        with span("lattice.transfer"):
            rl = self.transfer.restrict(r * self._mask_cal) * self._lat_mask
        el = self.mg(rl) * self._lat_mask
        Al = self.mg.fine_op.apply_constrained
        for _ in range(self.n_cycles - 1):  # extra V-cycles on the lattice residual
            el = el + self.mg((rl - Al(el)) * self._lat_mask) * self._lat_mask
        with span("lattice.transfer"):
            return self.transfer.interpolate(el, self.n_cal) * self._mask_cal

    def _bj(self, r: torch.Tensor) -> torch.Tensor:
        with span("lattice.bj"):
            return self.bj_fn(self.bj_data, r)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if self.mode == "add":
            return self._bj(r) + self.coarse_weight * self.coarse_correct(r)
        A = self.op.apply_constrained
        om = 1.0 if self.omega is None else self.omega
        if self.mode == "mult":
            z = self.coarse_correct(r)
            return z + om * self._bj(r - A(z))
        z = om * self._bj(r)
        z = z + self.coarse_correct(r - A(z))
        return z + om * self._bj(r - A(z))

    def launches_per_call(self) -> dict:
        """Kernel launches of one call, by kernel: take_rows (the transfers,
        and the operator applies of the multiplicative modes) and
        structured_cell_matmul (5 per level above the coarsest per V-cycle,
        plus one lattice apply per extra cycle). On the card the V-cycles'
        launches come from the hierarchy's CUDA graph once it is captured,
        so the host counts them only for its eager first call and its
        capture."""
        n_int, n_res = self.transfer.gathers_per_call()
        op_applies = {"add": 0, "mult": 1, "mult_sym": 2}[self.mode]
        rows = n_int + n_res + op_applies * (self.op.gathers_per_apply if op_applies else 0)
        vcycle = 5 * (len(self.mg.levels) - 1)
        return {"take_rows": rows,
                "structured_cell_matmul": self.n_cycles * vcycle + self.n_cycles - 1}


def _call_closure(fn, r):
    return fn(r)


def estimate_bj_lambda_max(op, bj_fn, bj_data, iters: int = 20,
                           safety: float = 1.05) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) for the damping of the
    multiplicative modes (omega = 1/lambda_max keeps "mult_sym" SPD)."""
    n = op.ndof
    v = torch.sin(torch.arange(1, n + 1, dtype=op.dtype, device=op.device) * 0.73)
    v = v / torch.sqrt(torch.dot(v, v))
    for _ in range(int(iters)):
        w = bj_fn(bj_data, op.apply_constrained(v))
        v = w / torch.sqrt(torch.dot(w, w))
    w = bj_fn(bj_data, op.apply_constrained(v))
    return float(torch.dot(v, w) / torch.dot(v, v)) * safety

