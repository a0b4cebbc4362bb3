"""Element- and DOF-sharded unstructured solid operator with z-slab
ownership (port of femx/parallel/tg_sharded.py).

The mesh's nodes are z-sorted and split into slabs, one per rank; each
element belongs to the lowest slab it touches. One apply on a rank:

  1. ghost-sync: the owned values its neighbours' elements reference are
     exchanged (the two ppermutes of femx in one all_gather);
  2. local physics and transpose gather over the rank's own elements: the
     row gathers u[conn] and fe3[ell] are the take_rows kernel on the card,
     the element forces femx_torch.elements.tet10_soa;
  3. halo-reduce: the contributions to ghost rows go back to their owners
     (one more exchange) and are added.

Every element must span at most two adjacent slabs (setup raises
ValueError otherwise; callers fall back to one device). Each rank builds
only its own slab's arrays; the bookkeeping that places the ghosts is
computed for every rank, as it fixes the layout of the exchanges.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from femx_torch.assembly_structured import constrained_block_inverse
from femx_torch.config import numpy_dtype, resolve_device, torch_dtype
from femx_torch.elements import tet10_soa
from femx_torch.elements.tet10 import GAUSS_WEIGHT_CORRECT, material_matrix
from femx_torch.gather import index_tensor, take_rows
from femx_torch.parallel import comm
from femx_torch.solve.cg import pcg


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """t (m, 3) zero-padded (or cut) to n rows."""
    out = torch.zeros((n, t.shape[1]), dtype=t.dtype, device=t.device)
    m = min(n, t.shape[0])
    out[:m] = t[:m]
    return out


@dataclasses.dataclass(eq=False)
class ShardedTGOperator:
    """This rank's share of the sharded operator, and the host layout."""

    ndev: int
    rank: int
    n_nodes: int  # physical mesh nodes
    Nl: int  # owned node slots per rank (padded)
    G: int  # ghost slots per rank (padded)
    S: int  # interface send slots per direction (padded)
    E_max: int  # element slots per rank (padded)
    dNg: torch.Tensor  # (4, 3, 10, E_max)
    wdet: torch.Tensor  # (4, E_max); padding 0 => no force
    C6: np.ndarray  # (6, 6)
    weight: float
    conn_loc: torch.Tensor  # (10, E_max) local node slots
    ell_idx: torch.Tensor  # (Nl + G, D) rows of fe3 (pad -> its zero row)
    send_up: torch.Tensor  # (S,) owned slots rank + 1 reads
    send_dn: torch.Tensor  # (S,) owned slots rank - 1 reads
    g_dn: int  # ghost slots filled from rank - 1
    mask: torch.Tensor  # (Nl, 3) free mask of the owned nodes
    binv: torch.Tensor  # (Nl, 3, 3) block-Jacobi inverses of the owned nodes
    zperm: np.ndarray  # z rank -> mesh node
    bounds: np.ndarray  # (ndev + 1,) z-rank interval of each rank

    @classmethod
    def from_mesh(cls, points, conn, E_mod, nu, mesh=None, weight: Optional[float] = None,
                  dtype=np.float32, free_mask_global: Optional[np.ndarray] = None,
                  rank_bounds: Optional[np.ndarray] = None, device=None):
        """rank_bounds: optional (ranks + 1,) nondecreasing z-rank bounds
        (0 ... N): rank d owns the z-sorted nodes [bounds[d], bounds[d+1]).
        Default: equal counts."""
        if weight is None:
            weight = GAUSS_WEIGHT_CORRECT
        dev = resolve_device(device)
        points = np.asarray(points, dtype=np.float64)
        conn = np.asarray(conn)
        N = len(points)
        ndev = comm.world_size() if mesh is None else mesh.size
        me = comm.rank()
        dt = numpy_dtype(dtype)

        # ---- z-sorted slab ownership
        zperm = np.argsort(points[:, 2], kind="stable")
        rank_of = np.argsort(zperm, kind="stable")
        if rank_bounds is None:
            Nl = -(-N // ndev)
            bounds = np.minimum(np.arange(ndev + 1) * Nl, N)
        else:
            bounds = np.asarray(rank_bounds, dtype=np.int64)
            if not (bounds.shape == (ndev + 1,) and bounds[0] == 0 and bounds[-1] == N
                    and (np.diff(bounds) >= 0).all()):
                raise ValueError(f"rank_bounds must be a nondecreasing ({ndev + 1},) array "
                                 f"from 0 to {N}, got {bounds!r}")
            Nl = max(1, int(np.diff(bounds).max()))
        owner_node = np.clip(np.searchsorted(bounds, rank_of, side="right") - 1, 0, ndev - 1)
        ranks_e = rank_of[conn]
        owner_e = owner_node[conn].min(axis=1)
        span = owner_node[conn].max(axis=1) - owner_e
        if span.max() > 1:
            raise ValueError(f"{int((span > 1).sum())} elements span >2 z-slabs over {ndev} "
                             "ranks: slab thickness below element z-extent")

        # ---- element lists and ghosts of every rank (the exchange layout)
        elems = [np.where(owner_e == d)[0] for d in range(ndev)]
        E_max = max(1, max(len(e) for e in elems))
        lo, hi = bounds[:-1], bounds[1:]
        ghosts: List[np.ndarray] = []
        for d in range(ndev):
            r = ranks_e[elems[d]].reshape(-1)
            gh = np.unique(r[(r < lo[d]) | (r >= hi[d])])
            # [from rank d-1, ascending | from rank d+1, ascending]
            ghosts.append(np.concatenate([gh[gh < lo[d]], gh[gh >= hi[d]]]))
        g_dn_each = [int((g < lo[d]).sum()) for d, g in enumerate(ghosts)]
        g_dn = max([0] + g_dn_each)
        g_up = max([0] + [len(g) - gd for g, gd in zip(ghosts, g_dn_each)])
        G = g_dn + g_up
        S = max(1, g_dn, g_up)

        d = me
        e_own = elems[d]
        gh, gd = ghosts[d], g_dn_each[d]

        def local_ids(r):
            own = np.where((r >= lo[d]) & (r < hi[d]), r - lo[d], 0)
            pos = np.clip(np.searchsorted(gh, r), 0, max(len(gh) - 1, 0))
            is_ghost = (r < lo[d]) | (r >= hi[d])
            slot = np.where(pos < gd, Nl + pos, Nl + g_dn + (pos - gd))
            return np.where(is_ghost, slot, own)

        # ---- geometry: every element in float64 on the device (the nodal
        # blocks of owned nodes need the neighbours' elements too), this
        # rank's elements kept in `dtype`
        f64 = torch.float64
        coords = torch.as_tensor(tet10_soa.coords_soa(points, conn, np.float64), device=dev)
        dNg_all, wdet_all, _ = tet10_soa.geometry(coords)
        tdt = torch_dtype(dt)
        sel = torch.as_tensor(e_own, dtype=torch.int64, device=dev)
        dNg = torch.zeros((4, 3, 10, E_max), dtype=tdt, device=dev)
        wdet = torch.zeros((4, E_max), dtype=tdt, device=dev)
        dNg[..., :len(e_own)] = dNg_all[..., sel].to(tdt)
        wdet[..., :len(e_own)] = wdet_all[..., sel].to(tdt)
        conn_loc = np.zeros((10, E_max), dtype=np.int64)
        conn_loc[:, :len(e_own)] = local_ids(ranks_e[e_own].T)

        # ---- ELL transpose table: local node -> its rows of fe3
        n_loc = Nl + G
        node_of_row = conn_loc.reshape(-1)  # row = s * E_max + e
        rows = np.arange(10 * E_max)
        valid = (rows % E_max) < len(e_own)
        node_of_row, rows = node_of_row[valid], rows[valid]
        counts = np.bincount(node_of_row, minlength=n_loc)
        D = max(1, int(counts.max()) if counts.size else 1)
        ell = np.full((n_loc, D), 10 * E_max, dtype=np.int64)  # the appended zero row
        order = np.argsort(node_of_row, kind="stable")
        starts = np.zeros(n_loc + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(len(order)) - starts[node_of_row[order]]
        ell[node_of_row[order], pos] = rows[order]

        # ---- send lists: the neighbours' ghost blocks
        send_up = np.zeros(S, dtype=np.int64)
        send_dn = np.zeros(S, dtype=np.int64)
        if d + 1 < ndev:
            need = ghosts[d + 1][:g_dn_each[d + 1]]
            send_up[:len(need)] = need - lo[d]
        if d > 0:
            need = ghosts[d - 1][g_dn_each[d - 1]:]
            send_dn[:len(need)] = need - lo[d]

        # ---- mask and block-Jacobi of the owned nodes (full nodal blocks)
        if free_mask_global is None:
            free_mask_global = np.ones(3 * N)
        mask_rank = np.asarray(free_mask_global, dtype=np.float64).reshape(N, 3)[zperm]
        bke = tet10_soa.block_diagonal_entries(
            dNg_all, wdet_all, tet10_soa.chat_numpy(material_matrix(float(E_mod), float(nu))),
            float(weight))  # (10, 3, 3, E)
        conn_t = torch.as_tensor(conn.T, dtype=torch.int64, device=dev)
        bd = torch.zeros((N, 3, 3), dtype=f64, device=dev)
        for s in range(10):
            bd.index_add_(0, conn_t[s], bke[s].permute(2, 0, 1))
        bd_rank = bd.cpu().numpy()[zperm]
        n_own = int(min(hi[d], N) - lo[d])
        mask = np.zeros((Nl, 3))
        binv = np.tile(np.eye(3), (Nl, 1, 1))  # phantom padding slots: identity
        if n_own > 0:
            mask[:n_own] = mask_rank[lo[d]:lo[d] + n_own]
            binv[:n_own] = constrained_block_inverse(bd_rank[lo[d]:lo[d] + n_own],
                                                     mask[:n_own])
        return cls(
            ndev=ndev, rank=d, n_nodes=N, Nl=Nl, G=G, S=S, E_max=E_max, dNg=dNg, wdet=wdet,
            C6=material_matrix(float(E_mod), float(nu)).astype(dt), weight=float(weight),
            conn_loc=index_tensor(conn_loc, n_loc, dev),
            ell_idx=index_tensor(ell, 10 * E_max + 1, dev),
            send_up=index_tensor(send_up, Nl, dev), send_dn=index_tensor(send_dn, Nl, dev),
            g_dn=g_dn, mask=torch.as_tensor(mask, dtype=tdt, device=dev),
            binv=torch.as_tensor(binv, dtype=tdt, device=dev), zperm=zperm,
            bounds=np.asarray(bounds))

    @property
    def dtype(self) -> torch.dtype:
        return self.dNg.dtype

    @property
    def device(self) -> torch.device:
        return self.dNg.device

    # ---- host layout ------------------------------------------------------
    def scatter(self, v_global) -> np.ndarray:
        """(3N,) mesh-order vector -> (ranks, Nl, 3) owned-stacked (host)."""
        v3 = np.asarray(v_global).reshape(self.n_nodes, 3)[self.zperm]
        out = np.zeros((self.ndev, self.Nl, 3), dtype=v3.dtype)
        for d in range(self.ndev):
            n_own = self.bounds[d + 1] - self.bounds[d]
            out[d, :n_own] = v3[self.bounds[d]:self.bounds[d + 1]]
        return out

    def gather(self, v_st) -> np.ndarray:
        """(ranks, Nl, 3) -> (3N,) mesh-order vector (host)."""
        v_st = np.asarray(v_st)
        v3 = np.empty((self.n_nodes, 3), dtype=v_st.dtype)
        for d in range(self.ndev):
            n_own = self.bounds[d + 1] - self.bounds[d]
            v3[self.bounds[d]:self.bounds[d + 1]] = v_st[d, :n_own]
        out = np.empty_like(v3)
        out[self.zperm] = v3
        return out.reshape(-1)

    def to_local(self, v_global, dtype=None) -> torch.Tensor:
        """This rank's owned rows (Nl, 3) of a mesh-order vector."""
        return torch.as_tensor(self.scatter(v_global)[self.rank],
                               dtype=self.dtype if dtype is None else dtype,
                               device=self.device)

    def gather_local(self, v_own: torch.Tensor) -> np.ndarray:
        """Every rank's owned rows -> the (3N,) mesh-order vector on every
        rank (one all_gather)."""
        return self.gather(comm.all_gather(v_own.reshape(self.Nl, 3)).cpu().numpy())

    # ---- the apply --------------------------------------------------------
    def _ghost_sync(self, u_own: torch.Tensor) -> torch.Tensor:
        """(Nl, 3) owned -> (Nl + G, 3) with the ghost slots filled."""
        if self.ndev == 1:
            return torch.cat([u_own, u_own.new_zeros((self.G, 3))])
        from_below, from_above = comm.exchange(take_rows(u_own, self.send_dn),
                                               take_rows(u_own, self.send_up))
        return torch.cat([u_own, from_below[:self.g_dn], from_above[:self.G - self.g_dn]])

    def apply_local(self, u_own: torch.Tensor) -> torch.Tensor:
        """Owned (Nl, 3) -> owned (Nl, 3) rows of K u."""
        E = self.E_max
        u_loc = self._ghost_sync(u_own.contiguous())
        ue = take_rows(u_loc, self.conn_loc).transpose(1, 2).reshape(30, E)
        fe = tet10_soa.apply_element_forces(self.dNg, self.wdet, self.C6, ue, self.weight)
        fe3 = fe.reshape(10, 3, E).transpose(1, 2).reshape(10 * E, 3)
        fe3 = torch.cat([fe3, fe3.new_zeros((1, 3))])  # the ELL pad row
        y_loc = take_rows(fe3, self.ell_idx).sum(dim=1)  # (Nl + G, 3)
        if self.ndev == 1:
            return y_loc[:self.Nl]
        Nl, gdn = self.Nl, self.g_dn
        from_below, from_above = comm.exchange(_pad_rows(y_loc[Nl:Nl + gdn], self.S),
                                               _pad_rows(y_loc[Nl + gdn:Nl + self.G], self.S))
        y = y_loc[:Nl].clone()
        y.index_add_(0, self.send_up, from_above)
        y.index_add_(0, self.send_dn, from_below)
        return y

    def apply_constrained_local(self, u_own: torch.Tensor) -> torch.Tensor:
        v = self.apply_local(u_own * self.mask) * self.mask
        return v + u_own * (1.0 - self.mask)

    def block_jacobi_local(self, r_own: torch.Tensor) -> torch.Tensor:
        return torch.einsum("ncd,nd->nc", self.binv, r_own)


def pcg_tg_sharded(op: ShardedTGOperator, f_global, tol: float = 1e-8, maxiter: int = 10000,
                   x0_global=None) -> Tuple[np.ndarray, int, float, bool]:
    """Block-Jacobi PCG on the sharded operator, in its dtype; per iteration
    two exchanges per apply and two all_reduces. Returns (x_global,
    iterations, residual_norm, converged), x on every rank."""
    shape = (op.Nl, 3)

    def A(v):
        return op.apply_constrained_local(v.view(shape)).reshape(-1)

    def minv(r):
        return op.block_jacobi_local(r.view(shape)).reshape(-1)

    b = op.to_local(f_global).reshape(-1)
    x0 = None if x0_global is None else op.to_local(x0_global).reshape(-1)
    res = pcg(A, b, minv, x0=x0, tol=tol, maxiter=maxiter, dots=comm.dots)
    return op.gather_local(res.x), res.iterations, res.residual_norm, res.converged
