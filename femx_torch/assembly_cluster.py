"""Clustered dense-block unstructured operator (port of
femx/assembly_cluster.py).

Elements are grouped into clusters of k tets, consecutive along a Morton
(z-curve) centroid order so cluster members share nodes; each cluster's
stiffness is pre-assembled into one dense (3m, 3m) matrix over its m unique
nodes. The apply gathers the m node rows of every cluster, runs one batched
dense matvec per size class, and sums the per-cluster forces to the nodes by
a degree-bucketed transpose gather over (cluster, slot) incidences, as the
transpose-gather operator does over (element, slot) ones.

Clusters are bucketed into size classes (m rounded up to a multiple of 8)
so padding costs little. The cluster structure is found on the host in
numpy, as femx does; the element stiffness and the cluster blocks are
summed in float64 on the operator's device and cast to its dtype at the end
(femx sums them on the host in the operator's dtype). Every row gather of the apply, u3[nodes]
and the buckets' fe3[idx], is femx_torch.gather.take_rows, the hand-written
CUDA kernel on the card; the dense matvec is a torch batched matmul in true
FP32/FP64, as it is an XLA contraction in femx. The operator runs in its
internal cluster-degree-sorted node order; to_internal / to_global convert
on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from femx_torch.config import resolve_device, torch_dtype
from femx_torch.elements import tet10 as tet10_el
from femx_torch.elements.tet10 import DN_NATURAL, GAUSS_WEIGHT_CORRECT, _SEL, material_matrix
from femx_torch.gather import index_tensor, take_rows


@dataclasses.dataclass(eq=False)
class SolidOperatorCluster:
    """Per-size-class dense cluster blocks + bucketed transpose gather."""

    Kcl: List[torch.Tensor]  # per class (n_c, 3M_c, 3M_c)
    cl_nodes: List[torch.Tensor]  # per class (n_c, M_c) internal node ids
    class_M: List[int]
    bucket_idx: List[torch.Tensor]  # per degree (n_d, d) rows into fe3
    bucket_degrees: List[int]
    new_of_old: np.ndarray  # node relabel old -> internal
    n_nodes: int
    weight: float
    free_mask: Optional[torch.Tensor] = None  # internal DOF layout
    free_mask_host: Optional[np.ndarray] = None  # the same, when given as numpy

    @classmethod
    def from_mesh(cls, points, conn, E_mod, nu, weight=None, dtype=np.float32,
                  cluster_size: int = 16, device=None):
        """Build from host mesh arrays on `device`. Returns (op, detJ)."""
        if weight is None:
            weight = GAUSS_WEIGHT_CORRECT
        points = np.asarray(points, dtype=np.float64)
        conn = np.asarray(conn)
        N, E = len(points), len(conn)
        k = int(cluster_size)

        # ---- cluster formation: Morton (z-curve) centroid order -------
        cent = points[conn[:, :4]].mean(axis=1)
        lo_c = cent.min(axis=0)
        ptp = cent.max(axis=0) - lo_c
        span_c = np.where(ptp > 0, ptp, 1.0)
        q = np.minimum((1023 * (cent - lo_c) / span_c).astype(np.int64), 1023)
        key = np.zeros(E, dtype=np.int64)
        for b in range(10):
            for a in range(3):
                key |= ((q[:, a] >> b) & 1) << (3 * b + a)
        order = np.argsort(key, kind="stable")
        n_cl = -(-E // k)
        elems = np.full(n_cl * k, -1, dtype=np.int64)
        elems[:E] = order
        elems = elems.reshape(n_cl, k)

        # ---- unique nodes + degree (vectorized over clusters) ---------
        # conn of padded elements -> sentinel N (sorts last, dropped)
        conn_pad = np.full((n_cl, k, 10), N, dtype=np.int64)
        valid_e = elems >= 0
        conn_pad[valid_e] = conn[elems[valid_e]]
        flat = np.sort(conn_pad.reshape(n_cl, 10 * k), axis=1)
        is_new = np.ones_like(flat, dtype=bool)
        is_new[:, 1:] = flat[:, 1:] != flat[:, :-1]
        is_new &= flat < N
        m_c = is_new.sum(axis=1)  # unique nodes per cluster

        deg = np.zeros(N + 1, dtype=np.int64)
        np.add.at(deg, flat[is_new], 1)
        deg = deg[:N]
        new_of_old = np.argsort(np.argsort(deg, kind="stable"), kind="stable")

        # ---- size classes (M rounded up to multiples of 8) --------------
        M_of = np.maximum(8, ((m_c + 7) // 8) * 8)
        class_M = sorted(int(v) for v in np.unique(M_of))
        order_cl = np.argsort(M_of, kind="stable")  # class-grouped clusters

        dev = resolve_device(device)
        ke, djs = [], []
        for _, vals, dj in element_stiffness_chunks(points, conn, E_mod, nu, weight, dev):
            ke.append(vals.permute(0, 1, 3, 2, 4).reshape(-1, 30, 30))  # (i, c), (j, d)
            djs.append(dj)
        ke, detJ = torch.cat(ke), np.concatenate(djs)

        conn_int = new_of_old[conn]
        Kcl_list, cl_nodes_list = [], []
        fe_offsets = []  # flat fe row offset of each class
        off = 0
        for M in class_M:
            cidx = order_cl[M_of[order_cl] == M]
            n_c = len(cidx)
            nodes_c = np.zeros((n_c, M), dtype=np.int64)
            sent = np.full((n_c, M), N + 1, dtype=np.int64)
            for row, c in enumerate(cidx):
                u = flat[c][is_new[c]]
                nodes_c[row, :len(u)] = new_of_old[u]
                sent[row, :len(u)] = new_of_old[u]
            sortperm = np.argsort(sent, axis=1, kind="stable")
            nodes_sorted = np.take_along_axis(sent, sortperm, axis=1)

            Kc = torch.zeros((n_c, 3 * M, 3 * M), dtype=torch.float64, device=dev)
            rr = np.arange(n_c)
            for j in range(k):
                es = elems[cidx, j]
                ok = es >= 0
                ev = es[ok]
                rv = rr[ok]
                loc = _rows_searchsorted(nodes_sorted[rv], sortperm[rv], conn_int[ev], N + 2)
                dof = torch.as_tensor((3 * loc[:, :, None] + np.arange(3)).reshape(len(ev), 30),
                                      device=dev)
                rows = torch.as_tensor(rv, device=dev)
                # one element per cluster row per j: the index triples are
                # unique, so the summed values land where femx's do
                Kc.index_put_((rows[:, None, None], dof[:, :, None], dof[:, None, :]),
                              ke[torch.as_tensor(ev, device=dev)], accumulate=True)
            Kcl_list.append(Kc.to(torch_dtype(dtype)))
            cl_nodes_list.append(nodes_c)
            fe_offsets.append(off)
            off += n_c * M
        del ke

        # ---- transpose buckets over (cluster, slot) incidences --------
        # fe row of (class t, cluster row r, slot s) = off_t + r * M_t + s
        node_of_row = np.empty(off, dtype=np.int64)
        row_valid = np.zeros(off, dtype=bool)
        for t, (M, nodes) in enumerate(zip(class_M, cl_nodes_list)):
            n_c = nodes.shape[0]
            cidx = order_cl[M_of[order_cl] == M]
            sl = fe_offsets[t] + np.arange(n_c * M)
            node_of_row[sl] = nodes.reshape(-1)
            row_valid[sl] = (np.arange(M)[None, :] < m_c[cidx][:, None]).reshape(-1)
        rows = np.where(row_valid)[0]
        order_r = np.argsort(node_of_row[rows], kind="stable")
        deg_int = deg[np.argsort(new_of_old, kind="stable")]
        buckets, bucket_degrees = [], []
        pos = 0
        for d in np.unique(deg_int):
            n_d, d = int((deg_int == d).sum()), int(d)
            buckets.append(rows[order_r[pos:pos + n_d * d].reshape(n_d, d)])
            bucket_degrees.append(d)
            pos += n_d * d
        assert pos == len(order_r)

        op = cls.from_arrays(Kcl_list, cl_nodes_list, class_M, buckets, bucket_degrees,
                             new_of_old, weight, device=dev)
        return op, detJ

    @classmethod
    def from_arrays(cls, Kcl, cl_nodes, class_M, bucket_idx, bucket_degrees, new_of_old,
                    weight, device=None) -> "SolidOperatorCluster":
        """The operator from its arrays on `device` (indices range-checked
        once here: the gather kernel trusts them); Kcl (host arrays or
        tensors) sets the operator's dtype."""
        dev = resolve_device(device)
        n_nodes = len(new_of_old)
        Ms = [int(M) for M in class_M]
        n_rows = sum(np.asarray(n).shape[0] * M for n, M in zip(cl_nodes, Ms))
        degs = [int(d) for d in bucket_degrees]
        return cls(
            Kcl=[torch.as_tensor(K, device=dev) for K in Kcl],
            cl_nodes=[index_tensor(np.asarray(n), n_nodes, dev) for n in cl_nodes],
            class_M=Ms,
            bucket_idx=[index_tensor(np.asarray(b), n_rows, dev) for b in bucket_idx],
            bucket_degrees=degs, new_of_old=np.asarray(new_of_old), n_nodes=n_nodes,
            weight=float(weight))

    # -- layout ---------------------------------------------------------
    @property
    def ndof(self) -> int:
        return 3 * self.n_nodes

    @property
    def dtype(self) -> torch.dtype:
        return self.Kcl[0].dtype

    @property
    def device(self) -> torch.device:
        return self.Kcl[0].device

    @property
    def gathers_per_apply(self) -> int:
        """take_rows launches of one apply: u3[nodes] per size class and one
        per nonempty degree bucket."""
        return len(self.class_M) + sum(1 for d in self.bucket_degrees if d > 0)

    def to_internal(self, x: np.ndarray) -> np.ndarray:
        x3 = np.asarray(x).reshape(self.n_nodes, 3)
        out = np.empty_like(x3)
        out[self.new_of_old] = x3
        return out.reshape(-1)

    def to_global(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y).reshape(self.n_nodes, 3)[self.new_of_old].reshape(-1)

    def with_free_mask(self, free_mask_internal) -> "SolidOperatorCluster":
        """The operator with a free mask in the internal layout (numpy or a
        tensor; a numpy mask is also kept on the host for the block-Jacobi
        build)."""
        m = free_mask_internal
        host = m if isinstance(m, np.ndarray) else None
        t = (m.to(device=self.device, dtype=self.dtype) if isinstance(m, torch.Tensor)
             else torch.tensor(np.asarray(m), dtype=self.dtype, device=self.device))
        return dataclasses.replace(self, free_mask=t, free_mask_host=host)

    def astype(self, dtype) -> "SolidOperatorCluster":
        """The same operator with its blocks and mask cast to `dtype`."""
        dt = torch_dtype(dtype)
        if dt == self.dtype:
            return self
        return dataclasses.replace(
            self, Kcl=[K.to(dt) for K in self.Kcl],
            free_mask=None if self.free_mask is None else self.free_mask.to(dt))

    # -- core -----------------------------------------------------------
    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u (internal layout)."""
        u3 = u.reshape(self.n_nodes, 3)
        fe_parts = []
        for K, nodes, M in zip(self.Kcl, self.cl_nodes, self.class_M):
            ue = take_rows(u3, nodes)  # (n_c, M, 3) row gather
            fe = torch.matmul(K, ue.reshape(K.shape[0], 3 * M, 1))
            fe_parts.append(fe.reshape(-1, 3))
        fe3 = torch.cat(fe_parts)  # rows in the classes' fe layout
        parts = [take_rows(fe3, idx).sum(dim=1) if d else
                 torch.zeros((idx.shape[0], 3), dtype=fe3.dtype, device=fe3.device)
                 for idx, d in zip(self.bucket_idx, self.bucket_degrees)]
        return torch.cat(parts).reshape(-1)

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.free_mask
        return self.apply(u * s) * s + u * (1.0 - s)

    # -- preconditioning -------------------------------------------------
    def block_jacobi_tensors(self) -> torch.Tensor:
        """(n_nodes, 3, 3) inverse nodal blocks in the operator's dtype,
        constrained by the free mask, internal node order (the data of
        apply_block_jacobi); the diagonal blocks are summed in float64 on
        the operator's device."""
        f64 = torch.float64
        bd = torch.zeros((self.n_nodes, 3, 3), dtype=f64, device=self.device)
        for K, nodes, M in zip(self.Kcl, self.cl_nodes, self.class_M):
            n_c = K.shape[0]
            diag = torch.diagonal(K.reshape(n_c, M, 3, M, 3), dim1=1, dim2=3)  # (n_c,3,3,M)
            bd.index_add_(0, nodes.reshape(-1).long(),
                          diag.permute(0, 3, 1, 2).reshape(-1, 3, 3).to(f64))
        mask = (torch.as_tensor(self.free_mask_host, device=self.device)
                if self.free_mask_host is not None else self.free_mask)
        s = mask.to(f64).reshape(self.n_nodes, 3)
        bd = bd * s[:, :, None] * s[:, None, :]
        bd = bd + (1.0 - s)[:, :, None] * torch.eye(3, dtype=f64, device=self.device)
        binv, _ = tet10_el._inv3x3(bd)
        return binv.to(self.dtype)

    @staticmethod
    def apply_block_jacobi(binv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        return torch.einsum("ncd,nd->nc", binv, r.reshape(-1, 3)).reshape(-1)

    def gather_rows(self) -> int:
        """Total gather rows per apply (the quantity this operator
        minimizes; compare against the TG operator's 20E)."""
        ue = sum(int(n.shape[0]) * M for n, M in zip(self.cl_nodes, self.class_M))
        tr = sum(b.shape[0] * max(d, 1) for b, d in zip(self.bucket_idx, self.bucket_degrees))
        return ue + tr


class ClusterBJPrecond:
    """Callable wrapper of the cluster block-Jacobi tensors (a
    preconditioner object for pcg, as femx's pytree wrapper)."""

    def __init__(self, tensors: torch.Tensor):
        self.tensors = tensors

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return SolidOperatorCluster.apply_block_jacobi(self.tensors, r)


def element_stiffness_chunks(points, conn, E_mod, nu, weight, device, chunk: int = 16384):
    """Tet10 element stiffness in float64 on `device`, `chunk` elements at a
    time: yields (first element, vals (e, 10, 10, 3, 3) with
    vals[e, i, j, c, d] = K_e[(i, c), (j, d)], detJ (e, 4) host numpy),
    the Gauss points summed one by one to bound the intermediates."""
    f64 = torch.float64
    chat = tet10_el.chat_tensor(torch.as_tensor(material_matrix(E_mod, nu), dtype=f64,
                                                device=device))
    for s in range(0, len(conn), max(1, int(chunk))):
        coords = torch.as_tensor(points[conn[s:s + chunk]], dtype=f64, device=device)
        dN, wdet, dj = tet10_el.jacobians(coords)  # (e, 4, 3, 10), (e, 4)
        wdet = wdet * float(weight)
        vals = None
        for g in range(dN.shape[1]):
            t = torch.einsum("eki,ckdl->eicdl", dN[:, g] * wdet[:, g, None, None], chat)
            kg = torch.einsum("eicdl,elj->eijcd", t, dN[:, g])
            vals = kg if vals is None else vals + kg
        yield s, vals, dj.cpu().numpy()


def element_stiffness_host(points, conn, E_mod, nu, weight, chunk: int = 131072):
    """(E, 30, 30) float64 element matrices + detJ (E, 4), host numpy in
    element chunks (femx's _element_stiffness_host; the group-ELL host
    build, the parity reference, sums these)."""
    conn = np.asarray(conn)
    E = len(conn)
    C = material_matrix(E_mod, nu)
    chat = np.einsum("ack,ab,bdl->ckdl", _SEL, C, _SEL)
    ke = np.empty((E, 30, 30))
    detJ = np.empty((E, 4))
    for s in range(0, E, chunk):
        coords = points[conn[s:s + chunk]]  # (e, 10, 3)
        J = np.einsum("gkn,enc->egkc", DN_NATURAL, coords)
        Jinv = np.linalg.inv(J)
        dj = np.linalg.det(J)
        dN = np.einsum("egkc,gcn->egkn", Jinv, DN_NATURAL)
        wdet = np.where(dj > 1e-12, dj, 0.0)
        kk = np.einsum("egki,ckdl,eglj,eg->eicjd", dN, chat, dN, weight * wdet, optimize=True)
        ke[s:s + chunk] = kk.reshape(-1, 30, 30)
        detJ[s:s + chunk] = dj
    return ke, detJ


def _rows_searchsorted(rows_sorted, sortperm, queries, base):
    """Per-row searchsorted, vectorized through row-offset keys.

    rows_sorted: (B, M) each row ascending with values < base; sortperm:
    (B, M) such that rows_sorted = row_original[sortperm]; queries: (B, Q)
    values known to be present in their row. Returns slot positions in the
    original (unsorted) row order."""
    B, M = rows_sorted.shape
    off = np.arange(B, dtype=np.int64)[:, None] * base
    flat = (rows_sorted.astype(np.int64) + off).reshape(-1)
    q = queries.astype(np.int64) + off
    p = np.searchsorted(flat, q.reshape(-1)).reshape(queries.shape)
    p_local = p - np.arange(B)[:, None] * M
    return np.take_along_axis(sortperm, p_local, axis=1)
