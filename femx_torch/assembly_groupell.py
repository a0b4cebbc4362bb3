"""Group-ELL assembled unstructured operator (port of
femx/assembly_groupell.py) — wide-row gathers only.

  * nodes are Morton-ordered and cut into column groups of 16 consecutive
    nodes = 48 values of u, one wide gather row;
  * K is pre-assembled into dense (6, 48) blocks per (node pair, column
    group);
  * node pairs are bucketed by their group count g and live in
    bucket-major internal order, so per bucket the apply is
      u16[idx]                       (n_g, g, 48)   wide row gather
      sum_{g,w} u16[idx] * Kb        (n_g, 6)       dense contraction
    and the outputs concatenate, with no scatter;
  * the only narrow movement left is one pair-level permutation
    (bucket-major -> Morton) of (NP, 6) rows per apply.

Every row gather (u6[pairperm], each bucket's u16[idx], and on the symmetric
side the degree buckets of c2, the out_take and ord_rb permutations) is
femx_torch.gather.take_rows, the hand-written CUDA kernel on the card. The
contraction stays a torch batched matmul in true FP32/FP64, as it is a plain
XLA contraction in femx (femx's FEMX_GROUPELL_CONTRACT picks between two
forms of the same contraction; the port has one form).

Two builds, as femx: the host build (exact float64 numpy aggregation, the
parity reference) and the device build (the default): the block structure
is found on the host in numpy, the element stiffness and the value
accumulation run on the operator's device in torch, chunked by
FEMX_GROUPELL_CHUNK. The device build accumulates in float64 and casts at
the end (femx's accumulates in the operator's dtype), so its float32
operator is the float64 one rounded once. Options as femx: symmetric
storage (FEMX_GROUPELL_SYM, device build only), the block storage dtype
(kb_dtype / FEMX_GROUPELL_KB, e.g. bfloat16) and the group-count
quantization FEMX_GROUPELL_QUANT. astype(other dtype) returns a SoA shadow
on the padded internal mesh (GroupELLShadow), as femx's does; `cast` gives
the same operator, structure shared, with its blocks in another dtype.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from femx_torch.assembly_cluster import element_stiffness_chunks, element_stiffness_host
from femx_torch.assembly_soa import SolidOperatorSoA
from femx_torch.assembly_structured import _inv3x3_np
from femx_torch.config import numpy_dtype, resolve_device, torch_dtype
from femx_torch.elements.tet10 import GAUSS_WEIGHT_CORRECT
from femx_torch.gather import index_tensor, take_rows
from femx_torch.mesh.reorder import morton_codes

GROUP = 16  # nodes per column group (48 values of u: one wide gather row)
PAIR = 2  # nodes per row block
_BLKW = 6 * 3 * GROUP  # values per (6, 48) block


def _storage_dtype(kb_dtype, io: torch.dtype) -> torch.dtype:
    """kb_dtype (or FEMX_GROUPELL_KB, else the io dtype) as a torch dtype;
    names such as "bfloat16" included."""
    kb = kb_dtype or os.environ.get("FEMX_GROUPELL_KB", "") or io
    if isinstance(kb, str):
        if not isinstance(getattr(torch, kb, None), torch.dtype):
            raise TypeError(f"unknown block dtype {kb!r}")
        return getattr(torch, kb)
    return torch_dtype(kb)


def _block_layout(ublocks: np.ndarray, NG: int, NP: int):
    """The bucket-major layout of the sorted (row pair, column group) block
    keys: node pairs bucketed by their group count g (rounded up to a
    multiple of FEMX_GROUPELL_QUANT, padded slots index group 0 with a zero
    block), each block's row within its bucket and slot within its pair.
    Returns (rank_rb: morton pair -> internal pair, order_rb: its inverse,
    blk_g, blk_row, blk_slot per block, the distinct g, them as ints, pairs
    per g)."""
    blk_rb = ublocks // NG
    g_of_rb = np.bincount(blk_rb, minlength=NP)  # groups per pair
    quant = max(1, int(os.environ.get("FEMX_GROUPELL_QUANT", "1")))
    gq_of_rb = -(-g_of_rb // quant) * quant  # 0 stays 0
    order_rb = np.argsort(gq_of_rb, kind="stable")  # bucket-major
    rank_rb = np.argsort(order_rb, kind="stable")  # morton pair -> internal
    g_sorted = gq_of_rb[order_rb]
    cstart = np.r_[0, np.cumsum(np.bincount(g_sorted))][:-1]  # start per g
    blk_g = gq_of_rb[blk_rb]
    blk_row = rank_rb[blk_rb] - cstart[blk_g]
    # ublocks is sorted by (rb, grp): the slot is the index within the rb run
    rb_starts = np.r_[0, np.flatnonzero(np.diff(blk_rb)) + 1]
    blk_slot = np.arange(len(ublocks)) - np.repeat(rb_starts,
                                                   np.diff(np.r_[rb_starts, len(ublocks)]))
    gs = np.unique(g_sorted)
    n_of_g = {int(g): int((g_sorted == g).sum()) for g in gs}
    return rank_rb, order_rb, blk_g, blk_row, blk_slot, gs, [int(g) for g in gs], n_of_g


@dataclasses.dataclass(eq=False)
class SolidOperatorGroupELL:
    """Assembled (pair x 16-node-group) dense-block ELL, bucketed by g."""

    idx: List[torch.Tensor]  # per bucket (n_g, g) group ids
    Kb: List[torch.Tensor]  # per bucket (n_g, g, 6, 48)
    bucket_g: List[int]
    pairperm: torch.Tensor  # (NP,) morton pair -> internal pair
    new_of_old: np.ndarray  # mesh node -> internal node id
    n_nodes: int  # real mesh nodes
    n_pad: int  # internal nodes (multiple of GROUP)
    weight: float
    io_dtype: torch.dtype  # vector (u/f/mask) dtype; Kb may be stored narrower
    # host data for the block-Jacobi tensors, the diagonal and the shadow
    bd_host: np.ndarray  # (n_pad, 3, 3) float64 nodal diagonal blocks, internal order
    points: np.ndarray
    conn: np.ndarray
    E_mod: float
    nu: float
    free_mask: Optional[torch.Tensor] = None  # (3*n_pad,) internal layout
    free_mask_host: Optional[np.ndarray] = None  # the same, when given as numpy
    # symmetric storage: Kb holds only tiles with morton row node <= col
    # node; the apply adds the transpose side from the same blocks
    # (per-block column contributions accumulated per column group by
    # degree-bucketed wide row gathers) and subtracts the double-counted
    # nodal diagonal
    symmetric: bool = False
    tidx: Optional[List[torch.Tensor]] = None  # per degree bucket (m_d, d)
    tdeg: Optional[List[int]] = None  # block positions per group
    out_take: Optional[torch.Tensor] = None  # (NG,) -> concat row (or zero row)
    ord_rb: Optional[torch.Tensor] = None  # (NP,) internal -> morton pair
    bd_dev: Optional[torch.Tensor] = None  # (n_pad, 3, 3) true diagonal

    # ------------------------------------------------------------------
    @classmethod
    def from_mesh(cls, points, conn, E_mod, nu, weight=None, dtype=np.float32, kb_dtype=None,
                  build=None, symmetric=None, device=None):
        """Build from host mesh arrays on `device`. Returns (op, detJ).

        build: "device" (default; env FEMX_GROUPELL_BUILD overrides) or
        "host" (the exact float64 numpy aggregation, full storage only).
        kb_dtype: block storage dtype (default: dtype; env FEMX_GROUPELL_KB,
        e.g. "bfloat16"). symmetric: None reads FEMX_GROUPELL_SYM."""
        build = build or os.environ.get("FEMX_GROUPELL_BUILD", "") or "device"
        if build == "host":
            if symmetric:
                raise ValueError("symmetric storage is device-build only (the host build is "
                                 "the full-storage parity reference)")
            return cls._from_mesh_host(points, conn, E_mod, nu, weight=weight, dtype=dtype,
                                       kb_dtype=kb_dtype, device=device)
        if build != "device":
            raise ValueError(f"build must be 'device' or 'host', got {build!r}")
        return cls._from_mesh_device(points, conn, E_mod, nu, weight=weight, dtype=dtype,
                                     kb_dtype=kb_dtype, symmetric=symmetric, device=device)

    @classmethod
    def _from_mesh_host(cls, points, conn, E_mod, nu, weight=None, dtype=np.float32,
                        kb_dtype=None, device=None):
        """Exact-float64 host aggregation build (the parity reference)."""
        if weight is None:
            weight = GAUSS_WEIGHT_CORRECT
        dev = resolve_device(device)
        points = np.asarray(points, dtype=np.float64)
        conn = np.asarray(conn)
        N, E = len(points), len(conn)
        n_pad = -(-N // GROUP) * GROUP
        dt = numpy_dtype(dtype)
        kbt = _storage_dtype(kb_dtype, torch_dtype(dt))

        # ---- Morton node order (dummies pad the tail) -------------------
        perm_m = np.argsort(morton_codes(points), kind="stable")
        morton_of_old = np.argsort(perm_m, kind="stable")  # mesh -> morton
        cm = morton_of_old[conn]  # (E, 10)

        ke, detJ = element_stiffness_host(points, conn, E_mod, nu, float(weight))

        # ---- aggregate to unique node pairs (float64 sums) ---------------
        rowm = np.repeat(cm, 10, axis=1).reshape(-1).astype(np.int64)
        colm = np.tile(cm, (1, 10)).reshape(-1).astype(np.int64)
        key = rowm * n_pad + colm
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        starts = np.r_[0, np.flatnonzero(np.diff(key_s)) + 1]
        upairs = key_s[starts]  # unique (r, c)
        e_i, a_i, b_i = order // 100, (order // 10) % 10, order % 10
        kev = ke.reshape(E, 10, 3, 10, 3)
        vals = kev[e_i[:, None, None], a_i[:, None, None], np.arange(3)[None, :, None],
                   b_i[:, None, None], np.arange(3)[None, None, :]]  # (100E, 3, 3)
        agg = np.add.reduceat(vals.reshape(-1, 9), starts, axis=0)
        del vals, kev, key, key_s, order, e_i, a_i, b_i
        ur = upairs // n_pad  # morton row node
        uc = upairs % n_pad  # morton col node
        agg_diag64 = agg[ur == uc].reshape(-1, 3, 3).copy()

        # ---- (pair, group) blocks + g buckets ----------------------------
        rb = ur // PAIR
        grp = uc // GROUP
        NP, NG = n_pad // PAIR, n_pad // GROUP
        ublocks = np.unique(rb * NG + grp)  # sorted (rb, grp)
        (rank_rb, order_rb, blk_g, blk_row, blk_slot, gs, bucket_g,
         n_of_g) = _block_layout(ublocks, NG, NP)
        new_of_old = rank_rb[morton_of_old // PAIR] * PAIR + morton_of_old % PAIR

        # ---- allocate buckets, place aggregated 3x3s (unique slots) ------
        idx_h = {g: np.zeros((n_of_g[g], g), dtype=np.int64) for g in bucket_g}
        Kb_h = {g: np.zeros((n_of_g[g], g, 6, 3 * GROUP)) for g in bucket_g}
        for g in bucket_g:
            m = blk_g == g
            idx_h[g][blk_row[m], blk_slot[m]] = ublocks[m] % NG
        # each pair's block and its in-block (rloc, cloc) 3x3 tile: the
        # destinations are unique, so a flat assignment places every value
        pblock = np.searchsorted(ublocks, rb * NG + grp)
        pr, pc = ur % PAIR, uc % GROUP
        off = (np.arange(3)[:, None] * (3 * GROUP) + np.arange(3)[None, :]).reshape(-1)
        for g in bucket_g:
            if g == 0:
                continue
            m = blk_g[pblock] == g
            flat = Kb_h[g].reshape(-1)
            base = ((blk_row[pblock[m]] * g + blk_slot[pblock[m]]) * _BLKW
                    + pr[m] * 3 * (3 * GROUP) + pc[m] * 3)
            flat[(base[:, None] + off[None, :]).reshape(-1)] = agg[m].reshape(-1)

        ar = np.arange(n_pad)
        int_of_morton = rank_rb[ar // PAIR] * PAIR + ar % PAIR
        # nodal diagonal blocks in internal order (float64, for
        # block-Jacobi); dummy nodes keep identity so their inverse blocks
        # stay finite
        bd = np.tile(np.eye(3), (n_pad, 1, 1))
        bd[int_of_morton[ur[ur == uc]]] = agg_diag64
        op = cls(
            idx=[index_tensor(idx_h[g], NG, dev) for g in bucket_g],
            Kb=[torch.as_tensor(Kb_h[g].astype(dt), device=dev).to(kbt) for g in bucket_g],
            bucket_g=bucket_g, pairperm=index_tensor(rank_rb, NP, dev), new_of_old=new_of_old,
            n_nodes=N, n_pad=n_pad, weight=float(weight), io_dtype=torch_dtype(dt),
            bd_host=bd, points=points, conn=conn, E_mod=float(E_mod), nu=float(nu))
        return op, detJ

    @classmethod
    def _from_mesh_device(cls, points, conn, E_mod, nu, weight=None, dtype=np.float32,
                          kb_dtype=None, symmetric=None, device=None):
        """Device build (the default): the block structure is found on the
        host (one unique over the 100E block keys; the rest is per block),
        the element stiffness and the value accumulation run on `device`
        in float64, in element chunks: batched Tet10 stiffness, then one
        flat index_add_ of every 3x3 (row node, col node) tile into the
        bucket-major block buffer and of the nodal diagonal blocks."""
        if weight is None:
            weight = GAUSS_WEIGHT_CORRECT
        if symmetric is None:
            symmetric = os.environ.get("FEMX_GROUPELL_SYM", "0") == "1"
        dev = resolve_device(device)
        points = np.asarray(points, dtype=np.float64)
        conn = np.asarray(conn)
        N, E = len(points), len(conn)
        n_pad = -(-N // GROUP) * GROUP
        io = torch_dtype(dtype)
        kbt = _storage_dtype(kb_dtype, io)

        # ---- Morton node order (dummies pad the tail) -------------------
        perm_m = np.argsort(morton_codes(points), kind="stable")
        morton_of_old = np.argsort(perm_m, kind="stable")  # mesh -> morton
        cm = morton_of_old[conn]  # (E, 10) int64
        NP, NG = n_pad // PAIR, n_pad // GROUP

        # ---- block structure (one 100E unique; the rest is per block) ----
        bk = (cm // PAIR)[:, :, None] * NG + (cm // GROUP)[:, None, :]
        if symmetric:
            # store each (row node, col node) tile once: keep r <= c in
            # morton order
            ublocks = np.unique(bk[cm[:, :, None] <= cm[:, None, :]])
        else:
            ublocks = np.unique(bk)  # sorted (rb, grp)
        del bk
        (rank_rb, order_rb, blk_g, blk_row, blk_slot, gs, bucket_g,
         n_of_g) = _block_layout(ublocks, NG, NP)
        new_of_old = rank_rb[morton_of_old // PAIR] * PAIR + morton_of_old % PAIR

        # ---- flat bucket-major layout + per-block base offsets ----------
        idx_base_b = np.r_[0, np.cumsum([n_of_g[g] * g for g in bucket_g])]
        kb_base_b = idx_base_b * _BLKW
        gidx_of = np.zeros(int(gs.max()) + 1, dtype=np.int64)
        gidx_of[gs] = np.arange(len(gs))
        blk_gidx = gidx_of[blk_g]
        within = blk_row.astype(np.int64) * blk_g + blk_slot
        idx_pos = idx_base_b[blk_gidx] + within
        idx_all = np.zeros(int(idx_base_b[-1]), dtype=np.int64)
        idx_all[idx_pos] = ublocks % NG
        block_base = kb_base_b[blk_gidx] + within * _BLKW  # (NB,)
        ar = np.arange(n_pad)
        int_of_morton = rank_rb[ar // PAIR] * PAIR + ar % PAIR

        # ---- device accumulation (float64) --------------------------------
        f64, i64 = torch.float64, torch.int64
        ub_d = torch.as_tensor(ublocks, device=dev)
        bb_d = torch.as_tensor(block_base, device=dev)
        iom_d = torch.as_tensor(int_of_morton, device=dev)
        flat = torch.zeros(int(kb_base_b[-1]), dtype=f64, device=dev)
        bd_d = torch.zeros(n_pad * 9, dtype=f64, device=dev)
        tile = (torch.arange(3, device=dev)[:, None] * (3 * GROUP)
                + torch.arange(3, device=dev)[None, :])  # (3, 3) in-block offsets
        a10 = torch.arange(10, device=dev)
        chunk = int(os.environ.get("FEMX_GROUPELL_CHUNK", "16384"))
        djs = []
        for s, vals, dj in element_stiffness_chunks(points, conn, E_mod, nu, weight, dev, chunk):
            cm_c = torch.as_tensor(cm[s:s + len(dj)], dtype=i64, device=dev)
            vdiag = vals[:, a10, a10]  # (e, 10, 3, 3)
            if symmetric:
                # the dropped (r > c) tiles add 0.0 wherever their clamped
                # destination lands
                vals = vals * (cm_c[:, :, None] <= cm_c[:, None, :])[..., None, None]
            bkc = (cm_c // PAIR)[:, :, None] * NG + (cm_c // GROUP)[:, None, :]
            pblock = torch.searchsorted(ub_d, bkc).clamp_(max=len(ublocks) - 1)
            base = (bb_d[pblock] + (cm_c % PAIR)[:, :, None] * (3 * 3 * GROUP)
                    + (cm_c % GROUP)[:, None, :] * 3)
            flat.index_add_(0, (base[..., None, None] + tile).reshape(-1), vals.reshape(-1))
            bdest = (iom_d[cm_c] * 9)[..., None] + torch.arange(9, device=dev)
            bd_d.index_add_(0, bdest.reshape(-1), vdiag.reshape(-1))
            djs.append(dj)
        detJ = np.concatenate(djs)

        # nodal diagonal blocks (internal order) for block-Jacobi; nodes with
        # no stiffness (dummies / isolated) keep identity so their inverse
        # blocks stay finite (the host build's rule)
        bd = bd_d.reshape(n_pad, 3, 3).cpu().numpy()
        del bd_d
        empty = ~(np.abs(bd).reshape(n_pad, 9).max(axis=1) > 0)
        bd[empty] = np.eye(3)
        Kb = [flat[int(a):int(a) + n_of_g[g] * g * _BLKW].view(n_of_g[g], g, 6, 3 * GROUP)
              .to(kbt) for g, a in zip(bucket_g, kb_base_b[:-1])]
        del flat
        idx = [index_tensor(idx_all[idx_base_b[i]:idx_base_b[i + 1]].reshape(n_of_g[g], g),
                            NG, dev) for i, g in enumerate(bucket_g)]

        sym_fields = {}
        if symmetric:
            # transpose-side structure: per column group, the flat positions
            # (bucket-major block order) of its incident blocks, bucketed by
            # incidence degree
            q = ublocks % NG
            pos_s = idx_pos[np.argsort(q, kind="stable")]
            deg = np.bincount(q, minlength=NG)
            gstart = np.r_[0, np.cumsum(deg)][:-1]
            tidx, tdeg, tgroups = [], [], []
            n_blocks = int(idx_base_b[-1])
            for d in np.unique(deg[deg > 0]):
                sel = np.flatnonzero(deg == d)
                tidx.append(index_tensor(pos_s[gstart[sel][:, None] + np.arange(d)[None, :]],
                                         n_blocks, dev))
                tdeg.append(int(d))
                tgroups.append(sel)
            cat = np.concatenate(tgroups) if tgroups else np.zeros(0, np.int64)
            out_take = np.full(NG, len(cat), dtype=np.int64)  # the zero row
            out_take[cat] = np.arange(len(cat))
            bd_true = bd.copy()
            bd_true[empty] = 0.0
            sym_fields = dict(symmetric=True, tidx=tidx, tdeg=tdeg,
                              out_take=index_tensor(out_take, len(cat) + 1, dev),
                              ord_rb=index_tensor(order_rb, NP, dev),
                              bd_dev=torch.as_tensor(bd_true, device=dev).to(io))

        op = cls(idx=idx, Kb=Kb, bucket_g=bucket_g, pairperm=index_tensor(rank_rb, NP, dev),
                 new_of_old=new_of_old, n_nodes=N, n_pad=n_pad, weight=float(weight),
                 io_dtype=io, bd_host=bd, points=points, conn=conn, E_mod=float(E_mod),
                 nu=float(nu), **sym_fields)
        return op, detJ

    # -- layout ------------------------------------------------------------
    @property
    def ndof(self) -> int:
        return 3 * self.n_pad

    @property
    def n_elements(self) -> int:
        return len(self.conn)

    @property
    def dtype(self) -> torch.dtype:
        """Vector (u/f/mask) dtype; Kb storage may be narrower."""
        return self.io_dtype

    @property
    def device(self) -> torch.device:
        return self.pairperm.device

    @property
    def gathers_per_apply(self) -> int:
        """take_rows launches of one apply: u6[pairperm], one per nonempty
        bucket, and on the symmetric side one per degree bucket plus the
        out_take and ord_rb permutations."""
        n = 1 + sum(1 for g in self.bucket_g if g > 0)
        return n + (len(self.tidx) + 2 if self.symmetric else 0)

    def to_internal(self, x: np.ndarray) -> np.ndarray:
        x3 = np.asarray(x).reshape(self.n_nodes, 3)
        out = np.zeros((self.n_pad, 3), dtype=x3.dtype)
        out[self.new_of_old] = x3
        return out.reshape(-1)

    def to_global(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y).reshape(self.n_pad, 3)[self.new_of_old].reshape(-1)

    def with_free_mask(self, free_mask_internal) -> "SolidOperatorGroupELL":
        """The operator with a free mask in the internal layout (numpy or a
        tensor; a numpy mask is also kept on the host, where the
        block-Jacobi tensors are built)."""
        m = free_mask_internal
        host = m if isinstance(m, np.ndarray) else None
        t = (m.to(device=self.device, dtype=self.dtype) if isinstance(m, torch.Tensor)
             else torch.tensor(np.asarray(m), dtype=self.dtype, device=self.device))
        return dataclasses.replace(self, free_mask=t, free_mask_host=host)

    def cast(self, dtype, kb_dtype=None) -> "SolidOperatorGroupELL":
        """The same operator (its structure shared) with vectors in `dtype`
        and blocks in kb_dtype (default: FEMX_GROUPELL_KB, else dtype)."""
        io = torch_dtype(dtype)
        kbt = _storage_dtype(kb_dtype, io)
        return dataclasses.replace(
            self, io_dtype=io, Kb=[k.to(kbt) for k in self.Kb],
            free_mask=None if self.free_mask is None else self.free_mask.to(io),
            bd_dev=None if self.bd_dev is None else self.bd_dev.to(io))

    def astype(self, dtype):
        """Itself in its own dtype; in another, a SoA shadow on the padded
        internal mesh (exact element einsum + scatter; femx's residual
        operator for refinement), carrying this operator's layout
        converters."""
        dt = torch_dtype(dtype)
        if dt == self.dtype:
            return self
        pts_int = np.zeros((self.n_pad, 3))
        pts_int[self.new_of_old] = self.points
        shadow, _ = SolidOperatorSoA.from_mesh(pts_int, self.new_of_old[self.conn], self.E_mod,
                                               self.nu, weight=self.weight, dtype=dt,
                                               device=self.device)
        if self.free_mask is not None:
            shadow = shadow.with_free_mask(self.free_mask.to(dt))
        return GroupELLShadow(soa=shadow, new_of_old=self.new_of_old, n_nodes=self.n_nodes,
                              n_pad=self.n_pad)

    # -- core ----------------------------------------------------------------
    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u (internal bucket-major layout)."""
        u6 = u.reshape(-1, 3 * PAIR)
        u16 = take_rows(u6, self.pairperm).reshape(-1, 3 * GROUP)  # morton (NG, 48) table
        outs, c2s = [], []
        off = 0
        for ii, kk, g in zip(self.idx, self.Kb, self.bucket_g):
            n_g = ii.shape[0]
            if g == 0:
                outs.append(torch.zeros((n_g, 3 * PAIR), dtype=u.dtype, device=u.device))
                off += n_g
                continue
            got = take_rows(u16, ii)  # (n_g, g, 48) wide rows
            outs.append(_contract(got, kk).to(u.dtype))
            if self.symmetric:
                # per-block column contributions Kb^T u_pair (48,) from the
                # same blocks; a bucket's pairs are contiguous in the
                # internal order, so u needs no gather here
                ub = u6[off:off + n_g].to(kk.dtype)
                c2 = torch.matmul(ub[:, None, None, :], kk).to(u.dtype)  # (n_g, g, 1, 48)
                c2s.append(c2.reshape(n_g * g, 3 * GROUP))
            off += n_g
        y1 = torch.cat(outs)  # (NP, 6) internal order
        if not self.symmetric:
            return y1.reshape(-1)
        # transpose side: sum the block contributions per column group
        # (degree-bucketed wide row gathers), back to morton groups, to the
        # internal pair order, minus the double-counted nodal diagonal
        c2 = torch.cat(c2s) if c2s else u.new_zeros((0, 3 * GROUP))
        parts = [take_rows(c2, tt).sum(dim=1) for tt in self.tidx]  # (m_d, 48)
        parts.append(u.new_zeros((1, 3 * GROUP)))
        y2m = take_rows(torch.cat(parts), self.out_take)  # (NG, 48) morton
        y2 = take_rows(y2m.reshape(-1, 3 * PAIR), self.ord_rb)  # internal pairs
        du = torch.einsum("ncd,nd->nc", self.bd_dev, u.reshape(-1, 3))
        return (y1 + y2).reshape(-1) - du.reshape(-1)

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.free_mask
        return self.apply(u * s) * s + u * (1.0 - s)

    # -- preconditioning ------------------------------------------------------
    def block_jacobi_tensors(self) -> torch.Tensor:
        """(n_pad, 3, 3) inverse nodal blocks, constrained by the free mask,
        internal node order (dummy nodes get identity); built on the host
        in float64, returned in the operator's dtype on its device."""
        mask = (self.free_mask_host if self.free_mask_host is not None
                else self.free_mask.cpu().numpy()).reshape(self.n_pad, 3).astype(np.float64)
        bd = self.bd_host * (mask[:, :, None] * mask[:, None, :])
        bd += (1.0 - mask)[:, :, None] * np.eye(3)
        return torch.as_tensor(_inv3x3_np(bd), device=self.device).to(self.dtype)

    @staticmethod
    def apply_block_jacobi(binv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        return torch.einsum("ncd,nd->nc", binv, r.reshape(-1, 3)).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        d = np.einsum("ncc->nc", self.bd_host).reshape(-1)
        return torch.as_tensor(d, device=self.device).to(self.dtype)

    def gather_rows(self) -> int:
        """Wide gather rows per apply (vs the TG operator's 20E narrow)."""
        return sum(int(i.shape[0]) * g for i, g in zip(self.idx, self.bucket_g))


@dataclasses.dataclass(eq=False)
class GroupELLShadow:
    """Residual operator of a SolidOperatorGroupELL in another dtype: the
    SoA element apply on the padded internal mesh plus the parent's layout
    converters."""

    soa: SolidOperatorSoA  # on the padded internal mesh
    new_of_old: np.ndarray  # mesh node -> internal node id
    n_nodes: int
    n_pad: int

    @property
    def dtype(self) -> torch.dtype:
        return self.soa.dtype

    @property
    def ndof(self) -> int:
        return 3 * self.n_pad

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        return self.soa.apply(u)

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        return self.soa.apply_constrained(u)

    def to_internal(self, x: np.ndarray) -> np.ndarray:
        x3 = np.asarray(x).reshape(self.n_nodes, 3)
        out = np.zeros((self.n_pad, 3), dtype=x3.dtype)
        out[self.new_of_old] = x3
        return out.reshape(-1)

    def to_global(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y).reshape(self.n_pad, 3)[self.new_of_old].reshape(-1)

    def astype(self, dtype) -> "GroupELLShadow":
        if torch_dtype(dtype) == self.dtype:
            return self
        return dataclasses.replace(self, soa=self.soa.astype(dtype))


def _contract(got: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """Per-bucket contraction (n, g, 48) x (n, g, 6, 48) -> (n, 6). In the
    blocks' own dtype it is a batched matvec over (n, g) that reads Kb in
    place, then a sum over g; narrower blocks (bfloat16) contract the
    gathered rows cast to their dtype in one reduction over (g, w)."""
    if kk.dtype == got.dtype:
        return torch.matmul(kk, got.unsqueeze(-1)).squeeze(-1).sum(dim=1)
    return torch.einsum("ngw,ngrw->nr", got.to(kk.dtype), kk)
