"""Structured-box Tetra10 mesh generator (host numpy).

Copy of the solid half of femx.mesh.generators for the port. The reference
delegates meshing to gmsh (gmsh_creation.py:18-108) and only ever builds an
axis-aligned box, so this is a deterministic structured Kuhn-subdivision
Tetra10 box mesher with the same physical-group contract: "box" (3D),
"Neumann_BCs" and "Diri_BCs" (0D vertices at the force/fix points).
Off-lattice BC points are embedded as real mesh nodes by local node
relocation with a positive-detJ guard (box_tet10_from_cells(embed_points=...)).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from femx_torch.elements.tet10 import DN_NATURAL
from femx_torch.mesh.core import Mesh

# Kuhn/Freudenthal subdivision: 6 positively-oriented tets per hex, each a
# monotone lattice path 000 -> 111 through vertex bits (bx, by, bz).
_KUHN_PATHS = (
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),
)

# Gmsh Tetra10 edge ordering (midside nodes 4..9), matching the reference
# element kernel's shape-function layout (ReactionSolver.py:100-113).
TET10_EDGES = ((0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3))

# The 7 monotone axis sets S of a Kuhn edge direction.
_EDGE_DIRS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
              (0, 1, 1), (1, 1, 1))


def tet4_to_tet10(points: np.ndarray, conn4: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Promote a Tetra4 mesh to Tetra10 by inserting shared midside nodes."""
    conn4 = np.asarray(conn4, dtype=np.int64)
    edges = np.stack([conn4[:, list(e)] for e in TET10_EDGES], axis=1)  # (E, 6, 2)
    flat = np.sort(edges, axis=-1).reshape(-1, 2)
    key = flat[:, 0] * (len(points) + 1) + flat[:, 1]
    uniq_key, inverse = np.unique(key, return_inverse=True)
    uniq_pairs = np.stack([uniq_key // (len(points) + 1), uniq_key % (len(points) + 1)], axis=1)
    mid_points = 0.5 * (points[uniq_pairs[:, 0]] + points[uniq_pairs[:, 1]])
    mid_ids = len(points) + inverse.reshape(len(conn4), 6)
    conn10 = np.concatenate([conn4, mid_ids], axis=1).astype(np.int32)
    return np.concatenate([points, mid_points], axis=0), conn10


class StructuredBoxInfo:
    """Lattice metadata for a structured box Tetra10 mesh.

    Node numbering IS the raster order of the half-spaced ("doubled")
    lattice: node id = flat index of integer position (p, q, r) in a grid of
    shape (2nx+1, 2ny+1, 2nz+1), coordinate = origin + (p,q,r) * h/2. Every
    lattice position is a mesh node (corners at even positions, Tet10
    midside nodes at odd ones), which is what makes the gather-free
    structured stiffness operator possible (femx_torch.assembly_structured).
    """

    def __init__(self, n_cells, spacing, origin):
        self.n_cells = tuple(int(v) for v in n_cells)  # (nx, ny, nz)
        self.spacing = tuple(float(v) for v in spacing)  # cell size per axis
        self.origin = tuple(float(v) for v in origin)

    @property
    def grid_shape(self):
        return tuple(2 * n + 1 for n in self.n_cells)

    @property
    def num_nodes(self):
        P = self.grid_shape
        return P[0] * P[1] * P[2]

    def node_id(self, p, q, r):
        P = self.grid_shape
        return (np.asarray(p) * P[1] + np.asarray(q)) * P[2] + np.asarray(r)


def box_tet10(
    x: float,
    y: float,
    z: float,
    mesh_size: float,
    force_points: Optional[Sequence[Sequence[float]]] = None,
    fix_points: Optional[Sequence[Sequence[float]]] = None,
    origin: Sequence[float] = (0.0, 0.0, 0.0),
    embed_points: bool = True,
) -> Mesh:
    """Structured Tetra10 mesh of an axis-aligned box with BC point groups
    (the reference's gmsh box workflow, gmsh_creation.py:18-108): physical
    groups "box" (3D, tetra10), "Neumann_BCs" (0D, force points) and
    "Diri_BCs" (0D, fix points); nodes in half-spaced-lattice raster order
    (StructuredBoxInfo on ``mesh.structured``)."""
    dims = np.array([x, y, z], dtype=np.float64)
    n = np.maximum(1, np.round(dims / mesh_size).astype(int))
    h = dims / n
    return box_tet10_from_cells(
        (int(n[0]), int(n[1]), int(n[2])), h,
        force_points=force_points, fix_points=fix_points, origin=origin,
        embed_points=embed_points,
    )


def _embed_point_exactly(all_points, conn10, info, node_id, pqr, target):
    """Relocate lattice node `node_id` to the exact `target` coordinate,
    keeping the Tet10 mesh geometrically consistent (the reference embeds BC
    points as real mesh nodes via OCC ``fragment``, gmsh_creation.py:38-61).

    Corner nodes (all-even lattice position) drag the midside nodes of their
    incident edges to the new edge midpoints — in the Kuhn complex every
    midside node m belongs to exactly one edge, the monotone segment
    (m - 1_S, m + 1_S) — so edges stay straight. Midside nodes move alone.

    Returns (affected tet row indices for the caller's detJ check, moved
    node ids, their pre-move coordinates for an exact revert)."""
    Px, Py, Pz = info.grid_shape

    def incident_midsides():
        for S in _EDGE_DIRS:
            d = np.asarray(S)
            for sgn in (1, -1):
                m = pqr + sgn * d
                a, b = m - d, m + d
                if np.any(a < 0) or np.any(b >= (Px, Py, Pz)):
                    continue
                yield m, a, b

    corner = not np.any(pqr % 2)
    moved = [int(node_id)]
    if corner:
        moved += [int(info.node_id(*m)) for m, _a, _b in incident_midsides()]
    moved_ids = np.asarray(moved)
    old_coords = all_points[moved_ids].copy()
    all_points[node_id] = target
    if corner:  # midpoints AFTER the corner moved
        for m, a, b in incident_midsides():
            all_points[int(info.node_id(*m))] = 0.5 * (
                all_points[int(info.node_id(*a))] + all_points[int(info.node_id(*b))])
    rows = np.where(np.isin(conn10, moved_ids).any(axis=1))[0]
    return rows, moved_ids, old_coords


def box_tet10_from_cells(
    n_cells: Sequence[int],
    spacing: Sequence[float],
    force_points: Optional[Sequence[Sequence[float]]] = None,
    fix_points: Optional[Sequence[Sequence[float]]] = None,
    origin: Sequence[float] = (0.0, 0.0, 0.0),
    embed_points: bool = True,
) -> Mesh:
    """box_tet10 with exact per-axis cell counts and spacings.

    embed_points: force/fix points that do NOT lie on the lattice are
    embedded as real mesh nodes at the exact requested coordinate by
    relocating the nearest node (positive detJ verified; reverted to
    nearest-node snapping if an element would invert). A mesh with any
    relocated node loses its uniform lattice, so ``mesh.structured`` is
    None. Per-point outcomes are recorded in ``mesh.bc_embed_info``.
    """
    nx, ny, nz = (int(v) for v in n_cells)
    h = np.asarray(spacing, dtype=np.float64)
    info = StructuredBoxInfo((nx, ny, nz), h, origin)

    Px, Py, Pz = info.grid_shape
    all_points = np.empty((Px, Py, Pz, 3), dtype=np.float64)
    all_points[..., 0] = (np.arange(Px) * (h[0] / 2) + origin[0])[:, None, None]
    all_points[..., 1] = (np.arange(Py) * (h[1] / 2) + origin[1])[None, :, None]
    all_points[..., 2] = (np.arange(Pz) * (h[2] / 2) + origin[2])[None, None, :]
    all_points = all_points.reshape(-1, 3)

    # Connectivity by translation invariance: every tet of Kuhn path k is the
    # cell-origin node id plus a constant (10,) id offset; orientation is
    # constant per path, so it is checked on one representative tet.
    base_id = (
        (2 * np.arange(nx, dtype=np.int32))[:, None, None] * (Py * Pz)
        + (2 * np.arange(ny, dtype=np.int32))[None, :, None] * Pz
        + (2 * np.arange(nz, dtype=np.int32))[None, None, :]
    ).reshape(-1)
    h2 = h / 2.0
    n_c = base_id.shape[0]
    conn10 = np.empty((6 * n_c, 10), dtype=np.int32)
    for k, path in enumerate(_KUHN_PATHS):
        corners = np.asarray(path, dtype=np.int64) * 2  # (4, 3) doubled coords
        rep = corners * h2
        if np.linalg.det(rep[1:] - rep[:1]) < 0:
            corners = corners[[0, 2, 1, 3]]
        mids = np.stack([(corners[a] + corners[b]) // 2 for a, b in TET10_EDGES])
        pqr10 = np.concatenate([corners, mids], axis=0)  # (10, 3)
        offsets = ((pqr10[:, 0] * Py + pqr10[:, 1]) * Pz + pqr10[:, 2]).astype(np.int32)
        np.add(base_id[:, None], offsets[None, :], out=conn10[k * n_c:(k + 1) * n_c])

    cells = {"tetra10": conn10}
    phys = {"tetra10": np.ones(len(conn10), dtype=np.int32)}
    field_data = {"box": (1, 3)}

    vertex_cells: List[List[int]] = []
    vertex_phys: List[int] = []
    bc_embed_info: List[dict] = []
    any_moved = False
    snap_tol = 1e-9 * float(np.max(h))
    for group_points, tag, name in (
        (force_points, 2, "Neumann_BCs"),
        (fix_points, 3, "Diri_BCs"),
    ):
        if not group_points:
            continue
        field_data[name] = (tag, 0)
        for p in group_points:
            # Nearest node = nearest half-spaced lattice position; ceil(t-1/2)
            # resolves exact midpoints to the LOWER node.
            target = np.asarray(p, dtype=np.float64)
            t = (target - np.asarray(origin)) / h2
            pqr = np.clip(np.ceil(t - 0.5), 0,
                          np.asarray([Px, Py, Pz]) - 1).astype(np.int64)
            nid = int((pqr[0] * Py + pqr[1]) * Pz + pqr[2])
            dist = float(np.linalg.norm(all_points[nid] - target))
            rec = {"group": name, "requested": tuple(map(float, target)),
                   "node": nid, "snap_distance": dist, "embedded": False}
            if dist > snap_tol and embed_points:
                rows, moved_ids, old_coords = _embed_point_exactly(
                    all_points, conn10, info, nid, pqr, target)
                coords = all_points[conn10[rows]]
                J = np.einsum("gkn,enc->egkc", DN_NATURAL, coords)
                if float(np.linalg.det(J).min()) > 1e-12:
                    rec.update(embedded=True, snap_distance=0.0)
                    any_moved = True
                else:  # would invert an element: revert, keep the snap
                    all_points[moved_ids] = old_coords
            vertex_cells.append([nid])
            vertex_phys.append(tag)
            bc_embed_info.append(rec)
    if vertex_cells:
        cells["vertex"] = np.asarray(vertex_cells, dtype=np.int32)
        phys["vertex"] = np.asarray(vertex_phys, dtype=np.int32)

    mesh = Mesh(points=all_points, cells=cells, cell_physical=phys, field_data=field_data)
    mesh.structured = None if any_moved else info
    mesh.bc_embed_info = bc_embed_info
    mesh.validate()
    return mesh
