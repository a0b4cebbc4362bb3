"""2D mesh generation: structured rectangle Tri6 meshes + Tri3 promotion
(a numpy copy of femx/mesh/generators2d.py for the port).

The meshes of the 2D products (PlaneAnalysis, PipeThermalAnalysis):

- ``rect_tri6``: a structured rectangle in (x, y) — or (r, z) for the
  axisymmetric pipe — split into Tri6 triangles, the four boundary edges
  tagged as line3 physical groups ("left", "right", "bottom", "top") and the
  solid path's point groups ("Neumann_BCs"/"Diri_BCs" vertex groups,
  nearest-node snapping); ``mesh.lattice2d`` records the lattice, which the
  2D multigrid keys off;
- ``tri3_to_tri6``: promote a linear-triangle mesh to quadratic by inserting
  shared midside nodes.

Node numbering of ``rect_tri6`` is the raster order of the half-spaced
lattice (x-major), nid = p * (2 ny + 1) + q.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from femx_torch.mesh.core import Mesh

# gmsh triangle6 midside order: edges (0,1), (1,2), (2,0)
TRI6_EDGES = ((0, 1), (1, 2), (2, 0))


def tri3_to_tri6(points: np.ndarray, conn3: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Promote a Tri3 mesh to Tri6 by inserting shared midside nodes.

    Args: points (N, 2|3); conn3 (E, 3) int. Returns (all_points, conn6)
    with conn6 (E, 6) int32 in gmsh triangle6 order.
    """
    conn3 = np.asarray(conn3, dtype=np.int64)
    points = np.asarray(points, dtype=np.float64)
    edges = np.stack([conn3[:, list(e)] for e in TRI6_EDGES], axis=1)  # (E, 3, 2)
    edges_sorted = np.sort(edges, axis=-1)
    flat = edges_sorted.reshape(-1, 2)
    key = flat[:, 0] * (len(points) + 1) + flat[:, 1]
    uniq_key, inverse = np.unique(key, return_inverse=True)
    uniq_pairs = np.stack(
        [uniq_key // (len(points) + 1), uniq_key % (len(points) + 1)], axis=1)
    mid_points = 0.5 * (points[uniq_pairs[:, 0]] + points[uniq_pairs[:, 1]])
    mid_ids = len(points) + inverse.reshape(len(conn3), 3)
    conn6 = np.concatenate([conn3, mid_ids], axis=1).astype(np.int32)
    return np.concatenate([points, mid_points], axis=0), conn6


def rect_tri6(
    x: float,
    y: float,
    mesh_size: float,
    force_points: Optional[Sequence[Sequence[float]]] = None,
    fix_points: Optional[Sequence[Sequence[float]]] = None,
    origin: Sequence[float] = (0.0, 0.0),
) -> Mesh:
    """Structured Tri6 mesh of an axis-aligned rectangle with BC groups.

    Returns a Mesh with physical groups:
      "surface" (2D, triangle6 cells),
      "left"/"right"/"bottom"/"top" (1D, line3 boundary edges),
      "Neumann_BCs"/"Diri_BCs" (0D vertices at force/fix points, snapped to
      the nearest lattice node — the 2D analog of the solid point contract).

    Points are (N, 3) with z = 0 (the Mesh container is 3D); the analysis
    pipelines read columns (0, 1) as (x, y) — or (r, z) for axisymmetric use.
    """
    dims = np.array([x, y], dtype=np.float64)
    n = np.maximum(1, np.round(dims / mesh_size).astype(int))
    return rect_tri6_from_cells((int(n[0]), int(n[1])), dims / n,
                                force_points=force_points,
                                fix_points=fix_points, origin=origin)


def rect_tri6_from_cells(
    n_cells: Sequence[int],
    spacing: Sequence[float],
    force_points: Optional[Sequence[Sequence[float]]] = None,
    fix_points: Optional[Sequence[Sequence[float]]] = None,
    origin: Sequence[float] = (0.0, 0.0),
) -> Mesh:
    """rect_tri6 with exact per-axis cell counts and spacings."""
    nx, ny = (int(v) for v in n_cells)
    h = np.asarray(spacing, dtype=np.float64)
    ox, oy = (float(v) for v in origin)
    Px, Py = 2 * nx + 1, 2 * ny + 1

    pts = np.empty((Px, Py, 3), dtype=np.float64)
    pts[..., 0] = (np.arange(Px) * (h[0] / 2) + ox)[:, None]
    pts[..., 1] = (np.arange(Py) * (h[1] / 2) + oy)[None, :]
    pts[..., 2] = 0.0
    all_points = pts.reshape(-1, 3)

    def nid(p, q):
        return np.asarray(p) * Py + np.asarray(q)

    # Two positively-oriented triangles per cell, by translation invariance:
    # conn = base corner id + constant offsets (same idiom as the 3D box).
    base = nid(2 * np.arange(nx)[:, None], 2 * np.arange(ny)[None, :]).reshape(-1)
    tris = (  # (corner half-lattice coords) per triangle, CCW
        ((0, 0), (2, 0), (2, 2)),
        ((0, 0), (2, 2), (0, 2)),
    )
    conn6 = np.empty((2 * len(base), 6), dtype=np.int32)
    for k, corners in enumerate(tris):
        c = np.asarray(corners, dtype=np.int64)
        mids = np.stack([(c[a] + c[b]) // 2 for a, b in TRI6_EDGES])
        pq6 = np.concatenate([c, mids], axis=0)  # (6, 2)
        offs = (pq6[:, 0] * Py + pq6[:, 1]).astype(np.int32)
        conn6[k * len(base):(k + 1) * len(base)] = base[:, None] + offs[None, :]

    cells = {"triangle6": conn6}
    phys = {"triangle6": np.ones(len(conn6), dtype=np.int32)}
    field_data = {"surface": (1, 2)}

    # Boundary edges as line3 cells (vertex, vertex, midside — gmsh order),
    # one group per side. These are what whole-edge BCs resolve through.
    line_cells: List[List[int]] = []
    line_phys: List[int] = []
    edge_specs = (
        ("left", nid(0, np.arange(0, Py - 2, 2)),
         nid(0, np.arange(2, Py, 2)), nid(0, np.arange(1, Py - 1, 2))),
        ("right", nid(Px - 1, np.arange(0, Py - 2, 2)),
         nid(Px - 1, np.arange(2, Py, 2)), nid(Px - 1, np.arange(1, Py - 1, 2))),
        ("bottom", nid(np.arange(0, Px - 2, 2), 0),
         nid(np.arange(2, Px, 2), 0), nid(np.arange(1, Px - 1, 2), 0)),
        ("top", nid(np.arange(0, Px - 2, 2), Py - 1),
         nid(np.arange(2, Px, 2), Py - 1), nid(np.arange(1, Px - 1, 2), Py - 1)),
    )
    tag = 2
    for name, a, b, m in edge_specs:
        field_data[name] = (tag, 1)
        for i in range(len(a)):
            line_cells.append([int(a[i]), int(b[i]), int(m[i])])
            line_phys.append(tag)
        tag += 1
    cells["line3"] = np.asarray(line_cells, dtype=np.int32)
    phys["line3"] = np.asarray(line_phys, dtype=np.int32)

    # Point groups with nearest-lattice-node snapping (the solid contract).
    vertex_cells: List[List[int]] = []
    vertex_phys: List[int] = []
    bc_embed_info: List[dict] = []
    h2 = h / 2.0
    for group_points, gtag, name in (
        (force_points, tag, "Neumann_BCs"),
        (fix_points, tag + 1, "Diri_BCs"),
    ):
        if not group_points:
            continue
        field_data[name] = (gtag, 0)
        for p in group_points:
            target = np.asarray(p, dtype=np.float64)[:2]
            t = (target - np.asarray([ox, oy])) / h2
            pq = np.clip(np.ceil(t - 0.5), 0,
                         np.asarray([Px, Py]) - 1).astype(np.int64)
            node = int(nid(pq[0], pq[1]))
            dist = float(np.linalg.norm(all_points[node, :2] - target))
            vertex_cells.append([node])
            vertex_phys.append(gtag)
            bc_embed_info.append({"group": name,
                                  "requested": tuple(map(float, target)),
                                  "node": node, "snap_distance": dist,
                                  "embedded": False})
    if vertex_cells:
        cells["vertex"] = np.asarray(vertex_cells, dtype=np.int32)
        phys["vertex"] = np.asarray(vertex_phys, dtype=np.int32)

    mesh = Mesh(points=all_points, cells=cells, cell_physical=phys,
                field_data=field_data)
    mesh.bc_embed_info = bc_embed_info
    # lattice provenance: node ids form the full regular (2nx+1, 2ny+1)
    # half-step grid (nid = p * Py + q) — the 2D geometric-multigrid
    # preconditioner (femx_torch.solve.multigrid2d) keys off this
    mesh.lattice2d = {"n_cells": (nx, ny), "spacing": (float(h[0]), float(h[1])),
                      "origin": (ox, oy)}
    mesh.validate()
    return mesh
