"""Locality-preserving node/element reordering for unstructured meshes
(port of femx/mesh/reorder.py; host numpy).

Morton-order element centroids, then relabel nodes by first touch along
that element order. The group-ELL operator orders its nodes by
`morton_codes` (femx_torch.assembly_groupell).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def morton_codes(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Morton (Z-order) codes of 3D points, `bits` bits per axis."""
    pts = np.asarray(points, dtype=np.float64)
    lo = pts.min(axis=0)
    span = pts.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    q = np.minimum(((pts - lo) / span * (2**bits - 1)).astype(np.uint64), 2**bits - 1)
    code = np.zeros(len(pts), dtype=np.uint64)
    for b in range(bits):
        for axis in range(3):
            code |= ((q[:, axis] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + axis)
    return code


def element_morton_order(points: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """Element permutation ordering elements by centroid Morton code."""
    centroids = np.asarray(points)[np.asarray(conn)].mean(axis=1)
    return np.argsort(morton_codes(centroids), kind="stable")


def first_touch_relabel(conn: np.ndarray, n_nodes: int,
                        elem_order: np.ndarray | None = None) -> np.ndarray:
    """new_of_old[node] — node relabeling by first appearance when walking
    elements in `elem_order`. Nodes never referenced keep a stable tail
    numbering."""
    conn = np.asarray(conn)
    order = np.arange(len(conn)) if elem_order is None else np.asarray(elem_order)
    stream = conn[order].reshape(-1)
    uniq, first_pos = np.unique(stream, return_index=True)
    rank = np.argsort(first_pos, kind="stable")
    new_of_old = np.full(n_nodes, -1, dtype=np.int64)
    new_of_old[uniq[rank]] = np.arange(len(uniq))
    untouched = np.where(new_of_old < 0)[0]
    new_of_old[untouched] = len(uniq) + np.arange(len(untouched))
    return new_of_old


def reorder_for_locality(points: np.ndarray, conn: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Morton element order + first-touch node relabeling.

    Returns (points_new, conn_new, new_of_old_nodes, elem_order) where
    points_new[new_of_old[i]] == points[i] and conn_new is in the new node
    ids AND the Morton element order.
    """
    points = np.asarray(points)
    conn = np.asarray(conn)
    eorder = element_morton_order(points, conn)
    new_of_old = first_touch_relabel(conn, len(points), eorder)
    points_new = np.empty_like(points)
    points_new[new_of_old] = points
    conn_new = new_of_old[conn[eorder]]
    return points_new, conn_new, new_of_old, eorder


def element_node_spans(conn: np.ndarray) -> np.ndarray:
    """Per-element span of node ids (max - min) — the window-size driver
    for tiled formulations; also a bandwidth proxy."""
    conn = np.asarray(conn)
    return conn.max(axis=1) - conn.min(axis=1)
