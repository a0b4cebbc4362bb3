"""Mesh data model and physical-group indexing (host numpy).

Copy of femx.mesh.core for the port: the same information content as a
parsed Gmsh file (points, typed cell blocks, physical tags) and the
group->node indexing semantics of the reference app (ReactionSolver.py:75-85,
BeamSolver.py:677-686).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# Gmsh element-type code -> (canonical name, nodes per element).
GMSH_TYPE_TO_NAME: Dict[int, Tuple[str, int]] = {
    15: ("vertex", 1),
    1: ("line", 2),
    8: ("line3", 3),
    2: ("triangle", 3),
    9: ("triangle6", 6),
    3: ("quad", 4),
    4: ("tetra", 4),
    11: ("tetra10", 10),
    5: ("hexahedron", 8),
    6: ("wedge", 6),
}
NODES_PER_CELL: Dict[str, int] = {v[0]: v[1] for v in GMSH_TYPE_TO_NAME.values()}


@dataclasses.dataclass
class Mesh:
    """An unstructured mesh with physical groups.

    Attributes:
      points: (N, 3) float64 node coordinates.
      cells: cell-type name -> (E, nodes_per_cell) int32 connectivity (0-based).
      cell_physical: cell-type name -> (E,) int32 physical tag per cell.
      field_data: physical-group name -> (tag, dim), meshio's ``field_data``
        contract used by the reference (ReactionSolver.py:79).
      structured: optional lattice metadata (StructuredBoxInfo) set by the
        box generators; enables the gather-free stiffness operator.
    """

    points: np.ndarray
    cells: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    cell_physical: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    field_data: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    structured: object = None

    @property
    def num_nodes(self) -> int:
        return len(self.points)

    def validate(self) -> None:
        if self.points.ndim != 2 or self.points.shape[1] != 3:
            raise ValueError(f"points must be (N, 3), got {self.points.shape}")
        for name, conn in self.cells.items():
            npc = NODES_PER_CELL[name]
            if conn.ndim != 2 or conn.shape[1] != npc:
                raise ValueError(f"{name} connectivity has shape {conn.shape}")
            if conn.size and (conn.min() < 0 or conn.max() >= self.num_nodes):
                raise ValueError(f"{name} connectivity indexes outside the points")
            if name in self.cell_physical and len(self.cell_physical[name]) != len(conn):
                raise ValueError(f"{name} physical tags do not match its cells")


def nodes_in_physical_group(
    mesh: Mesh, group_name: str, cell_type: Optional[str] = None
) -> np.ndarray:
    """All node indices belonging to cells tagged with a physical group.

    Reference semantics (ReactionSolver.py:75-85): a missing group or cell
    type returns an empty array rather than raising."""
    if group_name not in mesh.field_data:
        return np.array([], dtype=np.int32)
    tag = mesh.field_data[group_name][0]
    types = [cell_type] if cell_type is not None else list(mesh.cells)
    found = []
    for ct in types:
        conn = mesh.cells.get(ct)
        phys = mesh.cell_physical.get(ct)
        if conn is None or phys is None or not len(conn):
            continue
        sel = conn[phys == tag]
        if sel.size:
            found.append(sel.ravel())
    if not found:
        return np.array([], dtype=np.int32)
    return np.unique(np.concatenate(found)).astype(np.int32)


def nearest_node(points: np.ndarray, pos, candidates: Optional[np.ndarray] = None) -> int:
    """Index of the node nearest to ``pos``, optionally restricted to a
    candidate set (the reference's point-BC snapping,
    ReactionSolver.py:164-166,180-182)."""
    pos = np.asarray(pos, dtype=np.float64)
    if candidates is not None and len(candidates):
        d = np.linalg.norm(points[candidates] - pos, axis=1)
        return int(candidates[int(np.argmin(d))])
    d = np.linalg.norm(points - pos, axis=1)
    return int(np.argmin(d))
