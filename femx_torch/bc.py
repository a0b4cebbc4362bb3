"""Solid boundary conditions: point fixes and point loads (host numpy).

The solid half of femx/bc.py. Reference semantics (SURVEY.md §6 quirk 5):
fix dicts use 0 = fixed / None = free per axis (FEM_main.py:236-238,
ReactionSolver.py:168-170), and BC points snap to the nearest node within
their physical group (ReactionSolver.py:164-166,180-182).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from femx_torch.mesh.core import Mesh, nearest_node


@dataclasses.dataclass
class ConstraintSet:
    """Fixed-DOF bookkeeping for one analysis."""

    ndof: int
    fixed_dofs: np.ndarray  # sorted unique int array
    fixed_nodes_info: List[dict] = dataclasses.field(default_factory=list)

    @property
    def free_dofs(self) -> np.ndarray:
        return np.setdiff1d(np.arange(self.ndof), self.fixed_dofs)

    def free_mask(self, dtype=np.float64) -> np.ndarray:
        m = np.ones(self.ndof, dtype=dtype)
        m[self.fixed_dofs] = 0.0
        return m


def solid_point_constraints(
    mesh: Mesh, fix_data: Sequence[dict], diri_nodes: np.ndarray
) -> ConstraintSet:
    """Point fixes for the 3-DOF/node solid problem. Each fix dict:
    {'pos_x','pos_y','pos_z', 'fix_x','fix_y','fix_z'} with 0 meaning fixed
    and None meaning free."""
    fixed: List[int] = []
    info: List[dict] = []
    for fix in fix_data:
        pos = (fix["pos_x"], fix["pos_y"], fix["pos_z"])
        node = nearest_node(mesh.points, pos, diri_nodes)
        dofs = [3 * node + i for i, key in enumerate(("fix_x", "fix_y", "fix_z"))
                if fix.get(key) == 0]
        fixed.extend(dofs)
        info.append({"node_idx": node, "pos": mesh.points[node], "dofs": dofs})
    return ConstraintSet(ndof=3 * mesh.num_nodes,
                         fixed_dofs=np.unique(fixed).astype(np.int64),
                         fixed_nodes_info=info)


def solid_point_loads(
    mesh: Mesh, force_data: Sequence[dict], neumann_nodes: np.ndarray
) -> Tuple[np.ndarray, List[dict]]:
    """Point loads -> global force vector (3 DOF/node) + applied-force info."""
    f = np.zeros(3 * mesh.num_nodes)
    applied: List[dict] = []
    for item in force_data:
        vec = np.array([item["force_x"], item["force_y"], item["force_z"]], dtype=np.float64)
        pos = (item["force_x_pstn"], item["force_y_pstn"], item["force_z_pstn"])
        node = nearest_node(mesh.points, pos, neumann_nodes)
        f[3 * node:3 * node + 3] += vec
        applied.append({"node_idx": node, "pos": mesh.points[node], "force_vec": vec})
    return f, applied
