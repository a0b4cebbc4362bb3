"""Boundary conditions: point fixes and loads, beam group BCs (host numpy).

Port of femx/bc.py. Reference semantics (SURVEY.md §6 quirk 5): solid fix
dicts use 0 = fixed / None = free per axis (FEM_main.py:236-238,
ReactionSolver.py:168-170), and BC points snap to the nearest node within
their physical group (ReactionSolver.py:164-166,180-182); beam BCs resolve
through 0-D 'vertex' physical groups (BeamSolver.py:677-686), beam forces
are translational only (BeamSolver.py:406-407), and a DistributedForce on a
line group adds consistent fixed-end loads (a femx extension).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Sequence, Tuple

import numpy as np

from femx_torch.mesh.core import Mesh, nearest_node, nodes_in_physical_group


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


_BEAM_FIX_KEYS = ("fix_x", "fix_y", "fix_z", "fix_rx", "fix_ry", "fix_rz")


def _iter_member_fixed_ends(mesh: Mesh, group: str, w_global):
    """Yield (elem_index, lam, fe_local) for every 'line' element of `group`
    under a uniform line load w (N/m, global axes).

    fe_local is the consistent fixed-end equivalent load vector in member
    axes (wL/2 shears with +-wL^2/12 end moments in each bending plane, wL/2
    axial). Warns when the group resolves to no line elements, as femx
    does. The direction cosines are femx_torch.elements.beam's, on the CPU.
    """
    conn = mesh.cells.get("line")
    tags = mesh.cell_physical.get("line")
    if conn is None or tags is None or group not in mesh.field_data:
        warnings.warn(
            f"DistributedForce group '{group}' resolves to no line elements "
            "(missing group or mesh has no tagged 'line' cells); no load applied.",
            stacklevel=3,
        )
        return
    gid = mesh.field_data[group][0]
    elems = np.where(tags == gid)[0]
    if len(elems) == 0:
        warnings.warn(
            f"DistributedForce group '{group}' contains no line elements; "
            "no load applied.",
            stacklevel=3,
        )
        return
    w = np.asarray(w_global, dtype=np.float64)

    import torch

    from femx_torch.elements.beam import direction_cosine_matrix

    p1 = mesh.points[conn[elems, 0]]
    p2 = mesh.points[conn[elems, 1]]
    lams = direction_cosine_matrix(torch.as_tensor(p1), torch.as_tensor(p2)).numpy()
    lengths = np.linalg.norm(p2 - p1, axis=1)
    for e, L, lam in zip(elems, lengths, lams):
        L = float(L)
        if L == 0:
            continue
        wl = lam @ w  # local (axial, y, z) load intensities
        fe = np.zeros(12)
        fe[0] = fe[6] = wl[0] * L / 2.0  # axial
        fe[1] = fe[7] = wl[1] * L / 2.0  # local-y shear
        fe[5], fe[11] = wl[1] * L**2 / 12.0, -wl[1] * L**2 / 12.0  # theta-z moments
        fe[2] = fe[8] = wl[2] * L / 2.0  # local-z shear
        fe[4], fe[10] = -wl[2] * L**2 / 12.0, wl[2] * L**2 / 12.0  # theta-y (xz sign conv.)
        yield int(e), lam, fe


def _distributed_member_loads(mesh: Mesh, group: str, w_global) -> np.ndarray:
    """Consistent nodal loads (6 DOF/node) for a uniform line load w (N/m,
    global) on every 'line' element of a physical group: per element the
    load is rotated to member axes, the fixed-end load vector built and
    rotated back."""
    conn = mesh.cells.get("line")
    f = np.zeros(6 * mesh.num_nodes)
    for e, lam, fe in _iter_member_fixed_ends(mesh, group, w_global):
        n1, n2 = conn[e]
        R = np.kron(np.eye(4), lam)
        fg = R.T @ fe
        f[6 * n1:6 * n1 + 6] += fg[:6]
        f[6 * n2:6 * n2 + 6] += fg[6:]
    return f


def distributed_fixed_end_local(mesh: Mesh, bc_data: Sequence[dict]):
    """(n_line_elements, 12) local fixed-end load vectors summed over every
    DistributedForce entry of bc_data, or None when it has none. Stress
    recovery subtracts them from k_local @ (R @ u_e), so end moments on
    loaded members include the w L^2/12 term of each element."""
    dist = [bc for bc in bc_data if bc.get("type") == "DistributedForce"]
    if not dist or "line" not in mesh.cells:
        return None
    fe_all = np.zeros((len(mesh.cells["line"]), 12))
    with warnings.catch_warnings():
        # missing-group warnings already fired when the loads were assembled
        warnings.simplefilter("ignore")
        for bc in dist:
            w = (bc.get("wx", 0.0), bc.get("wy", 0.0), bc.get("wz", 0.0))
            for e, _lam, fe in _iter_member_fixed_ends(mesh, bc["group"], w):
                fe_all[e] += fe
    return fe_all


def beam_group_constraints_and_loads(
    mesh: Mesh, bc_data: Sequence[dict]
) -> Tuple[ConstraintSet, np.ndarray]:
    """Beam BCs by physical group (6 DOF/node). bc dicts:
      {'group', 'type': 'Fix', 'fix_x'..'fix_rz': bool}           (vertex group)
      {'group', 'type': 'Force', 'force_x','force_y','force_z'}   (vertex group;
        translational only, BeamSolver.py:395-407)
      {'group', 'type': 'DistributedForce', 'wx','wy','wz'}       (line group,
        N/m in global axes; consistent fixed-end loads)
    """
    ndof = 6 * mesh.num_nodes
    f = np.zeros(ndof)
    fixed: List[int] = []
    info: List[dict] = []
    for bc in bc_data:
        if bc["type"] == "DistributedForce":
            f += _distributed_member_loads(
                mesh, bc["group"],
                (bc.get("wx", 0.0), bc.get("wy", 0.0), bc.get("wz", 0.0)),
            )
            continue
        nodes = nodes_in_physical_group(mesh, bc["group"], "vertex")
        for n in nodes:
            if bc["type"] == "Fix":
                dofs = [6 * n + i for i, k in enumerate(_BEAM_FIX_KEYS) if bc.get(k)]
                fixed.extend(dofs)
                info.append({"node_idx": int(n), "pos": mesh.points[n], "dofs": dofs})
            elif bc["type"] == "Force":
                f[6 * n + 0] += bc.get("force_x", 0.0)
                f[6 * n + 1] += bc.get("force_y", 0.0)
                f[6 * n + 2] += bc.get("force_z", 0.0)
    cs = ConstraintSet(ndof=ndof, fixed_dofs=np.unique(fixed).astype(np.int64),
                       fixed_nodes_info=info)
    return cs, f
