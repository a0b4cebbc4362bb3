"""3D extruded-section preview (port of femx/viz_sections.py; component #18
of the reference inventory).

The reference sweeps each member's 2D section triangulation along the line
element into VTK wedge cells and renders with PyVista
(BeamSolver.py:300-343 `mesh_update`). femx, and this port, render the same
extrusion with matplotlib Poly3D collections: the section outline
(femx_torch.sections.geometry.build_geometry) is rotated 90 degrees when the
assignment says so (the vertex swap of BeamSolver.py:321-324), swept along
each member with the direction-cosine transform the solver uses, and drawn
as side-wall quads per boundary edge. matplotlib is imported at the first
figure (femx_torch.viz._pyplot).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from femx_torch.mesh.core import Mesh
from femx_torch.sections.geometry import build_geometry
from femx_torch.viz import _pyplot


def _section_outline(section_type: str, params: dict, rotate: bool) -> List[np.ndarray]:
    geom = build_geometry(section_type, {k: v for k, v in params.items() if k != "rotate"})
    loops = [geom.outer] + list(geom.holes)
    if rotate:
        loops = [np.stack([-lp[:, 1], lp[:, 0]], axis=1) for lp in loops]
    return loops


def _lambda_matrix(p1: np.ndarray, p2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    d = p2 - p1
    L = np.linalg.norm(d)
    Cxx, Cyx, Czx = d / L
    if Cxx**2 + Cyx**2 < eps**2:
        s = 1.0 if Czx > 0 else -1.0
        return np.array([[0.0, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, 0.0]])
    D = np.sqrt(Cxx**2 + Cyx**2)
    return np.array(
        [[Cxx, Cyx, Czx], [-Cyx / D, Cxx / D, 0.0], [-Cxx * Czx / D, -Cyx * Czx / D, D]]
    )


def plot_extruded_sections(
    mesh: Mesh,
    section_data: Sequence[dict],
    filename: str = "section_preview.png",
    show_window: bool = False,
):
    """Render every member with its assigned section swept along its axis."""
    conn = mesh.cells.get("line")
    if conn is None:
        raise ValueError("Mesh has no line elements")
    tags = mesh.cell_physical.get("line")
    gid_to_name = {v[0]: k for k, v in mesh.field_data.items()}
    outlines = {
        sec["group"]: _section_outline(sec["type"], sec["params"], sec.get("rotate", False))
        for sec in section_data
    }

    plt = _pyplot()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    all_pts = []
    for i, (n1, n2) in enumerate(conn):
        group = gid_to_name.get(int(tags[i])) if tags is not None else None
        if group not in outlines:
            continue
        p1, p2 = mesh.points[n1], mesh.points[n2]
        if np.linalg.norm(p2 - p1) == 0:
            continue
        lam = _lambda_matrix(p1, p2)
        for loop in outlines[group]:
            # local section plane spans the member's local (y, z) axes
            local = np.zeros((len(loop), 3))
            local[:, 1] = loop[:, 0]
            local[:, 2] = loop[:, 1]
            world = local @ lam  # rows: lam.T @ local_i
            start = p1[None, :] + world
            end = p2[None, :] + world
            quads = [
                [start[j], start[(j + 1) % len(loop)], end[(j + 1) % len(loop)], end[j]]
                for j in range(len(loop))
            ]
            coll = Poly3DCollection(quads, facecolors="#9fb8d8", edgecolors="k",
                                    linewidths=0.2, alpha=0.95)
            ax.add_collection3d(coll)
            all_pts.append(start)
            all_pts.append(end)
        ax.plot([p1[0], p2[0]], [p1[1], p2[1]], [p1[2], p2[2]], "r-", lw=0.8)

    if all_pts:
        pts = np.concatenate(all_pts)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        try:
            ax.set_box_aspect(hi - lo + 1e-9)
        except (AttributeError, ValueError):  # matplotlib < 3.3; a flat frame
            pass
    ax.set_title("Section preview (extruded members)")
    if show_window:
        plt.show()
    else:
        fig.savefig(filename, dpi=120)
        plt.close(fig)
    return filename
