"""Visualization (port of femx/viz.py): matplotlib figures of beam, solid,
plane, pipe and shaft results.

Reference parity:
- beam static plot: undeformed (black) vs deformed (blue dashed) wireframe
  with jet stress scatter (BeamSolver.py:585-602);
- beam modal plot: normalized mode shape (red dashed) + viridis magnitude
  scatter (BeamSolver.py:604-631);
- solid result view: deformed surface colored by |u| with fixed (blue) and
  loaded (red) node markers and reaction/force labels
  (ReactionSolver.py:234-294). The reference uses PyVista/VTK; femx, and
  this port, render the mesh surface triangles with matplotlib's 3D
  collection (same information, pure-python stack).

Every function takes show_window=False / a filename for headless use, which
is how femx_torch.report calls them. The analyses hold their results as
host numpy, so the figures read them as they are.

matplotlib (Agg backend) is imported by the first figure, not by importing
this module: `import femx_torch` and the CLI's solve path never load it,
and femx_torch.viz_html shares the two mesh helpers below on hosts that
have no matplotlib.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend (imported at first use)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# Beam plots
# ---------------------------------------------------------------------------
def beam_static_figure(analysis, results, scale_factor: float = 1.0):
    """Matplotlib Figure: undeformed vs deformed frame + stress scatter
    (reference: BeamSolver.py:585-602; warp scale default 1.0)."""
    plt = _pyplot()
    pts = analysis.points
    u = results.u
    x0, y0, z0 = pts[:, 0], pts[:, 1], pts[:, 2]
    dx, dy, dz = u[0::6], u[1::6], u[2::6]
    xd, yd, zd = x0 + scale_factor * dx, y0 + scale_factor * dy, z0 + scale_factor * dz

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_title(f"Static Analysis (Scale: {scale_factor})", fontsize=10)
    ax.set_xlabel("X", fontsize=8)
    ax.set_ylabel("Y", fontsize=8)
    ax.set_zlabel("Z", fontsize=8)
    for n1, n2 in analysis.conn:
        ax.plot([x0[n1], x0[n2]], [y0[n1], y0[n2]], [z0[n1], z0[n2]], "k-", lw=1, alpha=0.3)
        ax.plot([xd[n1], xd[n2]], [yd[n1], yd[n2]], [zd[n1], zd[n2]], "b--", lw=1.5)
    sc = ax.scatter(xd, yd, zd, c=results.smoothed_stresses, cmap="jet", s=35, edgecolor="k")
    cbar = fig.colorbar(sc, ax=ax, shrink=0.7, pad=0.1)
    cbar.set_label("Stress (Pa)", rotation=270, labelpad=15)
    fig.tight_layout()
    return fig


def beam_modal_figure(analysis, results, mode_num: int, scale_factor: float = 50.0):
    """Matplotlib Figure for one mode shape (reference: BeamSolver.py:604-631;
    modal warp scale default 50, shape normalized to unit max magnitude)."""
    plt = _pyplot()
    if results.mode_shapes.shape[1] < mode_num:
        return None
    vec = results.mode_shapes[:, mode_num - 1]
    freq_hz = results.natural_frequencies[mode_num - 1] / (2 * np.pi)
    pts = analysis.points
    x0, y0, z0 = pts[:, 0], pts[:, 1], pts[:, 2]
    dx, dy, dz = vec[0::6], vec[1::6], vec[2::6]
    mag = np.sqrt(dx**2 + dy**2 + dz**2)
    mmax = mag.max()
    if mmax > 0:
        dx, dy, dz = dx / mmax, dy / mmax, dz / mmax
    xd, yd, zd = x0 + scale_factor * dx, y0 + scale_factor * dy, z0 + scale_factor * dz

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_title(f"Mode #{mode_num} ({freq_hz:.2f} Hz)", fontsize=10)
    ax.set_xlabel("X", fontsize=8)
    ax.set_ylabel("Y", fontsize=8)
    ax.set_zlabel("Z", fontsize=8)
    for n1, n2 in analysis.conn:
        ax.plot([x0[n1], x0[n2]], [y0[n1], y0[n2]], [z0[n1], z0[n2]], "k-", lw=1, alpha=0.3)
        ax.plot([xd[n1], xd[n2]], [yd[n1], yd[n2]], [zd[n1], zd[n2]], "r--", lw=2)
    sc = ax.scatter(xd, yd, zd, c=mag, cmap="viridis", s=35, edgecolor="k")
    cbar = fig.colorbar(sc, ax=ax, shrink=0.7, pad=0.1)
    cbar.set_label("Relative Displacement")
    fig.tight_layout()
    return fig


def save_beam_static_plot(analysis, results, filename: str, scale_factor: float = 1.0):
    plt = _pyplot()
    fig = beam_static_figure(analysis, results, scale_factor)
    fig.savefig(filename, dpi=150)
    plt.close(fig)
    return filename


def save_beam_modal_plot(analysis, results, mode_num: int, filename: str, scale_factor: float = 50.0):
    plt = _pyplot()
    fig = beam_modal_figure(analysis, results, mode_num, scale_factor)
    if fig is not None:
        fig.savefig(filename, dpi=150)
        plt.close(fig)
    return filename


# ---------------------------------------------------------------------------
# Solid plot
# ---------------------------------------------------------------------------
def _surface_triangles(conn10: np.ndarray) -> np.ndarray:
    """Boundary corner-triangles of a Tetra10 mesh (faces appearing once)."""
    faces = np.concatenate(
        [
            conn10[:, [0, 2, 1]],
            conn10[:, [0, 1, 3]],
            conn10[:, [1, 2, 3]],
            conn10[:, [0, 3, 2]],
        ]
    )
    key = np.sort(faces, axis=1)
    _, idx, counts = np.unique(key, axis=0, return_index=True, return_counts=True)
    return faces[idx[counts == 1]]


def plot_solid_results(
    analysis,
    factor: float = 1.0,
    show_window: bool = False,
    filename: str = "fem_result.png",
    color: str = "disp",
):
    """Deformed-shape view with nodal-field coloring + fixed/loaded markers.

    Functional equivalent of ForceAnalysis.plot (ReactionSolver.py:234-294),
    rendered with matplotlib (VTK-free environment). Off-screen by default.

    color: "disp" colors by |u| (the reference's view); "von_mises" colors
    by the nodal-averaged von Mises stress (computed via
    analysis.compute_stresses() on demand — femx extension, the solid
    product should not report less than the beam one, BeamSolver.py:420-438).
    """
    if analysis.u is None:
        return None
    plt = _pyplot()
    pts = analysis.points
    disp = analysis.u.reshape(-1, 3)
    if not np.all(np.isfinite(disp)):
        disp = np.nan_to_num(disp)
    if color == "von_mises":
        vm = getattr(analysis, "nodal_von_mises", None)
        if vm is None:
            _, vm = analysis.compute_stresses()
        mag = np.nan_to_num(np.asarray(vm))
        field_label = "von Mises stress (Pa)"
        title = "Deformed Shape (von Mises)"
    else:
        mag = np.linalg.norm(disp, axis=1)
        field_label = "|u| (m)"
        title = "Deformed Shape (Magnitude)"
    warped = pts + factor * disp

    tris = _surface_triangles(analysis.tetra10_conn)
    fig = plt.figure(figsize=(10, 7.5))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_title(f"{title} | Warp Factor: {factor}x", fontsize=12)

    tri_pts = warped[tris]
    tri_mag = mag[tris].mean(axis=1)
    cmap = plt.get_cmap("jet")
    rng = tri_mag.max() - tri_mag.min()
    colors = cmap((tri_mag - tri_mag.min()) / (rng if rng > 0 else 1.0))
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    coll = Poly3DCollection(tri_pts, facecolors=colors, edgecolors="gray", linewidths=0.1, alpha=1.0)
    ax.add_collection3d(coll)

    lo, hi = warped.min(axis=0), warped.max(axis=0)
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    try:
        ax.set_box_aspect(hi - lo + 1e-12)
    except (AttributeError, ValueError):  # matplotlib < 3.3; a flat box
        pass

    diag = np.linalg.norm(hi - lo)
    off = 0.03 * diag if diag > 1e-6 else 0.03
    for i, info in enumerate(analysis.fixed_nodes_info):
        p = warped[info["node_idx"]]
        ax.scatter(*p, color="blue", s=60)
        if analysis.reaction_forces is not None:
            r = analysis.reaction_forces[3 * info["node_idx"] : 3 * info["node_idx"] + 3]
            ax.text(p[0], p[1] + off, p[2],
                    f"Fix {i + 1}\nRx:{np.nan_to_num(r[0]):.2e}\nRy:{np.nan_to_num(r[1]):.2e}\nRz:{np.nan_to_num(r[2]):.2e}",
                    fontsize=7)
    for i, info in enumerate(analysis.applied_forces_info):
        p = warped[info["node_idx"]]
        ax.scatter(*p, color="red", s=60)
        fv = info["force_vec"]
        ax.text(p[0], p[1] - off, p[2],
                f"Force {i + 1}\nFx:{fv[0]:.2e}\nFy:{fv[1]:.2e}\nFz:{fv[2]:.2e}", fontsize=7)

    m = plt.cm.ScalarMappable(cmap=cmap)
    m.set_array(mag)
    fig.colorbar(m, ax=ax, shrink=0.6, label=field_label)
    if show_window:
        plt.show()
    else:
        ax.view_init(elev=30, azim=45)  # isometric-ish view
        fig.savefig(filename, dpi=120)
        plt.close(fig)
    return filename


# ---------------------------------------------------------------------------
# 2D product plots (plane / pipe) + shaft mode shapes
# ---------------------------------------------------------------------------
def _tri6_subtriangles(conn6: np.ndarray) -> np.ndarray:
    """Split each Tri6 into its 4 corner/midside sub-triangles so a linear
    tricontour carries the quadratic field's midside values, (4E, 3)."""
    c = np.asarray(conn6)
    return np.concatenate([
        c[:, [0, 3, 5]], c[:, [3, 1, 4]], c[:, [5, 4, 2]], c[:, [3, 4, 5]],
    ])


def field_contour_figure(points2d, conn6, values, title="", xlabel="x (m)",
                         ylabel="y (m)", cbar_label="", warp=None,
                         warp_scale=1.0):
    """Filled-contour Figure of a nodal field on a Tri6 mesh.

    warp: optional (N, 2) nodal displacement to deform the geometry by
    (plotted positions = points2d + warp_scale * warp), with the undeformed
    boundary drawn as a light outline."""
    plt = _pyplot()
    import matplotlib.tri as mtri

    pts = np.asarray(points2d, dtype=np.float64)[:, :2]
    tris = _tri6_subtriangles(conn6)
    fig, ax = plt.subplots(figsize=(8, 5))
    shown = pts if warp is None else pts + warp_scale * np.asarray(warp)
    tr = mtri.Triangulation(shown[:, 0], shown[:, 1], tris)
    tc = ax.tricontourf(tr, np.asarray(values), levels=24, cmap="jet")
    if warp is not None:
        tr0 = mtri.Triangulation(pts[:, 0], pts[:, 1], tris)
        ax.triplot(tr0, color="k", lw=0.2, alpha=0.25)
    fig.colorbar(tc, ax=ax, label=cbar_label)
    ax.set_title(title, fontsize=10)
    ax.set_xlabel(xlabel, fontsize=8)
    ax.set_ylabel(ylabel, fontsize=8)
    ax.set_aspect("equal")
    fig.tight_layout()
    return fig


def plane_results_figure(analysis, field: str = "von_mises",
                         warp_scale=None):
    """Deformed-shape contour for PlaneAnalysis (field: 'von_mises',
    'disp', 'sxx', 'syy', 'sxy'). Warp auto-scales to ~5% of the plate
    diagonal unless given."""
    u = analysis.u.reshape(-1, 2)
    if field == "disp":
        vals = np.linalg.norm(u, axis=1)
        label, title = "|u| (m)", "Displacement magnitude"
    else:
        if getattr(analysis, "stress_nodes", None) is None:
            analysis.compute_stresses()
        idx = {"sxx": 0, "syy": 1, "sxy": 2}.get(field)
        if idx is None:
            vals = analysis.von_mises
            label, title = "von Mises (Pa)", "Von Mises stress"
        else:
            vals = analysis.stress_nodes[:, idx]
            label = f"sigma_{field[1:]} (Pa)"
            title = f"Stress {field}"
    if warp_scale is None:
        diag = float(np.linalg.norm(analysis.points[:, :2].max(0)
                                    - analysis.points[:, :2].min(0)))
        umax = float(np.abs(u).max())
        warp_scale = 0.05 * diag / umax if umax > 0 else 1.0
    return field_contour_figure(
        analysis.points, analysis.conn, vals,
        title=f"2D Static Analysis — {title} (warp x{warp_scale:.3g})",
        cbar_label=label, warp=u, warp_scale=warp_scale)


def save_plane_results_plot(analysis, filename: str,
                            field: str = "von_mises", warp_scale=None):
    plt = _pyplot()
    fig = plane_results_figure(analysis, field=field, warp_scale=warp_scale)
    fig.savefig(filename, dpi=120)
    plt.close(fig)
    return filename


def pipe_results_figure(analysis):
    """Two panels: von Mises contour on the (r, z) wall section + the
    mid-height radial profiles of all four stress components."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(
        1, 2, figsize=(11, 5), gridspec_kw={"width_ratios": [1, 1.4]})
    import matplotlib.tri as mtri

    pts = analysis.points[:, :2]
    tr = mtri.Triangulation(pts[:, 0], pts[:, 1],
                            _tri6_subtriangles(analysis.conn))
    tc = ax1.tricontourf(tr, analysis.von_mises / 1e6, levels=24, cmap="jet")
    fig.colorbar(tc, ax=ax1, label="von Mises (MPa)")
    ax1.set_xlabel("r (m)", fontsize=8)
    ax1.set_ylabel("z (m)", fontsize=8)
    ax1.set_title("Wall section (axisymmetric)", fontsize=10)

    names = ["sigma_rr", "sigma_zz", "sigma_theta", "sigma_rz"]
    for k, name in enumerate(names):
        radii, vals = analysis.radial_profile(analysis.stress_nodes[:, k])
        ax2.plot(radii, vals / 1e6, marker=".", ms=3, label=name)
    ax2.axhline(0.0, color="k", lw=0.5)
    ax2.set_xlabel("r (m)", fontsize=8)
    ax2.set_ylabel("stress (MPa)", fontsize=8)
    ax2.set_title("Mid-height radial stress profiles", fontsize=10)
    ax2.legend(fontsize=8)
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    return fig


def save_pipe_results_plot(analysis, filename: str):
    plt = _pyplot()
    fig = pipe_results_figure(analysis)
    fig.savefig(filename, dpi=120)
    plt.close(fig)
    return filename


def shaft_mode_figure(shaft, mode_num: int = 1):
    """Lateral mode shape of a ShaftModalAnalysis along the shaft axis
    (normalized u_y/u_z deflections) with bearing markers."""
    plt = _pyplot()
    if not shaft.modes:
        raise RuntimeError("Run the shaft analysis first.")
    m = shaft.modes[mode_num - 1]
    x = shaft.mesh.points[:, 0]
    order = np.argsort(x)
    s = m.shape.reshape(-1, 6)
    peak = np.abs(s[:, 1:3]).max()
    s = s / peak if peak > 0 else s
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(x[order], s[order, 1], "b.-", ms=4, lw=1.2, label="u_y")
    ax.plot(x[order], s[order, 2], "g.-", ms=4, lw=1.2, label="u_z")
    ax.axhline(0.0, color="k", lw=0.6)
    for b in shaft.bearings:
        ax.axvline(b, color="r", ls=":", lw=1.0)
        ax.plot([b], [0.0], "r^", ms=9, clip_on=False)
    rpm = (f", critical speed {m.critical_speed_rpm:.0f} RPM"
           if m.critical_speed_rpm is not None else "")
    ax.set_title(f"Shaft mode {mode_num}: {m.frequency_hz:.2f} Hz "
                 f"[{m.family}]{rpm}", fontsize=10)
    ax.set_xlabel("x (m)", fontsize=8)
    ax.set_ylabel("normalized deflection", fontsize=8)
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    return fig


def save_shaft_mode_plot(shaft, mode_num: int, filename: str):
    plt = _pyplot()
    fig = shaft_mode_figure(shaft, mode_num)
    fig.savefig(filename, dpi=120)
    plt.close(fig)
    return filename
