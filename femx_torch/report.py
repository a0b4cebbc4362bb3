"""Analysis reports (port of femx/report.py): Markdown natively, and a
real .docx always.

The reference emits two Word reports: `ReportGenerator.create_report` for
the solid pipeline (ReactionSolver.py:309-431: results image, E/nu, mesh
stats, BC list, Jacobian quality check, reaction table with total) and
`BeamAnalysisWindow.create_report` for the beam pipeline
(BeamSolver.py:483-560: mesh stats, material, BC table, static plot,
per-node displacement/stress table, modal table first 10, first-5 mode
plots). femx reproduces both layouts and adds the plane, pipe and shaft
reports; this module writes the same text from the port's analyses.
Markdown (with embedded PNG references) is the native format; `.docx`
output uses python-docx when importable and otherwise the port's copy of
femx's minimal OOXML writer (femx_torch.docx_writer).

The analyses keep their results as host numpy; what is still a tensor (a
ModalResult's omega) is brought to the host once, at the top of the
section that prints it. Images come from femx_torch.viz (matplotlib); when
it cannot draw them, the report says so in a note and carries on, as
femx's does.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import List, Optional

import numpy as np
import torch

try:
    import docx  # noqa: F401

    DOCX_AVAILABLE = True
except ImportError:
    DOCX_AVAILABLE = False


def _host(x) -> np.ndarray:
    """A host numpy copy of a tensor (any device), or x as an array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _fmt(v: float) -> str:
    return f"{v:.4e}"


def solid_report(analysis, filename: str = "FEM_Report.md", image: bool = True) -> str:
    """Solid reaction-analysis report (layout of ReactionSolver.py:315-431)."""
    lines: List[str] = []
    lines.append("# Finite Element Analysis Report\n")

    if image:
        img_path = os.path.splitext(filename)[0] + "_iso_view.png"
        try:
            from femx_torch.viz import plot_solid_results

            plot_solid_results(analysis, factor=1.0, show_window=False, filename=img_path)
            lines.append("## Results Overview (Isometric View)\n")
            lines.append("Deformed shape with displacement magnitude.\n")
            lines.append(f"![results]({os.path.basename(img_path)})\n")
        except Exception as e:  # viz failure must not kill the report
            lines.append(f"_Could not generate result image: {e}_\n")

    lines.append("## Analysis Parameters\n")
    lines.append(f"- **Young's Modulus (E):** {analysis.E:.2e} Pa")
    lines.append(f"- **Poisson's Ratio (v):** {analysis.v}\n")

    lines.append("## Mesh Information\n")
    lines.append(f"- **Total Nodes:** {analysis.num_nodes}")
    lines.append("- **Element Type:** 10-Node Quadratic Tetrahedron (Tetra10)")
    lines.append(f"- **Total Elements:** {len(analysis.tetra10_conn)}\n")

    lines.append("## Boundary Conditions\n")
    lines.append("### Applied Loads\n")
    if not analysis.force_data:
        lines.append("- No loads applied.")
    for i, fi in enumerate(analysis.force_data):
        vec = (fi["force_x"], fi["force_y"], fi["force_z"])
        pos = (fi["force_x_pstn"], fi["force_y_pstn"], fi["force_z_pstn"])
        lines.append(f"- **Load {i + 1}:** Force (Fx, Fy, Fz) = {vec} N @ point {pos} m")
    lines.append("\n### Fixed Supports (Constraints)\n")
    for i, fx in enumerate(analysis.fix_data):
        pos = (fx["pos_x"], fx["pos_y"], fx["pos_z"])
        dofs = [d for d, c in zip("XYZ", (fx.get("fix_x"), fx.get("fix_y"), fx.get("fix_z"))) if c == 0]
        lines.append(f"- Fix Point {i + 1} at {pos}: Constrained DOFs [{', '.join(dofs)}]")

    lines.append("\n## Mesh Quality Check\n")
    count = analysis.negative_detJ_count
    if count > 0:
        lines.append(
            f"- **Warning:** {count} integration points with non-positive Jacobian "
            "determinant (detJ <= 0) — distorted elements may reduce accuracy."
        )
    else:
        lines.append("- All elements passed the Jacobian determinant check (all detJ > 0).")

    lines.append("\n## Reaction Force Results\n")
    if analysis.reaction_forces is None:
        lines.append("Reaction forces were not calculated.")
    else:
        lines.append("| Fix Point | Node ID | Rx (N) | Ry (N) | Rz (N) |")
        lines.append("|---|---|---|---|---|")
        total = np.zeros(3)
        for i, info in enumerate(analysis.fixed_nodes_info):
            n = info["node_idx"]
            r = analysis.reaction_forces[3 * n : 3 * n + 3]
            total += r
            lines.append(f"| {i + 1} | {n} | {_fmt(r[0])} | {_fmt(r[1])} | {_fmt(r[2])} |")
        lines.append(f"| **Total Reaction** | | {_fmt(total[0])} | {_fmt(total[1])} | {_fmt(total[2])} |")
        lines.append(
            "\nNote: for static equilibrium the Total Reaction equals the "
            "negative of the summed applied forces."
        )
    vm = getattr(analysis, "nodal_von_mises", None)
    if vm is not None:
        # femx extension: the reference's solid report stops at reactions;
        # its BEAM product does report stresses (BeamSolver.py:420-438), so
        # the solid product should not be weaker. Nodal-averaged von Mises
        # summary + the highest-stressed nodes.
        vm = _host(vm)
        lines.append("\n## Stress Results (von Mises, nodal-averaged)\n")
        imax = int(np.argmax(vm))
        p = analysis.points[imax]
        lines.append(f"- **Max von Mises stress:** {vm.max() / 1e6:.4f} MPa "
                     f"at node {imax} ({p[0]:.4g}, {p[1]:.4g}, {p[2]:.4g})")
        lines.append(f"- **Mean von Mises stress:** {vm.mean() / 1e6:.4f} MPa\n")
        lines.append("| Rank | Node ID | von Mises (MPa) |")
        lines.append("|---|---|---|")
        for rank, n in enumerate(np.argsort(vm)[::-1][:5]):
            lines.append(f"| {rank + 1} | {int(n)} | {vm[n] / 1e6:.4f} |")
    modal = getattr(analysis, "modal_result", None)
    if modal is not None:
        # femx extension: the reference's solid product has no modal output
        # (modal is beam-only, BeamSolver.py:440-455); table format mirrors
        # the beam report's modal section.
        lines.append("\n## Modal Analysis Results\n")
        lines.append("| Mode | Frequency (rad/s) | Frequency (Hz) |")
        lines.append("|---|---|---|")
        om = _host(modal.omega)
        for i, w in enumerate(om):
            lines.append(f"| {i + 1} | {w:.4f} | {w / (2 * np.pi):.4f} |")

    if getattr(analysis, "solve_info", None):
        lines.append("\n## Solver\n")
        for k, v in analysis.solve_info.items():
            lines.append(f"- **{k}:** {v}")
        for k, v in getattr(analysis, "stage_times", {}).items():
            lines.append(f"- **t_{k}:** {v:.3f} s")

    text = "\n".join(lines) + "\n"
    if filename.endswith(".docx"):
        _markdown_ish_to_docx(text, filename)
    else:
        with open(filename, "w") as f:
            f.write(text)
    return filename


def beam_report(
    analysis,
    results,
    filename: str = "beam_analysis_report.md",
    max_table_nodes: Optional[int] = None,
    plots: bool = True,
) -> str:
    """Beam analysis report (layout of BeamSolver.py:496-560)."""
    mesh = analysis.mesh
    lines: List[str] = []
    lines.append("# 3D Beam Analysis Report\n")
    lines.append(f"_Report generated on: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}_\n")

    lines.append("## 1. Model Information\n")
    lines.append("**Mesh Details**\n")
    lines.append(f"- Number of Nodes: {len(analysis.points)}")
    lines.append(f"- Number of Elements: {len(analysis.conn)}\n")
    lines.append("**Material Properties**\n")
    lines.append(f"- Young's Modulus (E): {analysis.E:,.2e} Pa")
    lines.append(f"- Poisson's Ratio (nu): {analysis.nu}")
    lines.append(f"- Density (rho): {analysis.rho} kg/m^3\n")

    lines.append("**Boundary Conditions & Loads**\n")
    lines.append("| Group | Type | Details |")
    lines.append("|---|---|---|")
    for item in analysis.bc_data:
        if item["type"] == "Fix":
            fixes = [f for f in ["X", "Y", "Z", "RX", "RY", "RZ"] if item.get(f"fix_{f.lower()}")]
            det = f"Fixed DOFs: {', '.join(fixes) or 'None'}"
        elif item["type"] == "DistributedForce":
            det = (f"w=({item.get('wx', 0)}, {item.get('wy', 0)}, "
                   f"{item.get('wz', 0)}) N/m")
        else:
            det = f"Fx={item.get('force_x', 0)}, Fy={item.get('force_y', 0)}, Fz={item.get('force_z', 0)}"
        lines.append(f"| {item['group']} | {item['type']} | {det} |")

    lines.append("\n**Sections**\n")
    for sec in analysis.section_data:
        ps = ", ".join(f"{k}={v}" for k, v in sec["params"].items())
        rot = ", rotated" if sec.get("rotate") else ""
        lines.append(f"- {sec['group']}: {sec['type']}{rot}, {ps}")

    lines.append("\n## 2. Static Analysis Results\n")
    base = os.path.splitext(filename)[0]
    if plots:
        try:
            from femx_torch.viz import save_beam_static_plot

            img = base + "_static.png"
            save_beam_static_plot(analysis, results, img)
            lines.append("Deformation and Stress Contour Plot:\n")
            lines.append(f"![static]({os.path.basename(img)})\n")
        except Exception as e:
            lines.append(f"_Plot unavailable: {e}_\n")

    lines.append("Nodal displacement and stress results:\n")
    lines.append("| Node ID | X (m) | Y (m) | Z (m) | Disp X (m) | Disp Y (m) | Disp Z (m) | Stress (MPa) |")
    lines.append("|---|---|---|---|---|---|---|---|")
    u = results.u
    n_rows = len(analysis.points) if max_table_nodes is None else min(max_table_nodes, len(analysis.points))
    for i in range(n_rows):
        p = analysis.points[i]
        lines.append(
            f"| {i} | {p[0]:.4f} | {p[1]:.4f} | {p[2]:.4f} | "
            f"{u[6 * i]:.4e} | {u[6 * i + 1]:.4e} | {u[6 * i + 2]:.4e} | "
            f"{results.smoothed_stresses[i] / 1e6:.4f} |"
        )

    lines.append("\n## 3. Modal Analysis Results\n")
    lines.append("| Mode | Frequency (rad/s) | Frequency (Hz) |")
    lines.append("|---|---|---|")
    for i, w in enumerate(results.natural_frequencies[:10]):
        lines.append(f"| {i + 1} | {w:.4f} | {w / (2 * np.pi):.4f} |")

    if plots:
        try:
            from femx_torch.viz import save_beam_modal_plot

            lines.append("\nMode Shape Plots:\n")
            for m in range(1, min(5, results.mode_shapes.shape[1]) + 1):
                img = f"{base}_mode{m}.png"
                save_beam_modal_plot(analysis, results, m, img)
                lines.append(f"![mode{m}]({os.path.basename(img)})")
        except Exception as e:
            lines.append(f"_Mode plots unavailable: {e}_")

    text = "\n".join(lines) + "\n"
    if filename.endswith(".docx"):
        _markdown_ish_to_docx(text, filename)
    else:
        with open(filename, "w") as f:
            f.write(text)
    return filename


def _markdown_ish_to_docx(text: str, filename: str) -> None:
    """Minimal Markdown -> docx renderer (headings, bullets, tables, images).

    Uses python-docx when installed; otherwise the port's OOXML writer
    (femx_torch.docx_writer), which implements the same API subset — a real .docx
    is produced either way (the reference's report artifacts are .docx,
    ReactionSolver.py:309-431)."""
    if DOCX_AVAILABLE:
        from docx import Document
        from docx.shared import Inches
    else:
        from femx_torch.docx_writer import Document, Inches

    doc = Document()
    table_buf: List[List[str]] = []

    def flush_table():
        nonlocal table_buf
        if not table_buf:
            return
        rows = [r for r in table_buf if not set("".join(r)) <= {"-", " ", ":"}]
        t = doc.add_table(rows=0, cols=len(rows[0]))
        t.style = "Table Grid"
        for r in rows:
            cells = t.add_row().cells
            for c, v in zip(cells, r):
                c.text = v.strip().strip("*")
        table_buf = []

    for line in text.splitlines():
        if line.startswith("|"):
            table_buf.append([c for c in line.strip("|").split("|")])
            continue
        flush_table()
        if line.startswith("# "):
            doc.add_heading(line[2:], 0)
        elif line.startswith("## "):
            doc.add_heading(line[3:], level=1)
        elif line.startswith("### "):
            doc.add_heading(line[4:], level=2)
        elif line.startswith("!["):
            path = line[line.find("(") + 1 : line.find(")")]
            if os.path.exists(path):
                doc.add_picture(path, width=Inches(6.0))
        elif line.strip():
            doc.add_paragraph(line)
    flush_table()
    doc.save(filename)


def plane_report(analysis, filename: str = "plane_report.md",
                 image: bool = True) -> str:
    """2D static analysis report (same layout family as solid_report; the
    reference has no 2D product to mirror — FEM_main.py:412-431 placeholder)."""
    lines: List[str] = []
    lines.append("# 2D Static Analysis Report\n")
    if image:
        img_path = os.path.splitext(filename)[0] + "_von_mises.png"
        try:
            from femx_torch.viz import save_plane_results_plot

            save_plane_results_plot(analysis, img_path)
            lines.append("## Results Overview\n")
            lines.append("Deformed shape colored by von Mises stress.\n")
            lines.append(f"![results]({os.path.basename(img_path)})\n")
        except Exception as e:
            lines.append(f"_Could not generate result image: {e}_\n")

    lines.append("## Analysis Parameters\n")
    lines.append(f"- **Young's Modulus (E):** {analysis.E:.2e} Pa")
    lines.append(f"- **Poisson's Ratio (v):** {analysis.v}")
    lines.append(f"- **Thickness (t):** {analysis.thickness} m")
    lines.append(f"- **Formulation:** plane {analysis.mode}\n")

    lines.append("## Mesh Information\n")
    lines.append(f"- **Total Nodes:** {analysis.num_nodes}")
    lines.append("- **Element Type:** 6-Node Quadratic Triangle (Tri6)")
    lines.append(f"- **Total Elements:** {len(analysis.conn)}\n")

    lines.append("## Boundary Conditions\n")
    for i, item in enumerate(analysis.applied_forces_info):
        where = (f"edge group '{item['group']}' ({item['nodes']} nodes)"
                 if "group" in item else
                 f"node {item['node_idx']} at "
                 f"({item['pos'][0]:.4g}, {item['pos'][1]:.4g})")
        vec = item["force_vec"]
        lines.append(f"- **Load {i + 1}:** ({vec[0]:g}, {vec[1]:g}) N on {where}")
    lines.append(f"- **Fixed DOFs:** {len(analysis.fixed_dofs)}\n")

    lines.append("## Equilibrium Check\n")
    res = analysis.equilibrium_residual()
    lines.append(f"- Sum of applied + reaction forces: "
                 f"({res[0]:.3e}, {res[1]:.3e}) N\n")

    vm = getattr(analysis, "von_mises", None)
    if vm is None:
        _, vm = analysis.compute_stresses()
    imax = int(np.argmax(vm))
    p = analysis.points[imax]
    lines.append("## Stress Results (von Mises, nodal recovery)\n")
    lines.append(f"- **Max von Mises stress:** {vm[imax] / 1e6:.4f} MPa at "
                 f"node {imax} ({p[0]:.4g}, {p[1]:.4g})")
    lines.append(f"- **Max displacement:** "
                 f"{np.abs(analysis.u.reshape(-1, 2)).max():.4e} m\n")

    modal = getattr(analysis, "modal_result", None)
    if modal is not None:
        lines.append("## Modal Analysis Results\n")
        lines.append("| Mode | Frequency (rad/s) | Frequency (Hz) |")
        lines.append("|---|---|---|")
        for i, w in enumerate(_host(modal.omega)):
            lines.append(f"| {i + 1} | {w:.4f} | {w / (2 * np.pi):.4f} |")
        lines.append("")

    if getattr(analysis, "solve_info", None):
        lines.append("## Solver\n")
        for k, v in analysis.solve_info.items():
            lines.append(f"- **{k}:** {v}")

    text = "\n".join(lines) + "\n"
    if filename.endswith(".docx"):
        _markdown_ish_to_docx(text, filename)
    else:
        with open(filename, "w") as f:
            f.write(text)
    return filename


def pipe_report(analysis, filename: str = "pipe_report.md",
                image: bool = True) -> str:
    """Pipe thermal-stress report: parameters, wall contour + radial stress
    profiles, bore/outer design numbers."""
    lines: List[str] = []
    lines.append("# Pipe Thermal Stress Analysis Report\n")
    if image:
        img_path = os.path.splitext(filename)[0] + "_stresses.png"
        try:
            from femx_torch.viz import save_pipe_results_plot

            save_pipe_results_plot(analysis, img_path)
            lines.append("## Results Overview\n")
            lines.append(f"![results]({os.path.basename(img_path)})\n")
        except Exception as e:
            lines.append(f"_Could not generate result image: {e}_\n")

    lines.append("## Pipe and Load Parameters\n")
    lines.append(f"- **Geometry:** r_inner {analysis.r_inner} m, r_outer "
                 f"{analysis.r_outer} m, length {analysis.length} m")
    lines.append(f"- **Material:** E = {analysis.E:.2e} Pa, v = {analysis.v}, "
                 f"alpha = {analysis.alpha:.3g} 1/K")
    lines.append(f"- **Wall temperature rise:** {analysis.T_inner} K (inner) "
                 f"-> {analysis.T_outer} K (outer), log radial profile")
    lines.append(f"- **Pressure:** {analysis.pressure_inner:.4g} Pa (inner), "
                 f"{analysis.pressure_outer:.4g} Pa (outer)")
    if getattr(analysis, "spin_rpm", 0.0):
        lines.append(f"- **Spin:** {analysis.spin_rpm:g} RPM "
                     f"(rho = {analysis.rho:g} kg/m^3, centrifugal body load)")
    lines.append(f"- **End condition:** {analysis.end_condition}\n")

    lines.append("## Mesh Information\n")
    lines.append(f"- **Total Nodes:** {analysis.num_nodes} "
                 "(axisymmetric Tri6 wall section)")
    lines.append(f"- **Total Elements:** {len(analysis.conn)}\n")

    radii, s_rr = analysis.radial_profile(analysis.stress_nodes[:, 0])
    _, s_zz = analysis.radial_profile(analysis.stress_nodes[:, 1])
    _, s_tt = analysis.radial_profile(analysis.stress_nodes[:, 2])
    _, vm_r = analysis.radial_profile(analysis.von_mises)
    lines.append("## Stress Results\n")
    imax = int(np.argmax(analysis.von_mises))
    p = analysis.points[imax]
    lines.append(f"- **Max von Mises stress:** "
                 f"{analysis.von_mises[imax] / 1e6:.4f} MPa at "
                 f"r = {p[0]:.4g} m, z = {p[1]:.4g} m")
    lines.append(f"- **Max radial displacement:** "
                 f"{np.abs(analysis.u[0::2]).max():.4e} m\n")
    lines.append("| Surface | sigma_rr (MPa) | sigma_theta (MPa) | "
                 "sigma_zz (MPa) | von Mises (MPa) |")
    lines.append("|---|---|---|---|---|")
    for name, j in (("Bore (inner)", 0), ("Outer", -1)):
        lines.append(f"| {name} | {s_rr[j] / 1e6:.3f} | {s_tt[j] / 1e6:.3f} "
                     f"| {s_zz[j] / 1e6:.3f} | {vm_r[j] / 1e6:.3f} |")

    if getattr(analysis, "solve_info", None):
        lines.append("\n## Solver\n")
        for k, v in analysis.solve_info.items():
            lines.append(f"- **{k}:** {v}")

    text = "\n".join(lines) + "\n"
    if filename.endswith(".docx"):
        _markdown_ish_to_docx(text, filename)
    else:
        with open(filename, "w") as f:
            f.write(text)
    return filename


def shaft_report(shaft, filename: str = "shaft_report.md",
                 image: bool = True, n_mode_images: int = 3) -> str:
    """Shaft modal report: geometry, bearing layout, modal table with
    critical speeds, first lateral mode-shape images."""
    lines: List[str] = []
    lines.append("# Shaft Modal Analysis Report\n")

    lines.append("## Shaft Geometry\n")
    x = 0.0
    for i, s in enumerate(shaft.segments):
        di = s.get("d_inner", 0.0)
        hollow = f", d_inner = {di} m" if di else " (solid)"
        lines.append(f"- **Segment {i + 1}:** x = [{x:g}, "
                     f"{x + s['length']:g}] m, d = {s['d']} m{hollow}")
        x += s["length"]
    for i, b in enumerate(shaft.bearings):
        kind = " (thrust)" if i == shaft.thrust_bearing else ""
        lines.append(f"- **Bearing {i + 1}:** x = {b:g} m, pinned{kind}")
    lines.append(f"- **Material:** E = {shaft.E:.2e} Pa, nu = {shaft.nu}, "
                 f"rho = {shaft.rho} kg/m^3")
    lines.append(f"- **Mesh:** {len(shaft.mesh.points)} nodes, "
                 f"{len(shaft.mesh.cells['line'])} Timoshenko elements, "
                 f"{shaft.mass} mass\n")

    lines.append("## Modal Results\n")
    lines.append("| Mode | Frequency (Hz) | Family | Critical speed (RPM) |")
    lines.append("|---|---|---|---|")
    for i, m in enumerate(shaft.modes):
        rpm = (f"{m.critical_speed_rpm:.1f}"
               if m.critical_speed_rpm is not None else "-")
        lines.append(f"| {i + 1} | {m.frequency_hz:.4f} | {m.family} | {rpm} |")
    crits = shaft.critical_speeds_rpm
    if len(crits):
        lines.append(f"\n- **First critical speed:** {crits[0]:.1f} RPM "
                     f"({crits[0] / 60:.3f} Hz)")

    if image and shaft.modes:
        lines.append("\n## Mode Shapes\n")
        lat_idx = [i for i, m in enumerate(shaft.modes)
                   if m.family == "lateral"]
        for k, i in enumerate(lat_idx[:n_mode_images]):
            img_path = (os.path.splitext(filename)[0]
                        + f"_mode{i + 1}.png")
            try:
                from femx_torch.viz import save_shaft_mode_plot

                save_shaft_mode_plot(shaft, i + 1, img_path)
                lines.append(f"![mode {i + 1}]({os.path.basename(img_path)})\n")
            except Exception as e:
                lines.append(f"_Could not generate mode image: {e}_\n")

    text = "\n".join(lines) + "\n"
    if filename.endswith(".docx"):
        _markdown_ish_to_docx(text, filename)
    else:
        with open(filename, "w") as f:
            f.write(text)
    return filename
