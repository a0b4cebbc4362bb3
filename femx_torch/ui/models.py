"""GUI view-models (port of femx/ui/models.py): the reference windows'
data and controller logic, headless.

The reference couples its data model to PyQt5 widgets
(ReactionForceCalculatorWindow FEM_main.py:105-396, BeamAnalysisWindow
BeamSolver.py:176-465). femx separates them, and this port keeps the split:
these classes hold the state, CRUD operations, display strings and pipeline
calls, all testable without Qt, and femx_torch.ui.qt binds them to widgets
when PyQt5 is available. Defaults, list formats and validation semantics
mirror the reference (pre-seeded 0.8x0.2x0.8 box case FEM_main.py:115-130;
list strings FEM_main.py:152-179 / BeamSolver.py:283-298).

Every pipeline call takes `device` (None = the CUDA card, raising without
one; "cpu" runs there explicitly) and hands it to the analysis.
"""

from __future__ import annotations

from typing import List, Optional

from femx_torch.config import DEFAULT_COMPAT, ReferenceCompat
from femx_torch.mesh import Mesh, box_tet10, read_msh, write_msh

SECTION_TYPES = [
    "I section",
    "C section",
    "L section",
    "hollow box section",
    "rectangular section",
    "circular section",
    "hollow circular section",
]

# Launcher options (reference: FEM_calc.ui:97-111). The reference implements
# only the first two; its last three open an empty 19-line placeholder dialog
# (FEM_main.py:412-431). femx implements all five, and so does the port
# (femx_torch/analysis/{solid,beam,shaft,plane,pipe}.py).
PRODUCT_OPTIONS = [
    "Reaction Force Calculator",
    "Beam analysis",
    "Shaft modal",
    "2D Static Analysis",
    "Pipe Thermal Stress Analysis",
]
IMPLEMENTED_PRODUCTS = list(PRODUCT_OPTIONS)


class ReactionCalculatorModel:
    """State + operations of the 'Reaction Force Calculator' window."""

    def __init__(self):
        # Pre-seeded defaults (reference: FEM_main.py:115-130)
        self.system_data = {"x": 0.8, "y": 0.2, "z": 0.8, "mesh": 0.05}
        self.force_data_list: List[dict] = [
            {"force_x": 0.0, "force_y": 3000.0, "force_z": 0.0,
             "force_x_pstn": 0.4, "force_y_pstn": 0.2, "force_z_pstn": 0.4}
        ]
        self.fix_data_list: List[dict] = [
            {"pos_x": 0.0, "pos_y": 0.0, "pos_z": 0.0, "fix_x": 0, "fix_y": 0, "fix_z": 0},
            {"pos_x": 0.0, "pos_y": 0.0, "pos_z": 0.8, "fix_x": 0, "fix_y": 0, "fix_z": 0},
            {"pos_x": 0.8, "pos_y": 0.0, "pos_z": 0.0, "fix_x": 0, "fix_y": 0, "fix_z": 0},
            {"pos_x": 0.8, "pos_y": 0.0, "pos_z": 0.8, "fix_x": 0, "fix_y": 0, "fix_z": 0},
        ]
        self.youngs_modul = 2e11
        self.poisson_ratio = 0.3
        self.mesh_file = "generated_mesh.msh"
        self.analysis_instance = None
        self._generated_mesh: Optional[Mesh] = None

    # -- list view (reference: _refresh_list_view FEM_main.py:152-179) ------
    def list_items(self) -> List[str]:
        items = []
        if self.system_data:
            s = self.system_data
            items.append(
                f"System Size: ({s['x']}, {s['y']}, {s['z']}), Mesh Size: {s['mesh']}"
            )
        for i, fd in enumerate(self.force_data_list):
            items.append(
                f"Force {i + 1}: ({fd['force_x']}, {fd['force_y']}, {fd['force_z']}) "
                f"@ Pos: ({fd['force_x_pstn']}, {fd['force_y_pstn']}, {fd['force_z_pstn']})"
            )
        for i, fx in enumerate(self.fix_data_list):
            axes = [a for a, k in zip("XYZ", ("fix_x", "fix_y", "fix_z")) if fx[k] == 0]
            items.append(
                f"Fix {i + 1}: Pos ({fx['pos_x']}, {fx['pos_y']}, {fx['pos_z']}) "
                f"- Fixed Dof: [{', '.join(axes) if axes else 'None'}]"
            )
        return items

    # -- CRUD ---------------------------------------------------------------
    def set_system(self, x: float, y: float, z: float, mesh: float) -> None:
        self.system_data = {"x": float(x), "y": float(y), "z": float(z), "mesh": float(mesh)}

    def add_force(self, force_xyz, pos_xyz) -> None:
        fx, fy, fz = (float(v) for v in force_xyz)
        px, py, pz = (float(v) for v in pos_xyz)
        self.force_data_list.append(
            {"force_x": fx, "force_y": fy, "force_z": fz,
             "force_x_pstn": px, "force_y_pstn": py, "force_z_pstn": pz}
        )

    def add_fix(self, pos_xyz, fix_x: bool, fix_y: bool, fix_z: bool) -> None:
        # checked => 0 (fixed), unchecked => None (free): FEM_main.py:236-238
        px, py, pz = (float(v) for v in pos_xyz)
        self.fix_data_list.append(
            {"pos_x": px, "pos_y": py, "pos_z": pz,
             "fix_x": 0 if fix_x else None,
             "fix_y": 0 if fix_y else None,
             "fix_z": 0 if fix_z else None}
        )

    def remove_item(self, row: int) -> bool:
        """Row indices follow list_items(): 0 = system (not removable),
        then forces, then fixes."""
        n_f = len(self.force_data_list)
        if row <= 0:
            return False
        if row <= n_f:
            self.force_data_list.pop(row - 1)
            return True
        idx = row - 1 - n_f
        if idx < len(self.fix_data_list):
            self.fix_data_list.pop(idx)
            return True
        return False

    # -- pipeline -----------------------------------------------------------
    def generate_mesh(self, write: bool = True) -> Mesh:
        """Structured-box equivalent of the gmsh step (gmsh_creation.py)."""
        s = self.system_data
        mesh = box_tet10(
            s["x"], s["y"], s["z"], s["mesh"],
            force_points=[(f["force_x_pstn"], f["force_y_pstn"], f["force_z_pstn"])
                          for f in self.force_data_list],
            fix_points=[(f["pos_x"], f["pos_y"], f["pos_z"]) for f in self.fix_data_list],
        )
        self._generated_mesh = mesh
        if write:
            write_msh(self.mesh_file, mesh)
        return mesh

    def run_analysis(self, compat: ReferenceCompat = DEFAULT_COMPAT, verbose: bool = True,
                     report: bool = False, device=None):
        from femx_torch.analysis import ForceAnalysis

        mesh = self._generated_mesh
        if mesh is None:
            mesh = read_msh(self.mesh_file)
        self.analysis_instance = ForceAnalysis(
            mesh, self.force_data_list, self.fix_data_list,
            E=self.youngs_modul, v=self.poisson_ratio, compat=compat, verbose=verbose,
            device=device,
        )
        self.analysis_instance.run_simulation(report=report)
        return self.analysis_instance

    def plot_results(self, filename: str = "fem_result.png", show_window: bool = False):
        if self.analysis_instance is None:
            raise RuntimeError("Run the analysis first.")
        return self.analysis_instance.plot(show_window=show_window, filename=filename)

    def preview_mesh(self, filename: str = "mesh_preview.html") -> str:
        """Pre-solve mesh inspection (the reference's gmsh FLTK popup,
        gmsh_creation.py:95-97): standalone WebGL wireframe + physical
        groups + BC markers. Generates the mesh first if needed."""
        from femx_torch.viz_html import export_mesh_html

        mesh = self._generated_mesh or self.generate_mesh(write=False)
        return export_mesh_html(mesh, filename)


class BeamAnalysisModel:
    """State + operations of the 'Beam analysis' window."""

    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.mesh_path: Optional[str] = None
        self.section_data: List[dict] = []
        self.bc_data: List[dict] = []
        self.E: Optional[float] = None
        self.nu: Optional[float] = None
        self.rho: float = 7850.0  # the reference's (hardcoded) default
        self.results = None
        self.analysis = None

    # -- mesh ---------------------------------------------------------------
    def load_mesh(self, path_or_mesh) -> List[str]:
        """Load a .msh; returns physical group names for the combo boxes
        (reference: BeamSolver.py:207-220). Raises on missing 'line' cells."""
        mesh = path_or_mesh if isinstance(path_or_mesh, Mesh) else read_msh(path_or_mesh)
        if mesh.cells.get("line") is None:
            raise ValueError("No 'line' elements in .msh file.")
        self.mesh = mesh
        self.mesh_path = None if isinstance(path_or_mesh, Mesh) else str(path_or_mesh)
        self.section_data.clear()
        self.bc_data.clear()
        return list(mesh.field_data.keys())

    # -- CRUD (reference: assign_beam_section/assign_bc/edit/remove) --------
    def assign_section(self, group: str, section_type: str, params: dict,
                       rotate: bool = False, overwrite: bool = True) -> bool:
        exists = any(d["group"] == group for d in self.section_data)
        if exists and not overwrite:
            return False
        self.section_data = [d for d in self.section_data if d["group"] != group]
        self.section_data.append(
            {"group": group, "type": section_type, "params": dict(params), "rotate": rotate}
        )
        return True

    def assign_bc(self, group: str, data: dict, overwrite: bool = True) -> bool:
        exists = any(d["group"] == group for d in self.bc_data)
        if exists and not overwrite:
            return False
        self.bc_data = [d for d in self.bc_data if d["group"] != group]
        item = dict(data)
        item["group"] = group
        self.bc_data.append(item)
        return True

    def remove_item(self, row: int) -> bool:
        n_s = len(self.section_data)
        if 0 <= row < n_s:
            self.section_data.pop(row)
            return True
        if 0 <= row - n_s < len(self.bc_data):
            self.bc_data.pop(row - n_s)
            return True
        return False

    def edit_item(self, row: int, new_params: Optional[dict] = None,
                  rotate: Optional[bool] = None,
                  new_bc: Optional[dict] = None) -> bool:
        """Edit a list row in place (reference: edit_item BeamSolver.py:252-271).

        Rows index section assignments first, then BCs (same ordering as
        list_items). Section rows take new_params / rotate and keep their
        group and type; BC rows take new_bc (a full BC dict) and keep their
        group — exactly the reference dialog's accept semantics."""
        n_s = len(self.section_data)
        if 0 <= row < n_s:
            data = self.section_data[row]
            if new_params is not None:
                p = dict(new_params)
                data["rotate"] = p.pop("rotate", data.get("rotate", False))
                data["params"] = p
            if rotate is not None:
                data["rotate"] = bool(rotate)
            return True
        if 0 <= row - n_s < len(self.bc_data) and new_bc is not None:
            old = self.bc_data[row - n_s]
            item = dict(new_bc)
            item["group"] = old["group"]  # group is not editable (reference)
            self.bc_data[row - n_s] = item
            return True
        return False

    def list_items(self) -> List[str]:
        """Display strings (reference: update_list_view BeamSolver.py:283-298)."""
        out = []
        for item in self.section_data:
            params_str = ", ".join(f"{k}={v}" for k, v in item["params"].items())
            rot = ", rotated" if item.get("rotate") else ""
            out.append(f"[Section] {item['group']}: {item['type']}{rot}, {params_str}")
        for item in self.bc_data:
            if item["type"] == "Fix":
                fixes = [f for f in ["X", "Y", "Z", "RX", "RY", "RZ"]
                         if item.get(f"fix_{f.lower()}")]
                det = f"Fix ({', '.join(fixes) or 'None'})"
            elif item["type"] == "DistributedForce":
                det = (f"Distributed w=({item.get('wx', 0)}, "
                       f"{item.get('wy', 0)}, {item.get('wz', 0)}) N/m")
            else:
                det = (f"Force F=({item.get('force_x', 0)}, "
                       f"{item.get('force_y', 0)}, {item.get('force_z', 0)})")
            out.append(f"[BC] {item['group']}: {det}")
        return out

    # -- pipeline -----------------------------------------------------------
    def run_simulation(self, E: float, nu: float, rho: Optional[float] = None,
                       mass: str = "lumped", section_method: str = "auto", device=None):
        from femx_torch.analysis import BeamAnalysis

        if self.mesh is None:
            raise RuntimeError("Please load a mesh file first.")
        self.E, self.nu = float(E), float(nu)
        if rho is not None:
            self.rho = float(rho)
        self.analysis = BeamAnalysis(
            self.mesh, self.section_data, self.bc_data,
            E=self.E, nu=self.nu, rho=self.rho, mass=mass, section_method=section_method,
            device=device,
        )
        self.results = self.analysis.run()
        return self.results

    def create_report(self, path: str):
        from femx_torch.report import beam_report

        if self.results is None:
            raise RuntimeError("Run the simulation first.")
        return beam_report(self.analysis, self.results, path)

    def plot_static(self, filename: str):
        from femx_torch.viz import save_beam_static_plot

        return save_beam_static_plot(self.analysis, self.results, filename)

    def plot_modal(self, mode_num: int, filename: str):
        from femx_torch.viz import save_beam_modal_plot

        return save_beam_modal_plot(self.analysis, self.results, mode_num, filename)

    def preview_sections(self, filename: str = "section_preview.png"):
        from femx_torch.viz_sections import plot_extruded_sections

        if self.mesh is None or not self.section_data:
            raise RuntimeError("Please load a mesh and assign sections first.")
        return plot_extruded_sections(self.mesh, self.section_data, filename=filename)


class ShaftModalModel:
    """State + operations of the 'Shaft modal' window (a reference
    placeholder, FEM_main.py:412-431, implemented for real)."""

    def __init__(self):
        # pre-seeded demo: a 2 m, 40 mm steel shaft on end bearings
        self.segments: List[dict] = [{"length": 2.0, "d": 0.04}]
        self.bearings: List[float] = [0.0, 2.0]
        self.E = 2e11
        self.nu = 0.3
        self.rho = 7850.0
        self.n_modes = 12
        self.analysis = None
        self.modes = None

    def list_items(self) -> List[str]:
        out = []
        x = 0.0
        for i, s in enumerate(self.segments):
            di = s.get("d_inner", 0.0)
            hollow = f", d_inner={di}" if di else ""
            out.append(f"Segment {i + 1}: x=[{x:g}, {x + s['length']:g}] m, "
                       f"d={s['d']}{hollow}")
            x += s["length"]
        for i, b in enumerate(self.bearings):
            out.append(f"Bearing {i + 1}: x={b:g} m")
        return out

    def add_segment(self, length: float, d: float, d_inner: float = 0.0) -> None:
        seg = {"length": float(length), "d": float(d)}
        if d_inner:
            seg["d_inner"] = float(d_inner)
        self.segments.append(seg)

    def add_bearing(self, x: float) -> None:
        self.bearings.append(float(x))

    def remove_item(self, row: int) -> bool:
        if 0 <= row < len(self.segments):
            self.segments.pop(row)
            return True
        idx = row - len(self.segments)
        if 0 <= idx < len(self.bearings):
            self.bearings.pop(idx)
            return True
        return False

    def run_analysis(self, verbose: bool = True, device=None):
        from femx_torch.analysis import ShaftModalAnalysis

        self.analysis = ShaftModalAnalysis(
            self.segments, self.bearings, E=self.E, nu=self.nu, rho=self.rho,
            verbose=verbose, device=device)
        self.modes = self.analysis.run(n_modes=self.n_modes)
        return self.modes

    def results_text(self) -> List[str]:
        if not self.modes:
            return []
        out = []
        for i, m in enumerate(self.modes):
            rpm = (f" | critical speed {m.critical_speed_rpm:.1f} RPM"
                   if m.critical_speed_rpm is not None else "")
            out.append(f"Mode {i + 1}: {m.frequency_hz:.3f} Hz "
                       f"[{m.family}]{rpm}")
        return out


class PlaneAnalysisModel:
    """State + operations of the '2D Static Analysis' window (a reference
    placeholder, FEM_main.py:412-431, implemented for real).

    Geometry is a rectangle meshed with Tri6 (femx_torch.mesh.generators2d);
    forces/fixes address the boundary edge groups 'left'/'right'/
    'bottom'/'top' or explicit (x, y) points, mirroring the 3D window's
    0 = fixed / None = free semantics."""

    def __init__(self):
        # pre-seeded demo: 1 m x 0.2 m cantilever plate, tip shear
        self.system_data = {"w": 1.0, "h": 0.2, "mesh": 0.025}
        self.force_data_list: List[dict] = [
            {"group": "right", "force_x": 0.0, "force_y": -1000.0}]
        self.fix_data_list: List[dict] = [
            {"group": "left", "fix_x": 0, "fix_y": 0}]
        self.E = 2e11
        self.nu = 0.3
        self.thickness = 0.01
        self.mode = "stress"
        self.analysis = None

    def list_items(self) -> List[str]:
        s = self.system_data
        items = [f"Plate: {s['w']} x {s['h']} m, Mesh Size: {s['mesh']}, "
                 f"t={self.thickness} m ({self.mode})"]
        for i, fd in enumerate(self.force_data_list):
            where = (f"edge '{fd['group']}'" if "group" in fd
                     else f"({fd['force_x_pstn']}, {fd['force_y_pstn']})")
            items.append(f"Force {i + 1}: ({fd['force_x']}, {fd['force_y']}) "
                         f"N @ {where}")
        for i, fx in enumerate(self.fix_data_list):
            axes = [a for a, k in zip("XY", ("fix_x", "fix_y"))
                    if fx.get(k) == 0]
            where = (f"edge '{fx['group']}'" if "group" in fx
                     else f"({fx['pos_x']}, {fx['pos_y']})")
            items.append(f"Fix {i + 1}: {where} - Fixed Dof: "
                         f"[{', '.join(axes) if axes else 'None'}]")
        return items

    def set_system(self, w: float, h: float, mesh: float) -> None:
        self.system_data = {"w": float(w), "h": float(h), "mesh": float(mesh)}

    def add_force(self, force_xy, group: Optional[str] = None,
                  pos_xy=None) -> None:
        fx, fy = (float(v) for v in force_xy)
        item = {"force_x": fx, "force_y": fy}
        if group is not None:
            item["group"] = group
        else:
            item["force_x_pstn"], item["force_y_pstn"] = (
                float(v) for v in pos_xy)
        self.force_data_list.append(item)

    def add_fix(self, fix_x: bool, fix_y: bool, group: Optional[str] = None,
                pos_xy=None) -> None:
        item = {"fix_x": 0 if fix_x else None, "fix_y": 0 if fix_y else None}
        if group is not None:
            item["group"] = group
        else:
            item["pos_x"], item["pos_y"] = (float(v) for v in pos_xy)
        self.fix_data_list.append(item)

    def remove_item(self, row: int) -> bool:
        n_f = len(self.force_data_list)
        if row <= 0:
            return False
        if row <= n_f:
            self.force_data_list.pop(row - 1)
            return True
        idx = row - 1 - n_f
        if idx < len(self.fix_data_list):
            self.fix_data_list.pop(idx)
            return True
        return False

    def run_analysis(self, verbose: bool = True, device=None):
        from femx_torch.analysis import PlaneAnalysis
        from femx_torch.mesh.generators2d import rect_tri6

        s = self.system_data
        mesh = rect_tri6(s["w"], s["h"], s["mesh"])
        self.analysis = PlaneAnalysis(
            mesh, self.force_data_list, self.fix_data_list,
            E=self.E, v=self.nu, thickness=self.thickness, mode=self.mode,
            verbose=verbose, device=device)
        self.analysis.run_simulation()
        self.analysis.compute_stresses()
        return self.analysis


class PipeThermalModel:
    """State + operations of the 'Pipe Thermal Stress Analysis' window
    (a reference placeholder, FEM_main.py:412-431, implemented for real)."""

    def __init__(self):
        # pre-seeded demo: a hot steam pipe
        self.params = {
            "r_inner": 0.05, "r_outer": 0.08, "length": 0.3,
            "E": 2e11, "v": 0.3, "alpha": 1.2e-5,
            "T_inner": 200.0, "T_outer": 50.0,
            "pressure_inner": 5e6, "pressure_outer": 0.0,
        }
        self.end_condition = "plane_strain"
        self.n_r = 24
        self.n_z = 12
        self.analysis = None

    def list_items(self) -> List[str]:
        p = self.params
        return [
            f"Pipe: r=[{p['r_inner']}, {p['r_outer']}] m, L={p['length']} m "
            f"({self.end_condition})",
            f"Material: E={p['E']:g} Pa, v={p['v']}, alpha={p['alpha']:g}",
            f"Wall temperature: {p['T_inner']} -> {p['T_outer']} degC",
            f"Pressure: inner {p['pressure_inner']:g} Pa, "
            f"outer {p['pressure_outer']:g} Pa",
        ]

    def run_analysis(self, verbose: bool = True, device=None):
        from femx_torch.analysis import PipeThermalAnalysis

        self.analysis = PipeThermalAnalysis(
            end_condition=self.end_condition, n_r=self.n_r, n_z=self.n_z,
            verbose=verbose, device=device, **self.params)
        self.analysis.run_simulation()
        return self.analysis

    def results_text(self) -> List[str]:
        a = self.analysis
        if a is None:
            return []
        import numpy as np

        i = int(np.argmax(a.von_mises))
        return [
            f"max |u_r| = {np.abs(a.u[0::2]).max():.4e} m",
            f"max von Mises = {a.von_mises[i]:.4e} Pa @ "
            f"r={a.points[i, 0]:.4g} m, z={a.points[i, 1]:.4g} m",
            f"bore hoop stress = "
            f"{a.radial_profile(a.stress_nodes[:, 2])[1][0]:.4e} Pa",
        ]
