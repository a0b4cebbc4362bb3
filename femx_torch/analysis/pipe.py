"""Pipe thermal-stress analysis (port of femx/analysis/pipe.py).

The reference lists "Pipe Thermal Stress Analysis" in its launcher but loads
an empty placeholder dialog (FEM_main.py:412-431); femx implements it as an
AXISYMMETRIC Tri6 model of the pipe wall's (r, z) section, a rectangle
[r_i, r_o] x [0, L] meshed by rect_tri6_from_cells, and the port follows it
on `device` (None = CUDA), through femx_torch.analysis.plane.solve_2d with
kind="axisym" above DENSE_DOF_LIMIT (the 2D MG-PCG, its operator applies
the take_rows kernel on the card).

Physics, as in femx:
  - steady radial conduction: T(r) = T_i + (T_o - T_i) ln(r/r_i) / ln(r_o/r_i)
    (rises above the stress-free temperature);
  - thermoelastic loads int B^T C (alpha T [1,1,1,0]) dV per element;
  - optional internal/external pressure as consistent edge tractions with
    the 2*pi*r measure, and a spin body force (spin_rpm, rho);
  - end conditions "plane_strain" (u_z = 0 on both ends) or "free"
    (u_z = 0 at z = 0 only).

Validation (tests/test_torch_pipe.py): the port's stresses against femx's;
on the card (chip_smoke.py phase 16) pressure-only against the Lame
solution and thermal against the radial ODE.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from femx_torch.analysis.plane import nodal_average, solve_2d, sync_time
from femx_torch.assembly_plane import AxisymOperator
from femx_torch.config import resolve_device, torch_dtype
from femx_torch.elements import tri6 as tri6_el
from femx_torch.mesh.core import nodes_in_physical_group
from femx_torch.mesh.generators2d import rect_tri6_from_cells
from femx_torch.solve.dense import solve_dense


def log_temperature_profile(r, r_i, r_o, T_i, T_o):
    """Steady conduction through a cylinder wall: the log radial profile."""
    r = np.asarray(r, dtype=np.float64)
    return T_i + (T_o - T_i) * np.log(r / r_i) / np.log(r_o / r_i)


class PipeThermalAnalysis:
    """Thermal + pressure stress in a thick-walled pipe (axisymmetric FEM)."""

    DENSE_DOF_LIMIT = 9000

    def __init__(
        self,
        r_inner: float,
        r_outer: float,
        length: float,
        E: float,
        v: float,
        alpha: float,
        T_inner: float = 0.0,
        T_outer: float = 0.0,
        pressure_inner: float = 0.0,
        pressure_outer: float = 0.0,
        rho: float = 0.0,
        spin_rpm: float = 0.0,
        end_condition: str = "plane_strain",
        n_r: int = 16,
        n_z: int = 8,
        dtype=None,
        cg_tol: float = 1e-11,
        verbose: bool = True,
        device=None,
    ):
        """dtype: float32 runs the iterative route as PlaneAnalysis does
        (float64 CG, float32 preconditioner); device: None = CUDA."""
        self.device = resolve_device(device)
        if not (0 < r_inner < r_outer):
            raise ValueError("need 0 < r_inner < r_outer")
        if end_condition not in ("plane_strain", "free"):
            raise ValueError(
                f"end_condition must be 'plane_strain' or 'free', "
                f"got {end_condition!r}")
        self.r_inner = float(r_inner)
        self.r_outer = float(r_outer)
        self.length = float(length)
        self.E = float(E)
        self.v = float(v)
        self.alpha = float(alpha)
        self.T_inner = float(T_inner)
        self.T_outer = float(T_outer)
        self.pressure_inner = float(pressure_inner)
        self.pressure_outer = float(pressure_outer)
        self.rho = float(rho)
        self.spin_rpm = float(spin_rpm)
        if self.spin_rpm and self.rho <= 0.0:
            raise ValueError("spin_rpm loading requires rho > 0")
        self.end_condition = end_condition
        self.dtype = torch_dtype(dtype or np.float64)
        self.cg_tol = cg_tol
        self.verbose = verbose

        self.u: Optional[np.ndarray] = None
        self.solve_info: dict = {}
        self.stage_times: dict = {}

        self._log("1. Generating axisymmetric (r, z) cross-section mesh...")
        t0 = time.perf_counter()
        wall = self.r_outer - self.r_inner
        self.mesh = rect_tri6_from_cells(
            (int(n_r), int(n_z)), (wall / n_r, self.length / n_z),
            origin=(self.r_inner, 0.0))
        # mesh axes: x = r ("left"/"right" edges = inner/outer surface),
        # y = z ("bottom"/"top" edges = the pipe ends)
        self.points = self.mesh.points
        self.num_nodes = len(self.points)
        self.conn = np.asarray(self.mesh.cells["triangle6"])
        self.stage_times["mesh"] = time.perf_counter() - t0
        self._log(f"   - Nodes: {self.num_nodes}, Triangle6 Elements: "
                  f"{len(self.conn)} (wall {wall:.4g} m x length "
                  f"{self.length:.4g} m)")

        self.C = tri6_el.material_matrix_axisym(self.E, self.v, dtype=self.dtype)
        self.T_nodes = log_temperature_profile(
            self.points[:, 0], self.r_inner, self.r_outer,
            self.T_inner, self.T_outer)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    @property
    def ndof(self) -> int:
        return 2 * self.num_nodes

    def _edge_pressure_loads(self) -> np.ndarray:
        """Consistent nodal loads for inner/outer surface pressure.

        On the surface r = R the traction is -+p e_r; the consistent load on
        edge shape function N_n is integral(N_n p 2 pi R dz) — per straight
        line3 edge of length Lz: 2 pi R p Lz (1/6, 1/6, 4/6)."""
        f = np.zeros(self.ndof)
        conn3 = self.mesh.cells.get("line3")
        tags = self.mesh.cell_physical.get("line3")
        for group, R, p, sign in (
            ("left", self.r_inner, self.pressure_inner, +1.0),
            ("right", self.r_outer, self.pressure_outer, -1.0),
        ):
            if p == 0.0:
                continue
            gid = self.mesh.field_data[group][0]
            for a, b, m in conn3[tags == gid]:
                Lz = abs(float(self.points[b, 1] - self.points[a, 1]))
                s = sign * p * 2.0 * np.pi * R * Lz
                f[2 * a] += s / 6.0
                f[2 * b] += s / 6.0
                f[2 * m] += 4.0 * s / 6.0
        return f

    def assemble(self) -> None:
        self._log("2. Assembling axisymmetric operator + thermal loads...")
        t0 = time.perf_counter()
        self.operator, detJ = AxisymOperator.from_mesh(
            self.points, self.conn, tri6_el.material_matrix_axisym(self.E, self.v),
            dtype=torch.float64, device=self.device)
        self.negative_detJ_count = int((detJ <= 1e-14).sum())
        coords = self.operator.element_values(self.points[:, :2])
        fe = tri6_el.element_thermal_load_axisym(coords, self.operator.C, self.alpha,
                                                 self.operator.element_values(self.T_nodes))
        if self.spin_rpm:
            omega = self.spin_rpm * 2.0 * np.pi / 60.0
            fe = fe + tri6_el.element_centrifugal_load_axisym(coords, self.rho * omega * omega)
            self._log(f"   - Applied centrifugal load ({self.spin_rpm:g} RPM).")
        f = self.operator._scatter(fe).cpu().numpy()
        self.f = f.reshape(-1) + self._edge_pressure_loads()
        self.stage_times["assemble"] = sync_time(self.device) - t0
        self._log("   - Assembly complete.")

    def apply_boundary_conditions(self) -> None:
        self._log("3. Applying end conditions "
                  f"({self.end_condition})...")
        fixed: List[int] = []
        bottom = nodes_in_physical_group(self.mesh, "bottom")
        fixed.extend(2 * int(n) + 1 for n in bottom)  # u_z = 0 at z = 0
        if self.end_condition == "plane_strain":
            top = nodes_in_physical_group(self.mesh, "top")
            fixed.extend(2 * int(n) + 1 for n in top)  # u_z = 0 at z = L
        self.fixed_dofs = np.unique(fixed).astype(np.int64)
        self._log(f"   - Fixed {len(self.fixed_dofs)} DOFs.")

    def solve(self) -> None:
        self._log("4. Solving the linear system...")
        t0 = time.perf_counter()
        mask = np.ones(self.ndof)
        mask[self.fixed_dofs] = 0.0
        self.operator = self.operator.with_free_mask(mask)
        fv = torch.as_tensor(self.f * mask, dtype=torch.float64, device=self.device)
        if self.ndof <= self.DENSE_DOF_LIMIT:
            u = solve_dense(self.operator.dense(), fv, free_mask=self.operator.free_mask)
            self.solve_info = {"method": "dense_cholesky", "ndof": self.ndof}
        else:
            u, self.solve_info = solve_2d(self.operator, self.mesh, mask, fv, self.cg_tol,
                                          kind="axisym", log=self._log, precond_dtype=self.dtype)
        self.u = u.cpu().numpy()
        self.stage_times["solve"] = sync_time(self.device) - t0
        self.solve_info["solve_s"] = self.stage_times["solve"]
        self._log("   - System solved.")

    def compute_stresses(self):
        """Nodal-averaged stresses (Voigt [rr, zz, tt, rz]) + von Mises.

        Thermal-corrected, sigma = C (eps - alpha T), evaluated at each
        element's nodes (exact nodal hoop strain u_r/r, nodal temperatures)
        and averaged over the elements sharing a node; float64 on the
        device. Sets .stress_nodes (N, 4) and .von_mises (N,)."""
        u = torch.as_tensor(self.u, dtype=torch.float64, device=self.device)
        op = self.operator
        stress = tri6_el.element_stress_at_nodes_axisym(
            op.element_values(self.points[:, :2]), op.C, op._gather(u), alpha=self.alpha,
            dT_nodes=op.element_values(self.T_nodes))
        s_node = nodal_average(self.operator, stress)
        vm = tri6_el.von_mises_axisym(torch.as_tensor(s_node)).numpy()
        self.stress_nodes = s_node
        self.von_mises = vm
        return s_node, vm

    def radial_profile(self, field: np.ndarray, z: Optional[float] = None):
        """(radii, values) of a nodal field along the mid-height node row
        (or the row nearest a given z) — the natural report/plot axis."""
        zs = self.points[:, 1]
        z_target = (self.length / 2.0) if z is None else float(z)
        z_row = zs[np.argmin(np.abs(zs - z_target))]
        row = np.where(np.abs(zs - z_row) < 1e-12)[0]
        order = np.argsort(self.points[row, 0])
        return self.points[row[order], 0], np.asarray(field)[row[order]]

    def plot(self, filename: str = "pipe_result.png") -> str:
        """Wall von Mises contour + mid-height radial stress profiles."""
        from femx_torch.viz import save_pipe_results_plot

        if self.u is None:
            raise RuntimeError("Run the analysis first.")
        return save_pipe_results_plot(self, filename)

    def generate_report(self, filename: str = "pipe_report.md") -> str:
        from femx_torch.report import pipe_report

        if self.u is None:
            raise RuntimeError("Run the analysis first.")
        return pipe_report(self, filename)

    def run_simulation(self):
        self.assemble()
        self.apply_boundary_conditions()
        self.solve()
        self.compute_stresses()
        i = int(np.argmax(self.von_mises))
        self._log("\n--- Pipe Thermal Stress Results ---")
        self._log(f"  max |u_r| = {np.abs(self.u[0::2]).max():.4e} m")
        self._log(f"  max von Mises = {self.von_mises[i]:.4e} Pa at "
                  f"r={self.points[i, 0]:.4g} m, z={self.points[i, 1]:.4g} m")
        return self
