"""2D plane stress/strain static analysis (port of femx/analysis/plane.py).

The reference lists "2D Static Analysis" in its launcher but loads an empty
placeholder dialog (FEM_main.py:412-431, static.ui); femx implements it, and
the port follows femx on `device` (None = CUDA): Tri6 quadratic triangles,
the matrix-free operator with masked Dirichlet BCs (its element gather the
take_rows kernel on the card), dense Cholesky up to DENSE_DOF_LIMIT DOFs,
geometric MG-PCG on a rect_tri6 lattice and block-Jacobi PCG on any other
mesh above it, reactions r = K u with the unconstrained operator, the
equilibrium self-check and the stage prints.

BC semantics mirror the solid product (SURVEY.md §6 quirk 5): fix dicts use
0 = fixed / None = free per axis; point BCs snap to the nearest node of the
matching physical group; a fix or force dict may instead name a 1D physical
group (rect_tri6's "left"/"right"/"bottom"/"top") to constrain or load every
node of that edge, a group force spread by tributary edge length (line3
weights 1/6, 4/6, 1/6 per element).

With dtype=float32 the iterative routes run float64 CG on the float64
operator, preconditioned by the float32 V-cycle or block-Jacobi built on
the operator cast to float32 (methods "*_mixed"); femx instead runs the whole CG in
float32, whose recursive residual reaches the tolerance while the true one
stalls, and its reactions then miss the float64 equilibrium
(tests/test_torch_plane.py). The dense route solves in float64 whatever the
dtype, as the port's solid small-mesh routes do.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from femx_torch.assembly import assemble_dense, dof_map
from femx_torch.assembly_plane import PlaneOperator
from femx_torch.config import resolve_device, torch_dtype
from femx_torch.elements import tri6 as tri6_el
from femx_torch.mesh.core import Mesh, nearest_node, nodes_in_physical_group
from femx_torch.mesh.msh_io import read_msh
from femx_torch.solve.cg import pcg, pcg_mixed
from femx_torch.solve.dense import solve_dense


def solve_2d(operator, mesh, mask, fv, cg_tol, *, kind, thickness=1.0,
             log=lambda msg: None, precond_dtype=None):
    """The iterative routing of the 2D products: geometric MG-PCG when the
    mesh is a rect_tri6 lattice, block-Jacobi PCG otherwise (femx's
    maxiter 2000 and 20000).

    With a precond_dtype other than the operator's (float32 for a float64
    operator), the preconditioner is built on the operator cast to it, and
    CG runs on the operator itself (pcg_mixed). Returns (u, solve_info)."""
    mixed = precond_dtype is not None and torch_dtype(precond_dtype) != operator.dtype
    pre_op = operator.to(precond_dtype) if mixed else operator
    lat = getattr(mesh, "lattice2d", None)
    suffix = "_mixed" if mixed else ""

    def run(precond, maxiter):
        if not mixed:
            return pcg(operator.apply_constrained, fv, M_inv_diag=precond, tol=cg_tol,
                       maxiter=maxiter)
        return pcg_mixed(operator.apply_constrained, fv, precond, tol=cg_tol, maxiter=maxiter,
                         low_dtype=pre_op.dtype)

    if lat is not None:
        from femx_torch.solve.multigrid2d import Multigrid2D

        try:
            mg = Multigrid2D(kind, lat["n_cells"], lat["spacing"], lat["origin"], pre_op.C, mask,
                             thickness=thickness, fine_op=pre_op, dtype=pre_op.dtype)
        except ValueError as e:
            log(f"   - 2D multigrid unavailable ({e}); block-Jacobi PCG.")
        else:
            res = run(mg, 2000)
            return res.x, {
                "method": "mg_pcg_2d" + suffix, "ndof": int(fv.shape[0]),
                "mg_levels": mg.level_shapes(), "applies_per_cycle": mg.applies_per_cycle(),
                "iterations": res.iterations, "residual_norm": res.residual_norm,
                "converged": bool(res.residual_norm <= cg_tol * 10),
            }
    res = run(pre_op.block_jacobi_preconditioner(), 20000)
    return res.x, {
        "method": "block_jacobi_pcg" + suffix, "ndof": int(fv.shape[0]),
        "iterations": res.iterations, "residual_norm": res.residual_norm,
        "converged": bool(res.residual_norm <= cg_tol * 10),
    }


def _edge_tributary_weights(mesh: Mesh, group: str) -> Optional[np.ndarray]:
    """Per-node consistent weights (summing to 1) for a line3 edge group:
    int(N_i) over a straight quadratic edge of length L is (L/6, L/6, 4L/6)
    for (end, end, mid)."""
    conn = mesh.cells.get("line3")
    tags = mesh.cell_physical.get("line3")
    if conn is None or tags is None or group not in mesh.field_data:
        return None
    gid = mesh.field_data[group][0]
    elems = conn[tags == gid]
    if not len(elems):
        return None
    w = np.zeros(mesh.num_nodes)
    for a, b, m in elems:
        L = float(np.linalg.norm(mesh.points[b] - mesh.points[a]))
        w[a] += L / 6.0
        w[b] += L / 6.0
        w[m] += 4.0 * L / 6.0
    total = w.sum()
    return w / total if total > 0 else None


def nodal_average(operator, elem_values: torch.Tensor) -> np.ndarray:
    """Element-node values (E, 6, k) averaged over the elements sharing each
    node, on the operator's device; host float64 (n_nodes, k)."""
    acc = operator._scatter(elem_values)
    ones = torch.ones(elem_values.shape[:2] + (1,), dtype=elem_values.dtype,
                      device=elem_values.device)
    cnt = operator._scatter(ones)
    return (acc / torch.clamp(cnt, min=1.0)).to(torch.float64).cpu().numpy()


def sync_time(device: torch.device) -> float:
    """perf_counter after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class PlaneAnalysis:
    """2D plane-elasticity static analysis with point/edge loads and fixes."""

    DENSE_DOF_LIMIT = 6000
    MODAL_DOF_LIMIT = 40000

    def __init__(
        self,
        msh_file: Union[str, Mesh],
        force_data: Sequence[dict],
        fix_data: Sequence[dict],
        E: float,
        v: float,
        thickness: float = 1.0,
        mode: str = "stress",
        alpha: float = 0.0,
        temperature=None,
        dtype=None,
        cg_tol: float = 1e-10,
        verbose: bool = True,
        device=None,
    ):
        """temperature: optional temperature RISE field for thermoelastic
        loading — a scalar, an (n_nodes,) array, or a callable f(x, y) -> dT
        at the nodes; requires alpha > 0. Thermal strains use alpha (plane
        stress) / (1+v) alpha (plane strain). device: None = CUDA."""
        self.device = resolve_device(device)
        self.force_data = list(force_data)
        self.fix_data = list(fix_data)
        self.E = float(E)
        self.v = float(v)
        self.thickness = float(thickness)
        if mode not in ("stress", "strain"):
            raise ValueError(f"mode must be 'stress' or 'strain', got {mode!r}")
        self.mode = mode
        self.dtype = torch_dtype(dtype or np.float64)
        self.cg_tol = cg_tol
        self.verbose = verbose

        self.u: Optional[np.ndarray] = None
        self.f: Optional[np.ndarray] = None
        self.reaction_forces: Optional[np.ndarray] = None
        self.fixed_nodes_info: List[dict] = []
        self.applied_forces_info: List[dict] = []
        self.solve_info: dict = {}
        self.stage_times: dict = {}

        self._log("1. Reading mesh file...")
        t0 = time.perf_counter()
        self.mesh = msh_file if isinstance(msh_file, Mesh) else read_msh(msh_file)
        conn = self.mesh.cells.get("triangle6")
        if conn is None:
            tri3 = self.mesh.cells.get("triangle")
            if tri3 is None:
                raise ValueError("Mesh has no 'triangle6' (or 'triangle') elements.")
            # promote linear triangles in place (shared midside nodes)
            from femx_torch.mesh.generators2d import tri3_to_tri6

            pts6, conn = tri3_to_tri6(self.mesh.points, tri3)
            self.mesh = Mesh(
                points=pts6, cells={**self.mesh.cells, "triangle6": conn},
                cell_physical={**self.mesh.cell_physical,
                               "triangle6": self.mesh.cell_physical.get(
                                   "triangle", np.ones(len(conn), dtype=np.int32))},
                field_data=self.mesh.field_data)
        self.conn = np.asarray(conn)
        self.points = self.mesh.points
        self.num_nodes = len(self.points)
        self.diri_nodes = nodes_in_physical_group(self.mesh, "Diri_BCs", "vertex")
        self.neumann_nodes = nodes_in_physical_group(self.mesh, "Neumann_BCs", "vertex")
        self.stage_times["read_mesh"] = time.perf_counter() - t0
        self._log(f"   - Nodes: {self.num_nodes}, Triangle6 Elements: {len(self.conn)}")

        self.C = tri6_el.material_matrix_plane(self.E, self.v, mode=self.mode, dtype=self.dtype)

        self.alpha = float(alpha)
        if temperature is None:
            self.dT_nodes = None
        else:
            if callable(temperature):
                dT = np.asarray([temperature(x, y) for x, y in self.points[:, :2]])
            else:
                dT = np.broadcast_to(np.asarray(temperature, dtype=np.float64),
                                     (self.num_nodes,)).copy()
            if self.alpha == 0.0:
                raise ValueError("temperature loading requires alpha > 0")
            self.dT_nodes = dT

    @property
    def _alpha_eff(self) -> float:
        # plane strain sees the constrained-z in-plane expansion (1+v) alpha
        return self.alpha * (1.0 + self.v if self.mode == "strain" else 1.0)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    @property
    def ndof(self) -> int:
        return 2 * self.num_nodes

    def assemble(self) -> None:
        self._log("2. Assembling global stiffness operator (matrix-free)...")
        t0 = time.perf_counter()
        self.operator, detJ = PlaneOperator.from_mesh(
            self.points, self.conn, tri6_el.material_matrix_plane(self.E, self.v, mode=self.mode),
            thickness=self.thickness, dtype=torch.float64, device=self.device)
        self.negative_detJ_count = int((detJ <= 1e-14).sum())
        self.stage_times["assemble"] = sync_time(self.device) - t0
        self._log("   - Assembly complete.")

    def apply_boundary_conditions(self) -> None:
        self._log("3. Applying boundary conditions...")
        t0 = time.perf_counter()
        fixed: List[int] = []
        info: List[dict] = []
        for fix in self.fix_data:
            if "group" in fix:
                nodes = nodes_in_physical_group(self.mesh, fix["group"])
                if not len(nodes):
                    raise ValueError(f"Fix group {fix['group']!r} resolves to no nodes")
            else:
                pos = (fix["pos_x"], fix["pos_y"], 0.0)
                nodes = [nearest_node(self.points, pos, self.diri_nodes)]
            for n in nodes:
                dofs = []
                if fix.get("fix_x") == 0:
                    dofs.append(2 * n)
                if fix.get("fix_y") == 0:
                    dofs.append(2 * n + 1)
                fixed.extend(dofs)
                info.append({"node_idx": int(n), "pos": self.points[n], "dofs": dofs})
        self.fixed_dofs = np.unique(fixed).astype(np.int64)
        self.fixed_nodes_info = info
        self._log(f"   - Fixed {len(self.fixed_dofs)} DOFs.")

        f = np.zeros(self.ndof)
        applied: List[dict] = []
        for item in self.force_data:
            vec = np.array([item.get("force_x", 0.0), item.get("force_y", 0.0)],
                           dtype=np.float64)
            if "group" in item:
                w = _edge_tributary_weights(self.mesh, item["group"])
                nodes = nodes_in_physical_group(self.mesh, item["group"])
                if w is None or not len(nodes):
                    raise ValueError(f"Force group {item['group']!r} resolves to no "
                                     "line3 edge elements")
                for n in nodes:
                    f[2 * n:2 * n + 2] += vec * w[n]
                applied.append({"group": item["group"], "nodes": len(nodes), "force_vec": vec})
                self._log(f"   - Applied force {vec} N over edge group "
                          f"{item['group']!r} ({len(nodes)} nodes).")
            else:
                pos = (item["force_x_pstn"], item["force_y_pstn"], 0.0)
                n = nearest_node(self.points, pos, self.neumann_nodes)
                f[2 * n:2 * n + 2] += vec
                applied.append({"node_idx": n, "pos": self.points[n], "force_vec": vec})
                self._log(f"   - Applied force {vec} N to node {n}.")
        if self.dT_nodes is not None:
            fe_th = tri6_el.element_thermal_load_plane(
                self.operator.element_values(self.points[:, :2]), self.operator.C,
                self._alpha_eff, self.operator.element_values(self.dT_nodes),
                thickness=self.thickness)
            f += self.operator._scatter(fe_th).cpu().numpy().reshape(-1)
            self._log(f"   - Applied thermal loads (dT range "
                      f"[{self.dT_nodes.min():g}, {self.dT_nodes.max():g}] K).")
        self.f = f
        self.applied_forces_info = applied
        self.stage_times["bc"] = time.perf_counter() - t0

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
            u, self.solve_info = solve_2d(
                self.operator, self.mesh, mask, fv, self.cg_tol, kind="plane",
                thickness=self.thickness, log=self._log, precond_dtype=self.dtype)
        self.u = u.cpu().numpy()
        self.reaction_forces = self.operator.apply(u).cpu().numpy()
        self.stage_times["solve"] = sync_time(self.device) - t0
        self.solve_info["solve_s"] = self.stage_times["solve"]
        self._log("   - System solved.")

    def _reaction_totals(self) -> np.ndarray:
        r = self.reaction_forces
        return np.array([r[self.fixed_dofs[self.fixed_dofs % 2 == 0]].sum(),
                         r[self.fixed_dofs[self.fixed_dofs % 2 == 1]].sum()])

    def _applied_total(self) -> np.ndarray:
        total = np.zeros(2)
        for item in self.applied_forces_info:
            total += np.asarray(item["force_vec"])
        return total

    def print_reactions(self) -> None:
        self._log("\n--- Reaction Forces ---")
        r = self.reaction_forces
        for rec in self.fixed_nodes_info[:12]:
            n = rec["node_idx"]
            self._log(f"  Node {n}: Rx={r[2 * n]:.4e}, Ry={r[2 * n + 1]:.4e} N")
        self._log("\n--- Force Equilibrium Check ---")
        self._log(f"  Sum of Applied Forces (Fx, Fy): {self._applied_total()}")
        self._log(f"  Sum of Reaction Forces (Rx, Ry): {self._reaction_totals()}")

    def equilibrium_residual(self) -> np.ndarray:
        """Sum of applied + reaction forces at fixed DOFs; ~0 at convergence."""
        return self._applied_total() + self._reaction_totals()

    def compute_stresses(self):
        """Nodal-averaged stresses (Voigt [xx, yy, xy]) and von Mises,
        evaluated at each element's own nodes and averaged over the elements
        sharing a node (O(h^2) accurate); float64 on the device. Returns
        (stress_nodes (N, 3), vm (N,))."""
        u = torch.as_tensor(self.u, dtype=torch.float64, device=self.device)
        op = self.operator
        dT = None if self.dT_nodes is None else op.element_values(self.dT_nodes)
        stress = tri6_el.element_stress_at_nodes_plane(
            op.element_values(self.points[:, :2]), op.C, op._gather(u),
            alpha_eff=self._alpha_eff, dT_nodes=dT)
        s_node = nodal_average(self.operator, stress)
        vm = tri6_el.von_mises_plane(torch.as_tensor(s_node),
                                     None if self.mode == "stress" else self.v).numpy()
        self.stress_nodes = s_node
        self.von_mises = vm
        return s_node, vm

    def modal(self, n_modes: int = 10, rho: float = 7850.0):
        """2D natural frequencies and mode shapes: consistent Tri6 mass
        (exact degree-4 quadrature) and the partitioned dense eigensolve
        (femx_torch.modal.modal_dense) on the device, in float64.

        Returns a femx_torch.modal.ModalResult (omega rad/s ascending, modes
        as full-DOF columns, tensors on the device), also kept as
        .modal_result."""
        from femx_torch.modal import modal_dense

        if self.u is None:
            raise RuntimeError("Run the analysis first (BCs are set there).")
        if self.ndof > self.MODAL_DOF_LIMIT:
            raise ValueError(f"dense 2D modal is limited to {self.MODAL_DOF_LIMIT} DOF "
                             f"(got {self.ndof}); coarsen the mesh")
        me = tri6_el.element_mass_plane(self.operator.element_values(self.points[:, :2]),
                                        float(rho), thickness=self.thickness)
        M = assemble_dense(me, dof_map(self.operator.conn, 2), self.ndof)
        res = modal_dense(self.operator.dense(), M, self.fixed_dofs, n_modes=n_modes,
                          device=self.device)
        self.modal_result = res
        return res

    def plot(self, filename: str = "plane_result.png", field: str = "von_mises",
             warp_scale=None) -> str:
        """Deformed contour plot (field: von_mises/disp/sxx/syy/sxy)."""
        from femx_torch.viz import save_plane_results_plot

        if self.u is None:
            raise RuntimeError("Run the analysis first.")
        return save_plane_results_plot(self, filename, field=field, warp_scale=warp_scale)

    def generate_report(self, filename: str = "plane_report.md") -> str:
        from femx_torch.report import plane_report

        if self.u is None:
            raise RuntimeError("Run the analysis first.")
        if getattr(self, "von_mises", None) is None:
            self.compute_stresses()
        return plane_report(self, filename)

    def run_simulation(self):
        self.assemble()
        self.apply_boundary_conditions()
        self.solve()
        self.print_reactions()
        return self
