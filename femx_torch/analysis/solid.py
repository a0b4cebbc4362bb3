"""Solid reaction-force analysis on a structured box Tetra10 mesh (port of
femx/analysis/solid.py, structured branch).

Headless equivalent of the reference's `ForceAnalysis`
(ReactionSolver.py:16-306) with the same constructor contract
(mesh, force_data, fix_data, E, v), the same pipeline stages and console
output, and the same outputs (u, reactions at the snapped fix nodes,
equilibrium check):

  assemble -> StructuredSolidOperator (gather-free lattice operator whose
              gather + cell matmul is a hand-written CUDA kernel on the card)
  solve    -> block-Jacobi PCG up to MG_DOF_THRESHOLD DOFs, StructuredMultigrid
              PCG above it; with dtype=float32, float64 CG on the operator
              assembled in float64, preconditioned in float32
  react    -> r = K u with the unconstrained operator

Everything runs on `device` (None = CUDA; without CUDA it raises unless the
caller passes device="cpu"), in `dtype` (None = config.default_dtype(),
float64 unless FEMX_DTYPE says otherwise).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from femx_torch import bc as bc_mod
from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.config import (DEFAULT_COMPAT, ReferenceCompat, default_dtype,
                               numpy_dtype, resolve_device)
from femx_torch.elements.tet10 import material_matrix
from femx_torch.mesh.core import Mesh, nodes_in_physical_group
from femx_torch.solve.cg import pcg, pcg_mixed
from femx_torch.solve.multigrid import StructuredMultigrid


class SolidReactionAnalysis:
    """3D solid elasticity with point loads/fixes and reaction recovery."""

    MG_DOF_THRESHOLD = 150_000  # structured meshes above this get MG-PCG

    def __init__(
        self,
        msh_file: Mesh,
        force_data: Sequence[dict],
        fix_data: Sequence[dict],
        E: float,
        v: float,
        compat: ReferenceCompat = DEFAULT_COMPAT,
        dtype=None,
        solver: str = "auto",
        cg_tol: float = 1e-10,
        verbose: bool = True,
        devices: Optional[int] = None,
        checkpoint: Optional[str] = None,
        structured_apply: Optional[str] = None,
        device=None,
    ):
        if not isinstance(msh_file, Mesh):
            raise NotImplementedError(
                "reading a mesh file is not ported yet (ROADMAP A2); pass a "
                "femx_torch Mesh, e.g. from box_tet10")
        if (devices or 0) > 1:
            raise NotImplementedError("devices=N is not ported yet (ROADMAP A15)")
        if checkpoint is not None:
            raise NotImplementedError("checkpoint= is not ported yet (ROADMAP A9)")
        if structured_apply not in (None, "slot"):
            raise NotImplementedError(
                f"structured_apply={structured_apply!r} is not ported yet "
                "(ROADMAP A14)")
        if solver not in ("auto", "mg", "cg"):
            raise NotImplementedError(
                f"solver={solver!r} is not ported yet (ROADMAP A5)")
        self.device = resolve_device(device)
        self.msh_file = msh_file
        self.force_data = list(force_data)
        self.fix_data = list(fix_data)
        self.E = float(E)
        self.v = float(v)
        self.compat = compat
        self.dtype = dtype
        self.solver = solver
        self.cg_tol = cg_tol
        self.verbose = verbose
        self.structured_apply = "slot"

        self.pd = 3
        self.u: Optional[np.ndarray] = None
        self.f: Optional[np.ndarray] = None
        self.reaction_forces: Optional[np.ndarray] = None
        self.fixed_nodes_info: List[dict] = []
        self.applied_forces_info: List[dict] = []
        self.negative_detJ_count = 0
        self.operator: Optional[StructuredSolidOperator] = None
        self.solve_info: dict = {}
        self.stage_times: dict = {}

        self._read_mesh()
        self.C = material_matrix(self.E, self.v)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def _read_mesh(self) -> None:
        self._log("1. Reading mesh file...")
        t0 = time.perf_counter()
        self.mesh = self.msh_file
        self.points = self.mesh.points
        self.num_nodes = len(self.points)
        self.tetra10_conn = self.mesh.cells.get("tetra10")
        if self.tetra10_conn is None:
            raise ValueError("Mesh has no 'tetra10' elements.")
        if self.mesh.structured is None:
            raise NotImplementedError(
                "unstructured meshes are not ported yet (ROADMAP A5/A11); "
                "build the box with box_tet10 (embed_points=False keeps "
                "off-lattice BC points on the lattice)")
        self.diri_nodes = nodes_in_physical_group(self.mesh, "Diri_BCs", "vertex")
        self.neumann_nodes = nodes_in_physical_group(self.mesh, "Neumann_BCs", "vertex")
        self.stage_times["read_mesh"] = time.perf_counter() - t0
        self._log(f"   - Nodes: {self.num_nodes}, Tetra10 Elements: {len(self.tetra10_conn)}")

    @property
    def weight(self) -> float:
        return self.compat.tet10_gauss_weight

    def assemble_stiffness_matrix(self) -> None:
        """Build the gather-free lattice operator. Structured cells are
        affine images of the unit Kuhn subdivision: every Jacobian is
        positive by construction."""
        self._log("2. Assembling global stiffness operator (matrix-free)...")
        t0 = time.perf_counter()
        self.operator = StructuredSolidOperator.from_mesh(
            self.mesh, self.E, self.v, weight=self.weight,
            dtype=self.dtype or numpy_dtype(default_dtype()), device=self.device)
        self.negative_detJ_count = 0
        self.stage_times["assemble"] = time.perf_counter() - t0
        self._log("   - Assembly complete.")

    def apply_boundary_conditions(self) -> None:
        self._log("3. Applying point-based boundary conditions...")
        t0 = time.perf_counter()
        cs = bc_mod.solid_point_constraints(self.mesh, self.fix_data, self.diri_nodes)
        self.constraints = cs
        self.fixed_dofs = cs.fixed_dofs
        self.fixed_nodes_info = cs.fixed_nodes_info
        self._log(f"   - Fixed {len(self.fixed_dofs)} DOFs.")

        self._log(f"   - Applying {len(self.force_data)} force(s)...")
        self.f, self.applied_forces_info = bc_mod.solid_point_loads(
            self.mesh, self.force_data, self.neumann_nodes)
        for info in self.applied_forces_info:
            self._log(f"     - Applied force {info['force_vec']} N to node {info['node_idx']}.")
        self.active_dofs = cs.free_dofs
        self.stage_times["bc"] = time.perf_counter() - t0

    def solve(self) -> None:
        self._log("4. Solving the linear system...")
        t0 = time.perf_counter()
        ndof = 3 * self.num_nodes
        info = self.mesh.structured
        dtype = self.operator.dtype
        dev = self.device
        mask_g = self.constraints.free_mask()
        m_int = self.operator.to_internal(mask_g)
        op = self.operator.with_free_mask(m_int)
        # Large structured systems get the geometric-multigrid
        # preconditioner (mesh-independent ~15 iterations); small ones stay
        # on block-Jacobi (MG level setup doesn't pay off).
        use_mg = self.solver == "mg" or (
            self.solver == "auto" and ndof > self.MG_DOF_THRESHOLD)
        t_pre = time.perf_counter()
        precond = None
        if use_mg:
            try:
                precond = StructuredMultigrid(
                    None, info.n_cells, self.E, self.v, mask_g,
                    weight=self.weight, dtype=dtype.type, fine_op=op,
                    spacing=info.spacing,
                    smoother=os.environ.get("FEMX_MG_SMOOTHER", "jacobi"),
                    device=dev)
                method = "structured_multigrid_pcg"
            except ValueError as e:
                # e.g. the hierarchy bottoms out too large (odd anisotropic
                # cell counts) — block-Jacobi PCG still solves correctly
                self._log(f"   - Multigrid unavailable ({e}); "
                          "falling back to block-Jacobi PCG.")
        if precond is None:
            binv = [torch.as_tensor(b, device=dev) for b in op.block_jacobi_tensors()]

            def precond(r):
                return op.apply_block_jacobi(binv, r)

            method = "structured_block_jacobi_pcg"
        self.operator = op
        self._precond = precond
        f_int = torch.as_tensor(op.to_internal(self.f * mask_g), device=dev)  # f64
        t_pre = time.perf_counter() - t_pre

        if dtype == np.float32:
            # f64 CG on the f64-assembled operator, preconditioned in f32.
            # femx runs f32 CG with f64 refinement against the f32 cell
            # matrix cast up; that matrix no longer annihilates rigid
            # translations exactly, and on point-supported boxes the
            # solution and the reactions' equilibrium move by percents
            # (tests/test_torch_solid.py measures both schemes).
            op64 = StructuredSolidOperator.from_mesh(
                self.mesh, self.E, self.v, weight=self.weight, dtype=np.float64,
                device=dev).with_free_mask(m_int)
            res = pcg_mixed(op64.apply_constrained, f_int, precond, tol=self.cg_tol,
                            maxiter=10000)
            method += "_mixed"
        else:
            op64 = op
            res = pcg(op.apply_constrained, f_int, M_inv_diag=precond,
                      tol=self.cg_tol, maxiter=10000)
        u_int = res.x  # float64 in both branches
        r_int = op64.apply(u_int)  # reactions r = K u, unconstrained K
        u_host = u_int.cpu().numpy()
        r_host = r_int.cpu().numpy()
        self.solve_info = {
            "method": method,
            "iterations": int(res.iterations),
            "residual": float(res.residual_norm),
            "converged": bool(res.converged),
            "precond_setup_s": round(t_pre, 3),
            "solve_s": round(time.perf_counter() - t0 - t_pre, 3),
            "structured_apply": self.structured_apply,
        }
        self.u = op.to_global(u_host)
        self._log("   - System solved.")
        self.reaction_forces = op.to_global(r_host)
        self.stage_times["solve"] = time.perf_counter() - t0

    def print_reactions(self) -> None:
        """Console reaction table + equilibrium check
        (reference: ReactionSolver.py:207-224)."""
        if self.reaction_forces is None:
            return
        self._log("\n--- Reaction Forces ---")
        total_reaction = np.zeros(3)
        for i, info in enumerate(self.fixed_nodes_info):
            n = info["node_idx"]
            r = self.reaction_forces[3 * n:3 * n + 3]
            total_reaction += r
            self._log(
                f"  Node {n} (Fix Point {i + 1}): Rx={r[0]:.4e}, Ry={r[1]:.4e}, Rz={r[2]:.4e} N")
        self._log("\n--- Force Equilibrium Check ---")
        total_applied = self._total_applied()
        self._log(f"  Sum of Applied Forces (Fx, Fy, Fz): {total_applied}")
        self._log(f"  Sum of Reaction Forces (Rx, Ry, Rz): {-total_reaction}")
        self.total_applied_force = total_applied
        self.total_reaction = total_reaction

    def _total_applied(self) -> np.ndarray:
        total = np.zeros(3)
        for item in self.force_data:
            total += [item["force_x"], item["force_y"], item["force_z"]]
        return total

    def equilibrium_residual(self) -> np.ndarray:
        """Sum of applied + sum of reactions (should be ~0)."""
        total_reaction = np.zeros(3)
        for info in self.fixed_nodes_info:
            n = info["node_idx"]
            total_reaction += self.reaction_forces[3 * n:3 * n + 3]
        return self._total_applied() + total_reaction

    def run_simulation(self, report: bool = False, report_path: str = "FEM_Report.md"):
        """Full pipeline (reference: ReactionSolver.py:226-232)."""
        if report:
            raise NotImplementedError("reports are not ported yet (ROADMAP A16)")
        self.assemble_stiffness_matrix()
        self.apply_boundary_conditions()
        self.solve()
        self.print_reactions()
        return self


# Reference-compatible alias (ReactionSolver.py:16).
ForceAnalysis = SolidReactionAnalysis
