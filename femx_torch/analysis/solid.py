"""Solid reaction-force analysis on a Tetra10 mesh (port of
femx/analysis/solid.py).

Headless equivalent of the reference's `ForceAnalysis`
(ReactionSolver.py:16-306) with the same constructor contract
(msh_file, force_data, fix_data, E, v) — a path to a Gmsh .msh file or a
Mesh — the same pipeline stages and console output, and the same outputs
(u, reactions at the snapped fix nodes, equilibrium check, negative-detJ
count). The routes are femx's, by mesh kind and DOF count:

  structured box (box_tet10) -> StructuredSolidOperator (its gather + cell
      matmul is the structured_cell_matmul CUDA kernel on the card);
      block-Jacobi PCG up to MG_DOF_THRESHOLD DOFs, StructuredMultigrid PCG
      above it
  unstructured, > DENSE_DOF_LIMIT DOFs -> SolidOperatorTG (its row gathers
      are the take_rows CUDA kernel), or by unstructured_operator= the
      group-ELL (femx's FEMX_GROUPELL_MAX_BLOCKS cap falls back to TG) or
      the cluster operator (their row gathers the same kernel);
      block-Jacobi PCG, or above MG_DOF_THRESHOLD the LatticePreconditioner
      (StructuredMultigrid on an auxiliary lattice)
  up to DENSE_DOF_LIMIT DOFs (or solver="dense") -> dense Cholesky of the
      assembled K (solver="cg": block-Jacobi PCG on the generic operator)

With dtype=float32 the structured and unstructured matrix-free routes run
float64 CG on an operator of the same kind assembled in float64 from the
mesh, preconditioned in float32 (methods "*_pcg_mixed"); the group-ELL and
cluster routes find their block structure once, sum the blocks in float64
and keep that operator beside its float32 cast. femx instead refines in
float64 against the float32 operator cast up, which carries the
float32-rounded geometry into the solution: on point-supported boxes it misses the equilibrium of
the float64 operator (tests/test_torch_solid.py,
tests/test_torch_f32_witness.py). The small-mesh routes solve in float64
whatever dtype says. Reactions are r = K u with the unconstrained float64
operator.

Beyond the static solve, as in femx: `modal` (shift-invert Lanczos with
the stored preconditioner's inner solves, HRZ-lumped mass, optional
Rayleigh-Ritz refinement through accurate solves), `compute_stresses`
(element-averaged Gauss-point stresses averaged to nodes, von Mises),
`solve_cases` (more load cases through the stored operator and
preconditioner) and `checkpoint=` (the matrix-free solves in
`checkpoint_chunk`-iteration segments persisted to a file that a later run
resumes from; femx_torch.checkpoint). The float32 routes refine modes,
solve load cases and checkpoint their solves on the float64-assembled
operator with the float32 preconditioner (pcg_mixed), not on the float32
operator (cast up) as femx does, for the reason above.

devices=N (femx/analysis/solid.py:467-474, 798-1050, 1130-1339) runs the
analysis on every rank of an N-rank process group (femx_torch.parallel.
launch; femx drives N devices from one process): the z-slab halo MG-PCG on a
structured box, the sharded TG operator with the distributed lattice MG on
an unstructured mesh, and solve_cases and modal through them; outside such
a group it raises ValueError naming the launcher.

Everything runs on `device` (None = CUDA; without CUDA it raises unless the
caller passes device="cpu"), in `dtype` (None = config.default_dtype(),
float64 unless FEMX_DTYPE says otherwise).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from femx_torch import bc as bc_mod
from femx_torch import checkpoint as ckpt
from femx_torch.assembly import SolidOperator, assemble_dense, dof_map
from femx_torch.assembly_cluster import SolidOperatorCluster
from femx_torch.assembly_groupell import SolidOperatorGroupELL
from femx_torch.assembly_soa import BlockJacobiPrecond, SolidOperatorSoA
from femx_torch.assembly_structured import (StructuredBlockJacobi, StructuredSolidOperator,
                                            resolve_apply_form, conv_routing_active)
from femx_torch.assembly_tg import SolidOperatorTG
from femx_torch.config import (DEFAULT_COMPAT, ReferenceCompat, default_dtype,
                               numpy_dtype, resolve_device, torch_dtype)
from femx_torch.elements import tet10 as tet10_el
from femx_torch.elements.tet10 import material_matrix
from femx_torch.mesh.core import Mesh, nodes_in_physical_group
from femx_torch.mesh.msh_io import read_msh
from femx_torch.modal import ModalResult, modal_shift_invert, shift_invert_refine
from femx_torch.profiling import span, timed
from femx_torch.solve.cg import pcg, pcg_mixed
from femx_torch.solve.dense import solve_dense
from femx_torch.solve.lattice_precond import LatticePreconditioner
from femx_torch.solve.multigrid import StructuredMultigrid


# the unstructured matrix-free operators, which run in an internal node order
_INTERNAL_OPS = (SolidOperatorTG, SolidOperatorGroupELL, SolidOperatorCluster)


def nodal_stresses(points, conn, u, C, device=None, chunk: int = 65536):
    """Per-node averaged stress tensors and von Mises field, float64.

    Voigt stresses at the 4 Gauss points of every element, averaged per
    element, then averaged to the nodes with element-count weighting (the
    reference's nodal smoothing for beams, BeamSolver.py:420-438), summed
    on `device` with index_add_ over chunks of `chunk` elements (the
    Jacobian data of 331,776 elements is ~320 MB in float64).

    points (N, 3), conn (E, 10), u (3N,) host arrays; C (6, 6).
    Returns host numpy (nodal_stress (N, 6), nodal_von_mises (N,)).
    """
    dev = resolve_device(device)
    f64 = torch.float64
    pts = torch.as_tensor(np.asarray(points), dtype=f64, device=dev)
    conn_t = torch.as_tensor(np.asarray(conn), dtype=torch.int64, device=dev)
    u3 = torch.as_tensor(np.asarray(u), dtype=f64, device=dev).reshape(-1, 3)
    Ct = torch.as_tensor(np.asarray(C), dtype=f64, device=dev)
    nodal = torch.zeros((pts.shape[0], 6), dtype=f64, device=dev)
    for e0 in range(0, conn_t.shape[0], chunk):
        c = conn_t[e0:e0 + chunk]
        dN, _, _ = tet10_el.jacobians(pts[c])
        _, stress = tet10_el.element_strain_stress(dN, Ct, u3[c])
        es = stress.mean(dim=1)  # (e, 6) element average
        for k in range(10):
            nodal.index_add_(0, c[:, k], es)
    counts = torch.bincount(conn_t.reshape(-1), minlength=pts.shape[0]).to(f64)
    nodal /= counts.clamp(min=1.0)[:, None]
    return nodal.cpu().numpy(), tet10_el.von_mises(nodal).cpu().numpy()


class SolidReactionAnalysis:
    """3D solid elasticity with point loads/fixes and reaction recovery."""

    DENSE_DOF_LIMIT = 6000  # below: dense Cholesky; above: matrix-free PCG
    MG_DOF_THRESHOLD = 150_000  # above: multigrid (structured or lattice) PCG
    # total CG iterations of a checkpointed solve, resumed ones included
    CHECKPOINT_MAXITER = 50_000

    def __init__(
        self,
        msh_file: Union[str, Mesh],
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
        checkpoint_chunk: int = 500,
        unstructured_operator: Optional[str] = None,
        structured_apply: Optional[str] = None,
        device=None,
    ):
        uop = unstructured_operator or os.environ.get("FEMX_UNSTRUCTURED_OP", "tg")
        if uop not in ("tg", "cluster", "groupell"):
            raise ValueError("unstructured_operator must be 'tg', 'cluster' or "
                             f"'groupell', got {uop!r}")
        if (devices or 0) > 1:
            # femx drives N devices from one process; here the analysis runs
            # on every rank of an N-rank group (femx_torch.parallel.launch)
            from femx_torch.parallel import comm

            comm.require_world(int(devices))
        if solver not in ("auto", "mg", "cg", "dense"):
            raise ValueError(f"solver must be 'auto', 'mg', 'cg' or 'dense', got {solver!r}")
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
        self.unstructured_operator = uop
        self.devices = devices
        # the structured apply form, "slot" or "conv" (femx_torch.assembly_conv),
        # kept on the analysis and handed to the operators it builds; femx
        # writes it into os.environ and clears jax's caches instead
        # (femx/analysis/solid.py:259-274)
        self.structured_apply = resolve_apply_form(structured_apply)
        # checkpoint=PATH: the structured and transpose-gather solves run in
        # `checkpoint_chunk`-iteration CG segments, persisting (x, iterations)
        # to PATH between them; a later analysis on the same PATH resumes
        self.checkpoint = checkpoint
        self.checkpoint_chunk = int(checkpoint_chunk)

        self.pd = 3
        self.u: Optional[np.ndarray] = None
        self.f: Optional[np.ndarray] = None
        self.reaction_forces: Optional[np.ndarray] = None
        self.fixed_nodes_info: List[dict] = []
        self.applied_forces_info: List[dict] = []
        self.negative_detJ_count = 0
        self.operator = None
        self.solve_info: dict = {}
        self.stage_times: dict = {}
        self._precond = None  # what solve() preconditioned with (None: dense)
        self._op64 = None  # the float64 operator of the solve (float32 routes: assembled in f64)
        self._assembled64 = None  # group-ELL / cluster: the float64 build the operator casts
        self._dist_solver = None  # devices=N: the distributed solver of solve()

        self._read_mesh()
        self.C = material_matrix(self.E, self.v)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def _read_mesh(self) -> None:
        self._log("1. Reading mesh file...")
        with timed("solid.read_mesh", self.device) as t:
            self.mesh = (self.msh_file if isinstance(self.msh_file, Mesh)
                         else read_msh(self.msh_file))
            self.points = self.mesh.points
            self.num_nodes = len(self.points)
            self.tetra10_conn = self.mesh.cells.get("tetra10")
            if self.tetra10_conn is None:
                raise ValueError("Mesh has no 'tetra10' elements.")
            self.diri_nodes = nodes_in_physical_group(self.mesh, "Diri_BCs", "vertex")
            self.neumann_nodes = nodes_in_physical_group(self.mesh, "Neumann_BCs", "vertex")
        self.stage_times["read_mesh"] = t.seconds
        self._log(f"   - Nodes: {self.num_nodes}, Tetra10 Elements: {len(self.tetra10_conn)}")

    @property
    def weight(self) -> float:
        return self.compat.tet10_gauss_weight

    def assemble_stiffness_matrix(self) -> None:
        """Build the matrix-free operator (and count bad Jacobians).

        Structured box meshes get the gather-free lattice operator (its
        cells are affine images of the unit Kuhn subdivision: every Jacobian
        is positive by construction); large unstructured meshes the
        transpose-gather operator in the analysis dtype (femx's); small ones
        the generic float64 operator."""
        self._log("2. Assembling global stiffness operator (matrix-free)...")
        with timed("solid.assemble", self.device) as t:
            self._assemble()
        self.stage_times["assemble"] = t.seconds
        self._log("   - Assembly complete.")

    def _assemble(self) -> None:
        dtype = np.dtype(self.dtype or numpy_dtype(default_dtype()))
        self._structured = self.mesh.structured is not None and self.solver != "dense"
        if self._structured:
            self.operator = StructuredSolidOperator.from_mesh(
                self.mesh, self.E, self.v, weight=self.weight, dtype=dtype,
                device=self.device, apply_form=self.structured_apply)
            self.negative_detJ_count = 0
        else:
            if self.solver != "dense" and 3 * self.num_nodes > self.DENSE_DOF_LIMIT:
                op, detJ = self._assemble_unstructured(dtype)
            else:
                op, detJ = SolidOperator.from_mesh(
                    self.points, self.tetra10_conn, self.C, weight=self.weight,
                    dtype=np.float64, device=self.device)
            self.operator = op
            self.negative_detJ_count = int((detJ <= 1e-12).sum())

    def _assemble_unstructured(self, dtype: np.dtype):
        """The large-mesh operator by unstructured_operator (femx/analysis/
        solid.py:337-380): group-ELL (TG above the FEMX_GROUPELL_MAX_BLOCKS
        cap on its estimated 8.7 blocks per element, as femx), cluster, or
        TG. Group-ELL and cluster are built in float64 (kept as
        _assembled64) and cast to a float32 analysis' dtype. Returns (op,
        detJ)."""
        kw = dict(weight=self.weight, device=self.device)
        uop = self.unstructured_operator
        if uop == "groupell":
            max_blocks = int(os.environ.get("FEMX_GROUPELL_MAX_BLOCKS", "4500000"))
            est_blocks = int(8.7 * len(self.tetra10_conn))
            if est_blocks > max_blocks:
                self._log(f"   - group-ELL estimated {est_blocks} blocks > cap {max_blocks}; "
                          "using the TG operator (FEMX_GROUPELL_MAX_BLOCKS raises the cap).")
                uop = "tg"
        if uop == "tg":
            return SolidOperatorTG.from_mesh(self.points, self.tetra10_conn, self.E, self.v,
                                             dtype=dtype, **kw)
        if uop == "groupell":
            op64, detJ = SolidOperatorGroupELL.from_mesh(
                self.points, self.tetra10_conn, self.E, self.v, dtype=np.float64,
                kb_dtype=np.float64, **kw)
        else:
            op64, detJ = SolidOperatorCluster.from_mesh(
                self.points, self.tetra10_conn, self.E, self.v, dtype=np.float64, **kw)
        self._assembled64 = op64
        return (op64.cast(dtype) if uop == "groupell" else op64.astype(dtype)), detJ

    def apply_boundary_conditions(self) -> None:
        self._log("3. Applying point-based boundary conditions...")
        with timed("solid.bc", self.device) as t:
            self._apply_bc()
        self.stage_times["bc"] = t.seconds

    def _apply_bc(self) -> None:
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

    def solve(self) -> None:
        self._log("4. Solving the linear system...")
        with timed("solid.solve", self.device) as t:
            t_out = self._solve()
        self.stage_times["solve"] = t.seconds
        if t_out is not None:
            self.solve_info["solve_s"] = round(t.seconds - t_out, 3)

    def _solve(self) -> Optional[float]:
        """The route's solve; returns the seconds of the stage that solve_s
        leaves out (the preconditioner set-up; on the unstructured routes the
        reactions too; 0 for devices=N), or None for the small-mesh routes,
        whose solve_info has no solve_s."""
        if (self.devices or 0) > 1 and self._solve_distributed():
            return 0.0
        if not self._structured:
            t_pre = None
            if isinstance(self.operator, _INTERNAL_OPS):
                t_pre = self._solve_unstructured()
            else:
                self._solve_small()
            self._single_device_after_fallback()
            self._log("   - System solved.")
            return t_pre
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
        with timed("solid.precond_setup", dev) as pre:
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
                precond = StructuredBlockJacobi(op)
                method = "structured_block_jacobi_pcg"
            self.operator = op
            self._precond = precond
            f_int = torch.as_tensor(op.to_internal(self.f * mask_g), device=dev)  # f64

        with span("solid.op64"):
            if dtype == np.float32:
                # f64 CG on the f64-assembled operator, preconditioned in f32.
                # femx runs f32 CG with f64 refinement against the f32 cell
                # matrix cast up; that matrix no longer annihilates rigid
                # translations exactly, and on point-supported boxes the
                # solution and the reactions' equilibrium move by percents
                # (tests/test_torch_solid.py measures both schemes).
                op64 = StructuredSolidOperator.from_mesh(
                    self.mesh, self.E, self.v, weight=self.weight, dtype=np.float64,
                    device=dev, apply_form=self.structured_apply).with_free_mask(m_int)
                method += "_mixed"
            else:
                op64 = op
        self._op64 = op64
        with span("solid.cg"):
            res, resumed = self._run_cg(op64, f_int, precond, mixed=dtype == np.float32)
        u_int = res.x  # float64 in both branches
        with span("solid.reactions"):
            r_int = op64.apply(u_int)  # reactions r = K u, unconstrained K
            u_host = u_int.cpu().numpy()
            r_host = r_int.cpu().numpy()
        self.solve_info = self._solve_info(method, res, resumed, pre.seconds)
        # the form that ran (the request is gated by size and layer weights)
        self.solve_info["structured_apply"] = "conv" if conv_routing_active(op) else "slot"
        self._single_device_after_fallback()
        self.u = op.to_global(u_host)
        self._log("   - System solved.")
        self.reaction_forces = op.to_global(r_host)
        return pre.seconds

    def _run_cg(self, op64, f, precond, mixed: bool):
        """The CG of the matrix-free routes: float64 CG on op64, with the
        float32 preconditioner through pcg_mixed when `mixed`; with
        checkpoint= in chunks persisted to the file (femx's _solve_chunked).
        Returns (CGResult, iterations resumed from the file, or None without
        checkpoint=)."""
        def run(fv, maxiter, x0=None, r0=None, p0=None):
            if mixed:
                return pcg_mixed(op64.apply_constrained, fv, precond, tol=self.cg_tol,
                                 maxiter=maxiter, x0=x0, r0=r0, p0=p0)
            return pcg(op64.apply_constrained, fv, M_inv_diag=precond, x0=x0,
                       tol=self.cg_tol, maxiter=maxiter, r0=r0, p0=p0)

        if not self.checkpoint:
            return run(f, 10000), None
        arrays, meta = ckpt.load_state(self.checkpoint)
        resumed = int((meta or {}).get("iterations", 0)) if arrays is not None else 0
        res = ckpt.pcg_checkpointed(
            op64.apply_constrained, f, tol=self.cg_tol, maxiter=self.CHECKPOINT_MAXITER,
            chunk=self.checkpoint_chunk, checkpoint_path=self.checkpoint,
            verbose=self.verbose,
            solve_chunk=lambda fv, x0, r0, p0: run(fv, self.checkpoint_chunk, x0, r0, p0))
        return res, resumed

    def _solve_info(self, method, res, resumed, t_pre) -> dict:
        """solve()'s record; solve() adds solve_s, the solve stage less the
        preconditioner set-up t_pre (and on the unstructured routes less the
        reactions), once the stage has ended."""
        info = {
            "method": method if resumed is None else method + "_checkpointed",
            "iterations": int(res.iterations),
            "residual": float(res.residual_norm),
            "converged": bool(res.converged),
            "precond_setup_s": round(t_pre, 3),
            # requested form: on the unstructured routes it reaches only the
            # lattice preconditioner's structured levels, each gated
            "structured_apply": self.structured_apply,
        }
        if resumed is not None:
            info.update(checkpoint=self.checkpoint, resumed_iterations=resumed)
        return info

    def _solve_unstructured(self) -> float:
        """The unstructured matrix-free routes (femx/analysis/solid.py:
        640-767): TG, group-ELL or cluster, with block-Jacobi PCG, or the
        lattice-MG preconditioner above MG_DOF_THRESHOLD DOFs; float32 runs
        float64 CG on the operator of the same kind assembled in float64,
        preconditioned in float32, as the structured route does. Returns the
        seconds of the preconditioner set-up and the reactions, which
        solve_s leaves out."""
        mask_g = self.constraints.free_mask()
        m_int = self.operator.to_internal(mask_g)
        op = self.operator.with_free_mask(m_int)
        self.operator = op
        tag = ("groupell" if isinstance(op, SolidOperatorGroupELL) else
               "cluster" if isinstance(op, SolidOperatorCluster) else "tg")
        f64_int = torch.as_tensor(op.to_internal(self.f * mask_g), device=self.device)
        with timed("solid.precond_setup", self.device) as pre:
            if tag == "tg":
                bj_data = op.soa.block_jacobi_tensors()
                bj_fn = SolidOperatorSoA.apply_block_jacobi
            else:
                bj_data, bj_fn = op.block_jacobi_tensors(), type(op).apply_block_jacobi
            precond = None
            prefix = f"{tag}_block_jacobi"
            if 3 * self.num_nodes > self.MG_DOF_THRESHOLD:
                # auxiliary structured-lattice MG coarse correction: cuts
                # block-Jacobi's O(1000) iterations by an order of magnitude
                try:
                    precond = LatticePreconditioner(
                        self.points, self.tetra10_conn, self.E, self.v, mask_g,
                        dtype=numpy_dtype(op.dtype).type, node_perm=op.new_of_old,
                        bj_fn=bj_fn, bj_data=bj_data, n_caller=getattr(op, "n_pad", None),
                        device=self.device, structured_apply=self.structured_apply)
                    prefix = f"{tag}_lattice_mg"
                except ValueError as e:
                    self._log(f"   - Lattice preconditioner unavailable ({e}); "
                              "using block-Jacobi.")
            if precond is None:
                precond = (BlockJacobiPrecond(bj_data) if tag == "tg"
                           else functools.partial(bj_fn, bj_data))
            self._precond = precond
        mixed = op.dtype == torch.float32
        with span("solid.op64"):
            if not mixed:
                op64 = op
            elif tag == "tg":
                # f64 CG on the TG operator assembled in f64 from the mesh,
                # preconditioned in f32. femx refines against op.astype(float64)
                # (femx/analysis/solid.py:722), whose f32-rounded geometry factors
                # move the solution off the f64 operator's equilibrium
                # (tests/test_torch_f32_witness.py).
                op64, _ = SolidOperatorTG.from_mesh(
                    self.points, self.tetra10_conn, self.E, self.v, weight=self.weight,
                    dtype=np.float64, device=self.device)
                op64 = op64.with_free_mask(m_int)
            else:
                # the float64 build the float32 operator was cast from
                op64 = self._assembled64.with_free_mask(m_int)
        self._op64 = op64
        with span("solid.cg"):
            res, resumed = self._run_cg(op64, f64_int, precond, mixed)
        method = prefix + ("_pcg_mixed" if mixed else "_pcg")
        self.solve_info = self._solve_info(method, res, resumed, pre.seconds)
        with timed("solid.reactions") as reac:  # ends on its host copies
            self.u = op.to_global(res.x.cpu().numpy())
            self.reaction_forces = op.to_global(op64.apply(res.x).cpu().numpy())
        return pre.seconds + reac.seconds

    def _solve_small(self) -> None:
        """The generic-operator route (femx/analysis/solid.py:769-796):
        dense Cholesky of the assembled K up to DENSE_DOF_LIMIT DOFs (or
        solver="dense"), else block-Jacobi PCG; both in float64."""
        ndof = 3 * self.num_nodes
        op = self.operator.with_free_mask(self.constraints.free_mask())
        self.operator = op
        f = torch.as_tensor(self.f, dtype=op.dtype, device=self.device)
        self._op64 = op
        if self.solver == "dense" or (self.solver == "auto" and ndof <= self.DENSE_DOF_LIMIT):
            K = assemble_dense(op.element_stiffness(), dof_map(op.conn, 3), ndof)
            u = solve_dense(K, f, free_mask=op.free_mask)
            self.solve_info = {"method": "dense_cholesky"}
        else:
            precond = op.block_jacobi_preconditioner()
            self._precond = precond
            res = pcg(op.apply_constrained, f * op.free_mask, M_inv_diag=precond,
                      tol=self.cg_tol)
            u = res.x
            self.solve_info = {
                "method": "block_jacobi_pcg",
                "iterations": int(res.iterations),
                "residual": float(res.residual_norm),
                "converged": bool(res.converged),
            }
        self.u = u.cpu().numpy()
        self.reaction_forces = op.apply(u).cpu().numpy()

    def _single_device_after_fallback(self) -> None:
        """A devices=N analysis that fell back to one device says so."""
        if (self.devices or 0) > 1:
            self.solve_info["devices"] = 1

    def _solve_distributed(self) -> bool:
        """devices=N (femx/analysis/solid.py:798-830, 958-1050): the z-slab
        halo MG-PCG on a structured box (femx_torch.parallel.driver), or the
        sharded TG operator with the distributed lattice MG on an
        unstructured mesh (femx_torch.parallel.tg_lattice), on every rank of
        the group; each rank ends with the full u and the reactions, r = K u
        through the float64 operator of the solve (structured: the solver's
        padded one). Returns False, with
        femx's log line, when the problem cannot be slab-distributed: solve()
        then takes the single-device route and solve_info["devices"] is 1.
        float32 analyses run float64 CG on the float64-assembled operator
        with the float32 preconditioner, as the single-device routes do."""
        from femx_torch.parallel import comm

        mask_g = np.asarray(self.constraints.free_mask(), dtype=np.float64)
        dtype = numpy_dtype(self.operator.dtype)
        m_int = self.operator.to_internal(mask_g) if not isinstance(
            self.operator, SolidOperator) else mask_g
        if self._structured:
            from femx_torch.parallel.driver import DistributedStructuredSolver

            info = self.mesh.structured
            try:
                solver = DistributedStructuredSolver(
                    info.n_cells, info.spacing, self.E, self.v, mask_g, weight=self.weight,
                    dtype=dtype, devices=self.devices, device=self.device,
                    apply_form=self.structured_apply)
            except ValueError as e:
                self._log(f"   - Distributed solve unavailable ({e}); "
                          "using the single-device path.")
                return False
            u, dinfo = solver.solve(self.f, tol=self.cg_tol, checkpoint_path=self.checkpoint,
                                    checkpoint_chunk=self.checkpoint_chunk,
                                    checkpoint_maxiter=self.CHECKPOINT_MAXITER)
            op = self.operator.with_free_mask(m_int)
            op64 = op if dtype == np.float64 else None  # float32: built if modal refines
            self._precond = StructuredBlockJacobi(op)
            dinfo["structured_apply"] = "conv" if conv_routing_active(op) else "slot"
            reactions = solver.reactions(u)
        else:
            if not isinstance(self.operator, SolidOperatorTG):
                self._log("   - devices= requested but the generic operator is in use; "
                          "single-device path.")
                return False
            from femx_torch.parallel.tg_lattice import DistributedUnstructuredSolver

            try:
                solver = DistributedUnstructuredSolver.build(
                    self.points, self.tetra10_conn, self.E, self.v, mask_g, dtype=dtype,
                    device=self.device, weight=self.weight)
            except ValueError as e:
                self._log(f"   - Distributed unstructured solve unavailable ({e}); "
                          "using the single-device path.")
                return False
            u, it, res, ok = solver.solve(self.f * mask_g, tol=self.cg_tol, maxiter=10000)
            dinfo = {"method": "tg_distributed_lattice_mg_pcg"
                               + ("_mixed" if dtype == np.float32 else ""),
                     "iterations": int(it), "residual": float(res), "converged": bool(ok),
                     "devices": int(self.devices), "lattice_cells": tuple(solver.n_cells),
                     "distributed_levels": solver.dmg.n_dist, "backend": comm.backend()}
            op = self.operator.with_free_mask(m_int)
            if dtype == np.float64:
                op64 = op
            else:
                op64, _ = SolidOperatorTG.from_mesh(
                    self.points, self.tetra10_conn, self.E, self.v, weight=self.weight,
                    dtype=np.float64, device=self.device)
                op64 = op64.with_free_mask(m_int)
            self._precond = BlockJacobiPrecond(op.soa.block_jacobi_tensors())
            u_int = torch.as_tensor(op.to_internal(np.asarray(u)), device=self.device)
            reactions = op.to_global(op64.apply(u_int).cpu().numpy())
        self.operator, self._op64, self._dist_solver = op, op64, solver
        self.solve_info = dinfo
        self.u = np.asarray(u)
        self.reaction_forces = reactions
        self._log(f"   - System solved on {dinfo['devices']} devices ({dinfo['method']}, "
                  f"{dinfo['iterations']} iterations).")
        return True

    def _stored_precond(self):
        """The preconditioner of solve(), and the CG iteration cap femx
        gives it in solve_cases: 10,000 for the multigrid and lattice
        preconditioners, 20,000 for block-Jacobi. The dense route stored
        none: the generic operator's block-Jacobi (femx:1361-1365)."""
        pre = self._precond
        if isinstance(pre, (StructuredMultigrid, LatticePreconditioner)):
            return pre, 10000
        if pre is None:
            pre = self.operator.block_jacobi_preconditioner()
        return pre, 20000

    def solve_cases(self, force_cases, tol: Optional[float] = None) -> np.ndarray:
        """Solve K u = f_k for several independent load cases, reusing the
        operator and the preconditioner that solve() built; the cases run
        one after another (femx: one compiled lax.map over the same
        per-case solve).

        Args:
          force_cases: list of force_data lists (the constructor's format);
            the fixes stay those of the analysis.
          tol: relative residual per case (default: the analysis cg_tol).
        Returns (n_cases, 3N) float64 displacements in global DOF order;
        per-case iterations/residuals are stored as self.case_solve_info.

        float32 analyses solve their cases as solve() does: float64 CG on the
        float64-assembled operator with the float32 preconditioner. femx runs
        float32 CG on the float32 operator, floored at 1e-5, whose answers
        miss the float64 solution by percents on point-supported boxes
        (ROADMAP Queue 3; tests/test_torch_solid_extras.py).
        """
        if self.u is None:
            raise RuntimeError("Run the analysis (solve) before solve_cases().")
        op = self.operator  # free mask set by solve()
        mixed = torch_dtype(op.dtype) == torch.float32
        t = float(self.cg_tol if tol is None else tol)
        mask_g = self.constraints.free_mask()
        # the generic operator works in global DOF order directly
        to_int = getattr(op, "to_internal", lambda v: v)
        to_glob = getattr(op, "to_global", lambda v: v)
        if self._dist_solver is not None:
            return self._solve_cases_distributed(force_cases, t, mask_g)
        pre, maxiter = self._stored_precond()
        us, infos = [], []
        for case in force_cases:
            with span("solid.case"):
                fg = bc_mod.solid_point_loads(self.mesh, case, self.neumann_nodes)[0] * mask_g
                f = torch.as_tensor(to_int(fg), dtype=torch.float64, device=self.device)
                with span("solid.cg"):
                    if mixed:
                        r = pcg_mixed(self._op64.apply_constrained, f, pre, tol=t,
                                      maxiter=maxiter)
                    else:
                        r = pcg(op.apply_constrained, f, M_inv_diag=pre, tol=t,
                                maxiter=maxiter)
                us.append(to_glob(r.x.cpu().numpy()))
            infos.append({"iterations": int(r.iterations), "residual": float(r.residual_norm),
                          "converged": bool(r.residual_norm <= t)})
        self.case_solve_info = infos
        return np.stack(us)

    def _solve_cases_distributed(self, force_cases, t: float, mask_g) -> np.ndarray:
        """devices=N load cases through the distributed solver solve() built
        (femx/analysis/solid.py:876-903), one after another."""
        solver = self._dist_solver
        us, infos = [], []
        for case in force_cases:
            with span("solid.case"):
                fg = bc_mod.solid_point_loads(self.mesh, case, self.neumann_nodes)[0] * mask_g
                with span("solid.cg"):
                    if self._structured:
                        u, dinfo = solver.solve(fg, tol=t)
                        it, rn, ok = dinfo["iterations"], dinfo["residual"], dinfo["converged"]
                    else:
                        u, it, rn, ok = solver.solve(fg, tol=t, maxiter=10000)
                us.append(np.asarray(u))
            infos.append({"iterations": int(it), "residual": float(rn), "converged": bool(ok)})
        self.case_solve_info = infos
        return np.stack(us)

    def compute_stresses(self):
        """Per-node averaged stress tensors + von Mises field (postprocess):
        Voigt stresses at the 4 Gauss points of every element, averaged per
        element and then to the nodes (`nodal_stresses`, on the analysis'
        device). Returns (nodal_stress (N, 6), nodal_von_mises (N,)), host
        float64, also stored as self.nodal_stress / self.nodal_von_mises."""
        if self.u is None:
            raise RuntimeError("Run the analysis first.")
        nodal, vm = nodal_stresses(self.points, self.tetra10_conn, self.u, self.C,
                                   device=self.device)
        self.nodal_stress = nodal
        self.nodal_von_mises = vm
        return nodal, vm

    def _lumped_mass(self, rho: float) -> np.ndarray:
        """(3N,) HRZ-lumped mass diagonal in the operator's layout (host
        float64): the structured operator's own, else element_mass_lumped
        summed to the nodes on the device."""
        op = self.operator
        if self._structured:
            return op.lumped_mass_diagonal(rho)
        conn = torch.as_tensor(np.asarray(self.tetra10_conn), dtype=torch.int64,
                               device=self.device)
        pts = torch.as_tensor(np.asarray(self.points), dtype=torch.float64, device=self.device)
        ml = tet10_el.element_mass_lumped(pts[conn], rho)  # (E, 10)
        m_node = torch.zeros(self.num_nodes, dtype=torch.float64, device=self.device)
        m_node.index_add_(0, conn.reshape(-1), ml.reshape(-1))
        m_dof = np.repeat(m_node.cpu().numpy(), 3)
        return op.to_internal(m_dof) if isinstance(op, _INTERNAL_OPS) else m_dof

    def modal(self, n_modes: int = 10, rho: float = 7850.0, tol: float = 1e-6,
              maxiter: int = 100, inner_tol: Optional[float] = None,
              refine: bool = False) -> ModalResult:
        """First n_modes natural frequencies/shapes of the constrained solid.

        Mass is HRZ-lumped Tet10 (exact element totals); the eigensolver is
        shift-invert Lanczos (femx_torch.modal) whose inner K-solves are PCG
        on the analysis' operator, in its dtype, with the preconditioner
        solve() built (inner_tol default max(cg_tol, 1e-6), at most 4,000
        iterations each).

        refine=True then runs shift_invert_refine: one inverse-iteration
        step + Rayleigh-Ritz through accurate solves (2 * n_modes of them):
        float64 operators PCG to 1e-11 (at most 6,000 iterations); float32
        operators float64 CG to 1e-9 on the float64-assembled operator with
        the float32 preconditioner (pcg_mixed; femx refines against the
        float32 operator cast up); the small-mesh operator the inner solve.
        The per-mode relative-eigenvalue Ritz bounds go to
        self.modal_error_bounds.

        Requires solve(). Returns ModalResult with omega (rad/s, ascending)
        and mass-orthonormal mode shapes in global (3*node+comp) DOF order,
        also stored as self.modal_result; the Lanczos and inner iteration
        counts are in self.modal_info.
        """
        if self.u is None:
            raise RuntimeError("Run the analysis (solve) before modal().")
        op = self.operator
        if isinstance(op, SolidOperatorGroupELL):
            raise NotImplementedError(
                "modal() has no group-ELL branch: femx's SolidReactionAnalysis.modal leaves "
                "the group-ELL operator out of its unstructured branch (is_tg, "
                "femx/analysis/solid.py:1297) and fails reading op.dN, so there is no "
                "reference to hold it to; use unstructured_operator='tg' or 'cluster'")
        if inner_tol is None:
            inner_tol = max(self.cg_tol, 1e-6)
        m_use = self._lumped_mass(rho)
        free = (op.free_mask_host if self._structured
                else op.free_mask.cpu().numpy().astype(np.float64))
        pre, _ = self._stored_precond()
        dmg = self._modal_dmg() if self._structured and (self.devices or 0) > 1 else None
        dist_u = (not self._structured and self._dist_solver is not None and not refine)
        if dmg is not None:
            from femx_torch.parallel.modal import modal_shift_invert_halo

            res = modal_shift_invert_halo(dmg, m_use, free, n_modes=n_modes, tol=tol,
                                          maxiter=maxiter, inner_tol=inner_tol)
        elif dist_u:
            res = modal_shift_invert(self._unstructured_k_solve(inner_tol), m_use, free,
                                     n_modes=n_modes, tol=tol, maxiter=maxiter,
                                     dtype=op.dtype, device=self.device)
        else:
            res = modal_shift_invert(None, m_use, free, n_modes=n_modes, tol=tol,
                                     maxiter=maxiter,
                                     solver_state=(op, pre, float(inner_tol), 4000))
        self.modal_info = {"iterations": res.iterations,
                           "inner_iterations": res.inner_iterations,
                           "refine_iterations": None}
        if refine:
            if dmg is not None:
                ks_acc = self._halo_accurate_solve(dmg)
            elif not (self._structured or isinstance(op, _INTERNAL_OPS)):
                def ks_acc(b):  # the small-mesh operator: the inner solve (femx)
                    return pcg(op.apply_constrained, b, M_inv_diag=pre, tol=inner_tol,
                               maxiter=4000)
            elif torch_dtype(op.dtype) == torch.float32:
                op64 = self._float64_operator()

                def ks_acc(b):
                    return pcg_mixed(op64.apply_constrained, b, pre, tol=1e-9, maxiter=6000)
            else:
                def ks_acc(b):
                    return pcg(op.apply_constrained, b, M_inv_diag=pre, tol=1e-11,
                               maxiter=6000)
            res = self._refine_modal(res, ks_acc, m_use)
        if self._structured or isinstance(op, _INTERNAL_OPS):
            modes = res.modes.cpu().numpy()
            modes = np.stack([op.to_global(modes[:, i]) for i in range(modes.shape[1])],
                             axis=1)
            res = res._replace(modes=torch.as_tensor(modes, device=self.device))
        self.modal_result = res
        where = f" ({self.devices} devices)" if dmg is not None or dist_u else ""
        self._log(f"   - Modal{where}: f = "
                  + ", ".join(f"{w / (2 * np.pi):.3f}" for w in res.omega.cpu().numpy())
                  + " Hz")
        if refine:
            self._log("   - Refined (Ritz bound max "
                      f"{float(np.max(self.modal_error_bounds)):.1e} on the "
                      "relative eigenvalue error)")
        return res

    def _modal_dmg(self):
        """The distributed V-cycle over the analysis' own operator for
        devices=N modal (femx/analysis/solid.py:1130-1160), or None with
        femx's log line when the lattice cannot be slab-distributed
        unpadded (the inner solves then run on one device)."""
        from femx_torch.parallel.halo import DistributedMultigrid

        info = self.mesh.structured
        try:
            mg = StructuredMultigrid(None, info.n_cells, self.E, self.v,
                                     self.constraints.free_mask(), weight=self.weight,
                                     dtype=self.operator.dtype.type, fine_op=self.operator,
                                     spacing=info.spacing, device=self.device)
            return DistributedMultigrid(mg)
        except ValueError as e:
            self._log(f"   - Distributed modal unavailable ({e}); single-device inner solves.")
            return None

    def _float64_operator(self):
        """The float64 operator of the solve; a float32 structured devices=N
        solve kept none unpadded, so it is assembled here at first need."""
        if self._op64 is None:
            self._op64 = StructuredSolidOperator.from_mesh(
                self.mesh, self.E, self.v, weight=self.weight, dtype=np.float64,
                device=self.device, apply_form=self.structured_apply).with_free_mask(
                    self.operator.free_mask_host)
        return self._op64

    def _halo_accurate_solve(self, dmg):
        """refine=True's accurate solves on the ranks: float64 operators
        pcg_halo to 1e-11; float32 ones float64 CG to 1e-9 on the halo apply
        of the float64-assembled operator with the float32 distributed
        V-cycle (femx casts its float32 operator up, solid.py:1167)."""
        from femx_torch.parallel.halo import HaloStructuredOperator, pcg_halo
        from femx_torch.solve.cg import CGResult

        if self.operator.dtype == np.float32:
            halo, tol, low = (HaloStructuredOperator(self._float64_operator()), 1e-9,
                              torch.float32)
        else:
            halo, tol, low = dmg.halo, 1e-11, None

        def ks_acc(b):
            x, it, rn, ok = pcg_halo(halo, b, tol=tol, maxiter=6000, preconditioner=dmg,
                                     low_dtype=low, as_tensor=True)
            return CGResult(x=x, iterations=it, residual_norm=rn, converged=ok)

        return ks_acc

    def _unstructured_k_solve(self, inner_tol: float):
        """The Lanczos inner solve of devices=N on a TG mesh: one distributed
        lattice-MG solve (femx/analysis/solid.py:1309-1325)."""
        op, solver = self.operator, self._dist_solver

        def k_solve(b):
            x, _it, res_i, ok_i = solver.solve(op.to_global(b.cpu().numpy()), tol=inner_tol,
                                               maxiter=10000)
            if not ok_i and not np.isfinite(res_i):
                raise RuntimeError(f"distributed inner solve diverged: {res_i}")
            return torch.as_tensor(op.to_internal(x), dtype=b.dtype, device=b.device)

        return k_solve

    def _refine_modal(self, res: ModalResult, ks_acc, m_diag) -> ModalResult:
        """Inverse-iteration + Rayleigh-Ritz refinement of a ModalResult in
        the operator's layout; stores the per-mode Ritz bounds and the
        accurate solves' iteration counts."""
        its = []

        def solve(b):
            r = ks_acc(b)
            its.append(r.iterations)
            return r.x

        om_ref, eta, modes_ref = shift_invert_refine(solve, m_diag, res.modes)
        self.modal_error_bounds = eta.cpu().numpy()
        self.modal_info["refine_iterations"] = its
        return res._replace(omega=om_ref.to(res.omega.dtype), modes=modes_ref.to(res.modes.dtype))

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
        with span("solid.run_simulation"):
            self.assemble_stiffness_matrix()
            self.apply_boundary_conditions()
            self.solve()
            self.print_reactions()
            if report:
                self.generate_report(report_path)
        return self

    def generate_report(self, filename: str = "FEM_Report.md") -> None:
        """Markdown or .docx report (femx_torch.report.solid_report)."""
        self._log(f"\n6. Generating analysis report to {filename}...")
        from femx_torch.report import solid_report

        solid_report(self, filename)
        self._log("   - Report generation complete.")

    def plot(self, factor: float = 1.0, show_window: bool = True,
             filename: str = "fem_result.png", color: str = "disp"):
        """Deformed-shape view (femx_torch.viz.plot_solid_results)."""
        from femx_torch.viz import plot_solid_results

        return plot_solid_results(self, factor=factor, show_window=show_window,
                                  filename=filename, color=color)

    def export_html(self, filename: str = "fem_result.html", factor: float = 1.0) -> str:
        """Standalone interactive WebGL viewer (femx_torch.viz_html), the
        headless answer to the reference's PyVista window
        (ReactionSolver.py:234-294)."""
        from femx_torch.viz_html import export_solid_html

        return export_solid_html(self, filename, factor=factor)


# Reference-compatible alias (ReactionSolver.py:16).
ForceAnalysis = SolidReactionAnalysis
