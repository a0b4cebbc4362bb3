"""Beam analysis: 3D Timoshenko frames, static + stress + modal (port of
femx/analysis/beam.py).

Headless equivalent of the reference's `BeamAnalysisWindow.run_simulation`
(BeamSolver.py:345-465): a line mesh with physical groups, per-group section
assignments, per-group BC and force assignments, E and nu in; displacements,
smoothed nodal stresses, natural frequencies and full-DOF mode shapes out.
On `device` (None = CUDA): the section warping FEMs, the batched element
matrices, the dense scatter assembly of K and M, the partitioned Cholesky
solve and the symmetric generalized eigensolve. The result fields are host
numpy, as in femx.

Deviations from the reference, as in femx: the density honors `rho` (the
reference hardcodes 7850, BeamSolver.py:376); the modal solve is symmetric
(identical eigenvalues, true eigenvectors); consistent mass is available
beside lumped.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from femx_torch import bc as bc_mod
from femx_torch.assembly import assemble_dense, dof_map
from femx_torch.config import resolve_device
from femx_torch.elements import beam as beam_el
from femx_torch.mesh.core import Mesh
from femx_torch.modal import modal_dense
from femx_torch.sections.properties import SectionProperties, compute_properties
from femx_torch.solve.dense import partitioned_solve


@dataclasses.dataclass
class BeamResults:
    u: np.ndarray  # (6N,) displacements/rotations
    smoothed_stresses: np.ndarray  # (N,) nodal stress (averaged element ends)
    natural_frequencies: np.ndarray  # rad/s, ascending
    mode_shapes: np.ndarray  # (6N, n_modes)
    props_map: Dict[str, SectionProperties]
    K: np.ndarray
    M: np.ndarray
    fixed_dofs: np.ndarray
    f: np.ndarray

    @property
    def natural_frequencies_hz(self) -> np.ndarray:
        return self.natural_frequencies / (2 * np.pi)

    def reactions(self) -> np.ndarray:
        return self.K @ self.u


class BeamAnalysis:
    """3D Timoshenko frame analysis on a 'line'-element mesh.

    Args:
      mesh: Mesh with 'line' cells, line physical groups naming section
        assignments and 'vertex' physical groups naming BCs.
      section_data: [{'group', 'type', 'params', 'rotate'}] (BeamSolver.py:237).
      bc_data: [{'group', 'type': 'Fix'|'Force'|'DistributedForce', ...}]
        (BeamSolver.py:250).
      E, nu: material. rho: density (7850 reproduces the reference).
      mass: 'lumped' (reference) or 'consistent'.
      section_method: 'auto' | 'fem' | 'closed_form' for J/kappa.
      device: where everything runs (None = CUDA).

    After run(), `stage_times` holds the seconds of each stage (sections,
    element_matrices, assembly, solve, stresses, eigensolve), each ended by
    a device synchronize.
    """

    def __init__(
        self,
        mesh: Mesh,
        section_data: Sequence[dict],
        bc_data: Sequence[dict],
        E: float,
        nu: float,
        rho: float = 7850.0,
        mass: str = "lumped",
        section_method: str = "auto",
        device=None,
    ):
        if "line" not in mesh.cells:
            raise ValueError("No 'line' elements in mesh.")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.section_data = list(section_data)
        self.bc_data = list(bc_data)
        self.E = float(E)
        self.nu = float(nu)
        self.rho = float(rho)
        self.mass = mass
        self.section_method = section_method
        self.points = mesh.points
        self.conn = mesh.cells["line"]
        self.results: Optional[BeamResults] = None
        self.stage_times: Dict[str, float] = {}

    # -- element-group resolution (BeamSolver.py:357-371) ---------------------
    def _element_props(self) -> Dict[str, SectionProperties]:
        props_map: Dict[str, SectionProperties] = {}
        for sec in self.section_data:
            props_map[sec["group"]] = compute_properties(
                sec["type"],
                {k: v for k, v in sec["params"].items() if k != "rotate"},
                rotate=sec.get("rotate", False),
                method=self.section_method,
                device=self.device,
            )
        return props_map

    def _group_names_per_element(self) -> List[str]:
        gid_to_name = {v[0]: k for k, v in self.mesh.field_data.items()}
        tags = self.mesh.cell_physical.get("line")
        if tags is None:
            raise ValueError("Line elements carry no physical tags.")
        return [gid_to_name.get(int(t)) for t in tags]

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device)

    def _stage(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.stage_times[name] = t1 - t0
        return t1

    def run(self, n_modes: Optional[int] = None) -> BeamResults:
        E, nu, rho = self.E, self.nu, self.rho
        G = E / (2.0 * (1.0 + nu))
        ndof = 6 * len(self.points)

        t = time.perf_counter()
        props_map = self._element_props()
        group_names = self._group_names_per_element()
        for g in group_names:
            if g not in props_map:
                raise ValueError(f"Section properties not defined for physical group '{g}'.")
        t = self._stage("sections", t)

        props_arr = self._tensor([props_map[g].as_tuple() for g in group_names])
        p1 = self._tensor(self.points[self.conn[:, 0]])
        p2 = self._tensor(self.points[self.conn[:, 1]])
        ke, me, _L = beam_el.element_matrices(p1, p2, E, G, props_arr, rho, self.mass)
        t = self._stage("element_matrices", t)

        edofs = dof_map(torch.as_tensor(np.asarray(self.conn), dtype=torch.int64,
                                        device=self.device), 6)
        K = assemble_dense(ke, edofs, ndof)
        M = assemble_dense(me, edofs, ndof)
        t = self._stage("assembly", t)

        cs, f = bc_mod.beam_group_constraints_and_loads(self.mesh, self.bc_data)
        u = partitioned_solve(K, f, cs.fixed_dofs, device=self.device)
        t = self._stage("solve", t)

        fe_local = bc_mod.distributed_fixed_end_local(self.mesh, self.bc_data)
        stresses = self._recover_stresses(u, props_arr, E, G, fe_local=fe_local)
        t = self._stage("stresses", t)

        modal = modal_dense(K, M, cs.fixed_dofs, n_modes=n_modes, device=self.device)
        omega, modes = modal.omega.cpu().numpy(), modal.modes.cpu().numpy()
        self._stage("eigensolve", t)

        self.results = BeamResults(
            u=u,
            smoothed_stresses=stresses,
            natural_frequencies=omega,
            mode_shapes=modes,
            props_map=props_map,
            K=K.cpu().numpy(),
            M=M.cpu().numpy(),
            fixed_dofs=cs.fixed_dofs,
            f=f,
        )
        return self.results

    # alias matching the reference method name
    run_simulation = run

    def _recover_stresses(self, u: np.ndarray, props_arr: torch.Tensor, E, G,
                          fe_local=None) -> np.ndarray:
        """Axial + extreme-fibre bending stress at element ends, averaged per
        node (BeamSolver.py:420-438). Members under DistributedForce loads
        subtract their local fixed-end load vectors (fe_local) from
        k_local (R u_e), so the end moments include each element's w L^2/12
        term."""
        n_nodes = len(self.points)
        p1 = self._tensor(self.points[self.conn[:, 0]])
        p2 = self._tensor(self.points[self.conn[:, 1]])
        u6 = u.reshape(n_nodes, 6)
        ue = self._tensor(np.concatenate([u6[self.conn[:, 0]], u6[self.conn[:, 1]]], axis=1))
        f_local = beam_el.local_end_forces(p1, p2, E, G, props_arr, ue)
        if fe_local is not None:
            f_local = f_local - self._tensor(fe_local)
        A, I_x, I_y = props_arr[:, 0], props_arr[:, 1], props_arr[:, 2]
        c_y, c_z = props_arr[:, 6], props_arr[:, 7]
        safe = beam_el._safe_div

        sigma_axial = safe(f_local[:, 6], A)
        bend1 = safe(f_local[:, 4] * c_z, I_x).abs() + safe(f_local[:, 5] * c_y, I_y).abs()
        bend2 = safe(f_local[:, 10] * c_z, I_x).abs() + safe(f_local[:, 11] * c_y, I_y).abs()
        s1 = (sigma_axial + bend1).cpu().numpy()
        s2 = (sigma_axial + bend2).cpu().numpy()

        nodal = np.zeros(n_nodes)
        counts = np.zeros(n_nodes, dtype=np.int64)
        np.add.at(nodal, self.conn[:, 0], s1)
        np.add.at(nodal, self.conn[:, 1], s2)
        np.add.at(counts, self.conn[:, 0], 1)
        np.add.at(counts, self.conn[:, 1], 1)
        return np.divide(nodal, counts, out=np.zeros_like(nodal), where=counts != 0)
