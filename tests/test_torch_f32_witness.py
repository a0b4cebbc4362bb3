"""The float32 witness of the unstructured route.

femx's own SolidReactionAnalysis(path, dtype=float32) on a small
corner-fixed, relabelled box takes the TG route with float32 CG and float64
refinement against the float32 operator cast up
(femx/analysis/solid.py:717-732). The cast carries the float32-rounded
geometry factors into the solution: femx's reactions, taken from the same
cast-up operator, balance the load, but its displacements under the float64
operator assembled from the mesh miss equilibrium by ~2e-3 N of a 1,000 N
load, past the product's 1e-6 |F|. The port runs float64 CG on that float64
operator, preconditioned in float32 (method "tg_block_jacobi_pcg_mixed", as
on the structured route: tests/test_torch_solid.py), and holds it.
"""

import numpy as np
import pytest
import torch

import femx
import femx_torch
from femx_torch.assembly_tg import SolidOperatorTG
from femx_torch.mesh import relabel_nodes, write_msh

torch.set_num_threads(2)

E, NU = 2e11, 0.3
LOAD = 1000.0
DIMS = (0.3, 0.2, 0.2)  # 8 x 5 x 5 cells at h = 0.04: 6,171 DOF, above the dense limit


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    X, Y, Z = DIMS
    corners = [(0, 0, 0), (X, 0, 0), (0, 0, Z), (X, 0, Z)]
    mesh = femx_torch.box_tet10(X, Y, Z, 0.04, force_points=[(X, Y / 2, Z / 2)],
                                fix_points=corners)
    mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
    path = str(tmp_path_factory.mktemp("msh") / "witness.msh")
    write_msh(path, mesh)
    force = [{"force_x": 0, "force_y": -LOAD, "force_z": 0, "force_x_pstn": X,
              "force_y_pstn": Y / 2, "force_z_pstn": Z / 2}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    return mesh, path, force, fix


def _corner_reactions(fa, r):
    return np.array([r[3 * i["node_idx"]:3 * i["node_idx"] + 3] for i in fa.fixed_nodes_info])


def test_femx_f32_refinement_misses_the_f64_equilibrium_the_port_holds(case):
    mesh, path, force, fix = case
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEMX_MG_CACHE", "0")
        fx = femx.SolidReactionAnalysis(path, force, fix, E=E, v=NU, dtype=np.float32,
                                        cg_tol=1e-8, verbose=False).run_simulation()
    pt = femx_torch.SolidReactionAnalysis(path, force, fix, E=E, v=NU, dtype=np.float32,
                                          cg_tol=1e-8, verbose=False,
                                          device="cpu").run_simulation()
    ref64 = femx_torch.SolidReactionAnalysis(path, force, fix, E=E, v=NU, dtype=np.float64,
                                             cg_tol=1e-10, verbose=False,
                                             device="cpu").run_simulation()
    assert 3 * pt.num_nodes > pt.DENSE_DOF_LIMIT
    assert fx.solve_info["method"] == "tg_block_jacobi_pcg_refined"
    assert pt.solve_info["method"] == "tg_block_jacobi_pcg_mixed"
    assert fx.solve_info["converged"] and pt.solve_info["converged"]

    op64, _ = SolidOperatorTG.from_mesh(mesh.points, mesh.cells["tetra10"], E, NU,
                                        dtype=np.float64, device="cpu")

    def f64_equilibrium(fa):
        """Load + reactions of fa's displacements under the float64 operator
        assembled here from the mesh."""
        r = op64.to_global(op64.apply(torch.as_tensor(op64.to_internal(fa.u))).numpy())
        return np.linalg.norm(np.array([0.0, -LOAD, 0.0]) + _corner_reactions(fa, r).sum(axis=0))

    # femx's reactions come from the cast-up operator its solution solves,
    # so they balance the load; under the mesh's float64 operator its
    # displacements do not
    assert np.linalg.norm(fx.equilibrium_residual()) <= 1e-6 * LOAD
    assert f64_equilibrium(fx) > 1e-6 * LOAD  # ~2e-3 N

    # the port's hold under its own reactions and under that operator
    assert np.linalg.norm(pt.equilibrium_residual()) <= 1e-6 * LOAD
    assert f64_equilibrium(pt) <= 1e-6 * LOAD
    R64 = _corner_reactions(ref64, ref64.reaction_forces)
    np.testing.assert_allclose(_corner_reactions(pt, pt.reaction_forces), R64, rtol=1e-6,
                               atol=1e-6 * np.abs(R64).max())
