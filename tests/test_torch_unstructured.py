"""femx_torch.SolidReactionAnalysis(path) == femx's on a relabelled box read
from a .msh file, on each float64 route femx takes: dense Cholesky, the
generic block-Jacobi PCG, TG + block-Jacobi PCG and TG + lattice-MG PCG
(threshold lowered on both instances so a small box takes it): the same
method and iteration count, and u and the reactions to 1e-9 relative."""

import numpy as np
import pytest
import torch

import femx
import femx_torch
from femx_torch.mesh import read_msh, relabel_nodes, write_msh

torch.set_num_threads(2)

E, NU = 2e11, 0.3


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


def _box_file(tmp_path_factory, dims, h, name):
    """A corner-fixed box with a load on its top face, relabelled with
    default_rng(0).permutation and written as .msh; returns (path, force,
    fix)."""
    X, Y, Z = dims
    corners = [(0, 0, 0), (X, 0, 0), (0, 0, Z), (X, 0, Z)]
    mesh = femx_torch.box_tet10(X, Y, Z, h, force_points=[(X / 2, Y, Z / 2)],
                                fix_points=corners)
    mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
    path = tmp_path_factory.mktemp("msh") / f"{name}.msh"
    write_msh(str(path), mesh)
    force = [{"force_x": 0, "force_y": 3000.0, "force_z": 0, "force_x_pstn": X / 2,
              "force_y_pstn": Y, "force_z_pstn": Z / 2}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    return str(path), force, fix


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _box_file(tmp_path_factory, (0.2, 0.1, 0.1), 0.05, "small")  # 675 DOF


@pytest.fixture(scope="module")
def medium(tmp_path_factory):
    return _box_file(tmp_path_factory, (0.2, 0.2, 0.6), 0.05, "medium")  # 6,075 DOF


def _run(pkg, case, threshold=None, **kw):
    path, force, fix = case
    if pkg is femx_torch:
        kw["device"] = "cpu"
    fa = pkg.SolidReactionAnalysis(path, force, fix, E=E, v=NU, verbose=False, **kw)
    if threshold is not None:
        fa.MG_DOF_THRESHOLD = threshold
    return fa.run_simulation()


ROUTES = {
    "dense_cholesky": ("small", {}, None),
    "block_jacobi_pcg": ("small", {"solver": "cg"}, None),
    "tg_block_jacobi_pcg": ("medium", {}, None),
    "tg_lattice_mg_pcg": ("medium", {}, 6000),
}


@pytest.mark.parametrize("method", sorted(ROUTES))
def test_f64_routes_match_femx(request, method):
    case_name, kw, threshold = ROUTES[method]
    case = request.getfixturevalue(case_name)
    fx = _run(femx, case, threshold, **kw)
    pt = _run(femx_torch, case, threshold, **kw)
    assert fx.mesh.structured is None and pt.mesh.structured is None
    assert pt.solve_info["method"] == fx.solve_info["method"] == method
    assert set(pt.solve_info) == set(fx.solve_info)
    if "iterations" in fx.solve_info:
        assert pt.solve_info["converged"]
        assert pt.solve_info["iterations"] == fx.solve_info["iterations"]
    assert pt.negative_detJ_count == fx.negative_detJ_count == 0
    assert [i["node_idx"] for i in pt.fixed_nodes_info] == \
        [i["node_idx"] for i in fx.fixed_nodes_info]
    np.testing.assert_allclose(pt.u, fx.u, rtol=1e-9, atol=np.abs(fx.u).max() * 1e-9)
    R = fx.reaction_forces
    np.testing.assert_allclose(pt.reaction_forces, R, rtol=1e-9, atol=np.abs(R).max() * 1e-9)
    assert np.abs(pt.equilibrium_residual()).max() <= 1e-6 * 3000.0


@pytest.mark.parametrize("method,threshold", [("tg_block_jacobi_pcg_mixed", None),
                                              ("tg_lattice_mg_pcg_mixed", 6000)])
def test_f32_routes_reach_the_f64_reactions(medium, method, threshold):
    """dtype=float32 on the TG routes: float64 CG on the float64-assembled
    operator, preconditioned in float32, reaches femx's float64 reactions."""
    fx = _run(femx, medium, threshold)
    pt = _run(femx_torch, medium, threshold, dtype=np.float32, cg_tol=1e-8)
    assert pt.operator.dtype == torch.float32
    assert pt.solve_info["method"] == method and pt.solve_info["converged"]
    assert set(pt.solve_info) == set(fx.solve_info)
    R = fx.reaction_forces
    np.testing.assert_allclose(pt.reaction_forces, R, rtol=1e-6, atol=np.abs(R).max() * 1e-6)
    assert np.abs(pt.equilibrium_residual()).max() <= 1e-6 * 3000.0


def test_structured_mesh_with_solver_dense_takes_the_dense_route():
    mesh = femx_torch.box_tet10(0.2, 0.1, 0.1, 0.05, force_points=[(0.2, 0.05, 0.05)],
                                fix_points=[(0, 0, 0), (0, 0.1, 0), (0, 0, 0.1), (0, 0.1, 0.1)])
    force = [{"force_x": 0, "force_y": -100.0, "force_z": 0, "force_x_pstn": 0.2,
              "force_y_pstn": 0.05, "force_z_pstn": 0.05}]
    fix = [{"pos_x": 0, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for y, z in [(0, 0), (0.1, 0), (0, 0.1), (0.1, 0.1)]]
    pt = femx_torch.SolidReactionAnalysis(mesh, force, fix, E=E, v=NU, solver="dense",
                                          verbose=False, device="cpu").run_simulation()
    fx_mesh = femx.box_tet10(0.2, 0.1, 0.1, 0.05, force_points=[(0.2, 0.05, 0.05)],
                             fix_points=[(0, 0, 0), (0, 0.1, 0), (0, 0, 0.1), (0, 0.1, 0.1)])
    fx = femx.SolidReactionAnalysis(fx_mesh, force, fix, E=E, v=NU, solver="dense",
                                    verbose=False).run_simulation()
    assert pt.solve_info == fx.solve_info == {"method": "dense_cholesky"}
    np.testing.assert_allclose(pt.reaction_forces, fx.reaction_forces, rtol=1e-9,
                               atol=np.abs(fx.reaction_forces).max() * 1e-9)


def test_inverted_elements_are_counted_like_femx(tmp_path, medium):
    """negative_detJ_count on the TG and the generic routes: a mesh file with
    one element turned inside out (two corners and their edges swapped)."""
    path, force, fix = medium
    mesh = read_msh(path)
    tets = mesh.cells["tetra10"]
    tets[0, [1, 2]] = tets[0, [2, 1]]
    tets[0, [4, 6]] = tets[0, [6, 4]]
    tets[0, [8, 9]] = tets[0, [9, 8]]
    bad = str(tmp_path / "inverted.msh")
    write_msh(bad, mesh)
    for solver in ("auto", "dense"):
        counts = []
        for pkg, kw in ((femx, {}), (femx_torch, {"device": "cpu"})):
            fa = pkg.SolidReactionAnalysis(bad, force, fix, E=E, v=NU, solver=solver,
                                           verbose=False, **kw)
            fa.assemble_stiffness_matrix()
            counts.append(fa.negative_detJ_count)
        assert counts[1] == counts[0] > 0, (solver, counts)
