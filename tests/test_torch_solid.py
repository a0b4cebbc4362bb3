"""femx_torch.SolidReactionAnalysis == femx's on the reference default case
(block-Jacobi) and on an MG-branch case, each in f64 and as f64 CG with an
f32 preconditioner; plus the not-yet-ported options raise."""

import numpy as np
import pytest
import torch

import femx
import femx_torch

torch.set_num_threads(2)

E, NU = 2e11, 0.3
CORNERS = [(0, 0), (0, 0.8), (0.8, 0), (0.8, 0.8)]
FORCE = [{"force_x": 0, "force_y": 3000.0, "force_z": 0,
          "force_x_pstn": 0.4, "force_y_pstn": 0.2, "force_z_pstn": 0.4}]
FIX = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
       for x, z in CORNERS]


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


def _reference_case(pkg, **kw):
    """README quick start: box_tet10(0.8, 0.2, 0.8, 0.05), 29,403 DOF."""
    mesh = pkg.box_tet10(0.8, 0.2, 0.8, 0.05, force_points=[(0.4, 0.2, 0.4)],
                         fix_points=[(x, 0, z) for x, z in CORNERS])
    return pkg.SolidReactionAnalysis(mesh, FORCE, FIX, E=E, v=NU, verbose=False,
                                     **kw).run_simulation()


def _corner_reactions(fa):
    return np.array([fa.reaction_forces[3 * i["node_idx"]:3 * i["node_idx"] + 3]
                     for i in fa.fixed_nodes_info])


def _assert_goldens(fa):
    """tests/test_reference_goldens.py:164-182 (FEM_Report.docx numbers)."""
    np.testing.assert_allclose(fa.equilibrium_residual(), 0.0, atol=1e-6)
    R = _corner_reactions(fa)
    assert R[:, 1].mean() == pytest.approx(-750.0, rel=1e-9)
    np.testing.assert_allclose(R[:, 1], -750.0, rtol=0.08)
    assert R[0, 1] == pytest.approx(R[3, 1], rel=1e-8)
    assert R[1, 1] == pytest.approx(R[2, 1], rel=1e-8)
    np.testing.assert_allclose(np.abs(R[:, 0]), 376.0, rtol=0.15)
    np.testing.assert_allclose(np.abs(R[:, 2]), 376.0, rtol=0.15)
    assert R[0, 0] < 0 and R[1, 0] < 0 and R[2, 0] > 0 and R[3, 0] > 0
    assert R[0, 2] < 0 and R[1, 2] > 0 and R[2, 2] < 0 and R[3, 2] > 0


@pytest.fixture(scope="module")
def ref_femx():
    return _reference_case(femx)


def test_reference_default_case_matches_femx_and_goldens(ref_femx):
    fx = ref_femx
    pt = _reference_case(femx_torch, device="cpu")
    assert pt.solve_info["method"] == fx.solve_info["method"] == "structured_block_jacobi_pcg"
    assert set(pt.solve_info) == set(fx.solve_info)
    assert pt.solve_info["converged"]
    assert pt.solve_info["iterations"] == fx.solve_info["iterations"]
    Rf, Rp = _corner_reactions(fx), _corner_reactions(pt)
    np.testing.assert_allclose(Rp, Rf, rtol=1e-9, atol=np.abs(Rf).max() * 1e-9)
    np.testing.assert_allclose(pt.u, fx.u, rtol=1e-8, atol=np.abs(fx.u).max() * 1e-9)
    assert [i["node_idx"] for i in pt.fixed_nodes_info] == \
        [i["node_idx"] for i in fx.fixed_nodes_info]
    _assert_goldens(pt)


def test_reference_default_case_f32_mixed_matches_femx_f64(ref_femx):
    """The block-Jacobi branch with dtype=float32: f64 CG on the f64
    operator, block-Jacobi applied in f32, to femx's f64 reactions."""
    pt = _reference_case(femx_torch, dtype=np.float32, device="cpu")
    info = pt.solve_info
    assert info["method"] == "structured_block_jacobi_pcg_mixed"
    assert info["converged"] and info["residual"] <= pt.cg_tol
    assert np.linalg.norm(pt.equilibrium_residual()) <= 1e-6 * 3000.0
    Rf, Rp = _corner_reactions(ref_femx), _corner_reactions(pt)
    np.testing.assert_allclose(Rp, Rf, rtol=1e-6, atol=np.abs(Rf).max() * 1e-6)


def _mg_case(pkg, **kw):
    """A small even grid through the MG branch: (4, 4, 8) cells, 4,131 DOF,
    a tip load and the 4 corners of the root face fixed."""
    mesh = pkg.box_tet10(0.4, 0.4, 0.8, 0.1, force_points=[(0.2, 0.4, 0.8)],
                         fix_points=[(x, y, 0.0) for x in (0, 0.4) for y in (0, 0.4)])
    force = [{"force_x": 0, "force_y": -500.0, "force_z": 100.0,
              "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 0.8}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": 0.0, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x in (0, 0.4) for y in (0, 0.4)]
    return pkg.SolidReactionAnalysis(mesh, force, fix, E=E, v=NU, verbose=False,
                                     **{"solver": "mg", **kw}).run_simulation()


@pytest.fixture(scope="module")
def mg_femx():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEMX_MG_CACHE", "0")
        return _mg_case(femx, cg_tol=1e-10)


def test_mg_branch_f64_matches_femx(mg_femx):
    pt = _mg_case(femx_torch, cg_tol=1e-10, device="cpu")
    assert pt.solve_info["method"] == mg_femx.solve_info["method"] == "structured_multigrid_pcg"
    assert pt.solve_info["converged"]
    assert pt.solve_info["iterations"] == mg_femx.solve_info["iterations"]
    Rf, Rp = _corner_reactions(mg_femx), _corner_reactions(pt)
    np.testing.assert_allclose(Rp, Rf, rtol=1e-9, atol=np.abs(Rf).max() * 1e-9)
    np.testing.assert_allclose(pt.equilibrium_residual(), 0.0, atol=1e-6)


def test_mg_branch_f32_mixed_matches_femx_f64(mg_femx):
    """dtype=float32: f64 CG on the f64 operator with the f32 V-cycle as
    preconditioner reaches the f64 system's reactions."""
    pt = _mg_case(femx_torch, cg_tol=1e-8, dtype=np.float32, device="cpu")
    info = pt.solve_info
    assert info["method"] == "structured_multigrid_pcg_mixed"
    assert info["converged"] and info["residual"] <= 1e-8
    assert pt.u.dtype == np.float64
    np.testing.assert_allclose(pt.equilibrium_residual(), 0.0, atol=1e-6)
    Rf, Rp = _corner_reactions(mg_femx), _corner_reactions(pt)
    np.testing.assert_allclose(Rp, Rf, rtol=1e-6, atol=np.abs(Rf).max() * 1e-6)


_PS_CORNERS = [(x, y, 0.0) for x in (0.0, 0.4) for y in (0.0, 0.4)]


def _point_supported(pkg, **kw):
    """The flagship's loading at 6x6x24 cells (24,843 DOF): tip load, the 4
    corners of the root face fixed, dtype float32; not yet run."""
    mesh = pkg.box_tet10(0.4, 0.4, 1.6, 0.4 / 6, force_points=[(0.2, 0.4, 1.6)],
                         fix_points=_PS_CORNERS)
    return pkg.SolidReactionAnalysis(
        mesh, [{"force_x": 0.0, "force_y": -1000.0, "force_z": 0.0, "force_x_pstn": 0.2,
                "force_y_pstn": 0.4, "force_z_pstn": 1.6}],
        [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
         for x, y, z in _PS_CORNERS], E=E, v=NU, dtype=np.float32, verbose=False, **kw)


@pytest.fixture(scope="module")
def point_supported_schemes():
    """The port's two f32 schemes on the point-supported box: femx's
    refinement against the f32 cell matrix cast up, and f64 CG with the f32
    V-cycle. Returns their equilibrium residuals, with the reactions from
    the f64-assembled operator and from the cast-up one (femx's choice)."""
    from femx_torch.assembly_structured import StructuredSolidOperator
    from femx_torch.solve.cg import pcg_mixed, pcg_refined
    from femx_torch.solve.multigrid import StructuredMultigrid

    fa = _point_supported(femx_torch, device="cpu")
    mesh = fa.mesh
    fa.assemble_stiffness_matrix()
    fa.apply_boundary_conditions()
    mask = fa.constraints.free_mask()
    op = fa.operator.with_free_mask(fa.operator.to_internal(mask))
    mg = StructuredMultigrid(None, mesh.structured.n_cells, E, NU, mask, dtype=np.float32,
                             fine_op=op, spacing=mesh.structured.spacing, device="cpu")
    b = torch.from_numpy(op.to_internal(fa.f * mask))
    op_cast = op.astype(np.float64)
    op_f64 = StructuredSolidOperator.from_mesh(
        mesh, E, NU, dtype=np.float64, device="cpu").with_free_mask(op.free_mask_host)

    def equilibrium(x, K):
        r = op.to_global(K.apply(x).numpy())
        return np.array([0.0, -1000.0, 0.0]) + sum(
            r[3 * i["node_idx"]:3 * i["node_idx"] + 3] for i in fa.fixed_nodes_info)

    ref = pcg_refined(op.apply_constrained, b.float(), M_inv_diag=mg, tol=1e-5,
                      refine_steps=8, A_residual=op_cast.apply_constrained,
                      b_residual=b, outer_tol=1e-8)
    mixed = pcg_mixed(op_f64.apply_constrained, b, mg, tol=1e-8)
    assert ref.converged and mixed.converged
    return {"refined": equilibrium(ref.x, op_f64),
            "refined_cast_up": equilibrium(ref.x, op_cast),
            "mixed": equilibrium(mixed.x, op_f64)}


def test_f32_cast_up_refinement_loses_equilibrium_where_mixed_holds(point_supported_schemes):
    """Why the f32 branch is mixed precision and not femx's refinement: on a
    point-supported box the f32 cell matrix cast up to f64 breaks the
    rigid-body null space, and refinement against it converges to a system
    whose reactions miss equilibrium by about 1.5 % of the load. The mixed
    scheme converges on the f64 operator and holds equilibrium to its
    residual."""
    eq = point_supported_schemes
    assert np.abs(eq["refined"]).max() > 5.0  # ~15 N of a 1000 N load
    assert np.abs(eq["mixed"]).max() < 1e-5


def test_femx_f32_refined_solve_loses_the_same_equilibrium(point_supported_schemes):
    """femx itself, through SolidReactionAnalysis(dtype=float32), misses
    equilibrium on the point-supported box by what the port's refinement
    misses it: the loss is the cast-up scheme's, not the port's. (femx's
    block-Jacobi branch keeps the test cheap; its refinement converges to
    the same cast-up system as the MG branch.)"""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEMX_MG_CACHE", "0")
        fx = _point_supported(femx, solver="cg", cg_tol=1e-8).run_simulation()
    assert fx.solve_info["method"] == "structured_block_jacobi_pcg_refined"
    assert fx.solve_info["converged"]
    eq = fx.equilibrium_residual()
    assert np.abs(eq).max() > 5.0
    np.testing.assert_allclose(eq, point_supported_schemes["refined_cast_up"],
                               rtol=1e-5, atol=1e-6 * 1000.0)


@pytest.mark.parametrize("kw,item", [
    (dict(devices=2), "A15"),
    (dict(unstructured_operator="groupell"), "A11"),
    (dict(structured_apply="conv"), "A14"),
    (dict(unstructured_operator="cluster"), "A11"),
])
def test_unported_options_raise(kw, item):
    mesh = femx_torch.box_tet10(0.2, 0.1, 0.1, 0.05)
    with pytest.raises(NotImplementedError, match=item):
        femx_torch.SolidReactionAnalysis(mesh, [], [], E=E, v=NU, verbose=False,
                                         device="cpu", **kw)


def test_unported_inputs_raise(tmp_path):
    """Mesh files and unstructured meshes are ported; the group-ELL operator,
    a bad operator or solver name, a mesh without tets and reports are not."""
    mesh = femx_torch.box_tet10(0.2, 0.1, 0.1, 0.05)
    with pytest.raises(NotImplementedError, match="A11"):
        femx_torch.SolidReactionAnalysis(mesh, [], [], E=E, v=NU, verbose=False,
                                         device="cpu", unstructured_operator="groupell")
    for bad in (dict(unstructured_operator="bcsr"), dict(solver="lu")):
        with pytest.raises(ValueError):
            femx_torch.SolidReactionAnalysis(mesh, [], [], E=E, v=NU, verbose=False,
                                             device="cpu", **bad)
    lines = femx_torch.Mesh(points=np.zeros((2, 3)), cells={"line": np.array([[0, 1]])})
    with pytest.raises(ValueError, match="tetra10"):
        femx_torch.SolidReactionAnalysis(lines, [], [], E=E, v=NU, verbose=False,
                                         device="cpu")
    # an embedded off-lattice point makes the mesh unstructured: it now solves
    # through the unstructured routes, read back from a .msh file as well
    off = femx_torch.box_tet10(0.5, 0.3, 0.4, 0.1, fix_points=[(0.0, 0.013, 0.0)])
    assert off.structured is None
    path = tmp_path / "off.msh"
    femx_torch.mesh.write_msh(str(path), off)
    fa = femx_torch.SolidReactionAnalysis(str(path), [], [], E=E, v=NU, verbose=False,
                                          device="cpu")
    assert fa.mesh.structured is None and fa.num_nodes == off.num_nodes
    with pytest.raises(NotImplementedError, match="A16"):
        fa.run_simulation(report=True)
