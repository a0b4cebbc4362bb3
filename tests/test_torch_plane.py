"""femx_torch's 2D plane machinery against femx's on the same inputs (CPU):
every Tri6 element function, plane and axisymmetric (1e-12), the 2D
meshers, the PlaneOperator/AxisymOperator applies, block-Jacobi blocks and
dense K (1e-12), one Multigrid2D V-cycle with >= 3 levels (1e-10), and
PlaneAnalysis through the dense, block-Jacobi and MG routes (u 1e-8,
iterations within 1) and in float32 (1e-5).

The float32 witness: femx runs the whole float32 CG on the float32
operator; its recursive residual meets cg_tol while the true one stalls,
and its reactions miss the float64 equilibrium (~1e-6 |F| on the MG route
here, more on block-Jacobi). The port runs float64 CG on the float64
operator with the float32 preconditioner (pcg_mixed), as its solid routes
do, and holds it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import femx.assembly_plane as fx_ops
import femx.elements.tri6 as fx_el
import femx.mesh.generators2d as fx_gen
import femx.solve.multigrid2d as fx_mg
from femx.analysis.plane import PlaneAnalysis as FxPlane
import femx_torch.assembly_plane as pt_ops
import femx_torch.elements.tri6 as pt_el
import femx_torch.mesh.generators2d as pt_gen
import femx_torch.solve.multigrid2d as pt_mg
from femx_torch.analysis.plane import PlaneAnalysis as PtPlane

torch.set_num_threads(2)

E, NU = 2e11, 0.3


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300))


def _mesh(kind, cells=(6, 4)):
    """A rect_tri6 lattice with its interior nodes jittered (so no element
    is a scaled copy of another); axisym sections start at r = 0.05."""
    mesh = pt_gen.rect_tri6_from_cells(cells, (0.05, 0.04),
                                       origin=(0.05 if kind == "axisym" else 0.0, 0.0))
    pts = mesh.points.copy()
    rng = np.random.default_rng(0)
    inner = np.where((pts[:, 0] > pts[:, 0].min()) & (pts[:, 0] < pts[:, 0].max())
                     & (pts[:, 1] > 0) & (pts[:, 1] < pts[:, 1].max()))[0]
    pts[inner, :2] += rng.uniform(-0.004, 0.004, (len(inner), 2))
    return pts, mesh.cells["triangle6"]


@pytest.fixture(scope="module")
def elems():
    pts, conn = _mesh("axisym")
    coords = pts[:, :2][conn]
    rng = np.random.default_rng(1)
    ue = rng.standard_normal(coords.shape)
    dT = rng.uniform(0, 100, coords.shape[:2])
    return coords, ue, dT


def _pair(coords, ue, dT):
    return ((torch.from_numpy(coords), torch.from_numpy(ue), torch.from_numpy(dT)),
            (jnp.asarray(coords), jnp.asarray(ue), jnp.asarray(dT)))


PLANE_C = {m: (pt_el.material_matrix_plane(E, NU, m), fx_el.material_matrix_plane(E, NU, m))
           for m in ("stress", "strain")}
AX_C = (pt_el.material_matrix_axisym(E, NU), fx_el.material_matrix_axisym(E, NU))

# each case: (port result, femx result) from (coords, ue, dT) in each package
CASES = {
    "material_matrices": lambda t, j: (
        torch.stack([PLANE_C["stress"][0], PLANE_C["strain"][0], AX_C[0][:3, :3]]),
        jnp.stack([PLANE_C["stress"][1], PLANE_C["strain"][1], AX_C[1][:3, :3]])),
    "jacobians": lambda t, j: (torch.cat([x.reshape(len(x), -1) for x in pt_el.jacobians(t[0])], 1),
                               jnp.concatenate([x.reshape(len(x), -1)
                                                for x in fx_el.jacobians(j[0])], 1)),
    "stiffness_plane": lambda t, j: (pt_el.element_stiffness_plane(t[0], PLANE_C["strain"][0], 0.02)[0],
                                     fx_el.element_stiffness_plane(j[0], PLANE_C["strain"][1], 0.02)[0]),
    "apply_plane": lambda t, j: (
        pt_el.element_apply_plane(*pt_el.jacobians(t[0])[:2], PLANE_C["stress"][0], t[1], 0.02),
        fx_el.element_apply_plane(*fx_el.jacobians(j[0])[:2], PLANE_C["stress"][1], j[1], 0.02)),
    "strain_stress_plane": lambda t, j: (
        torch.cat(pt_el.element_strain_stress_plane(pt_el.jacobians(t[0])[0], PLANE_C["stress"][0], t[1]), -1),
        jnp.concatenate(fx_el.element_strain_stress_plane(fx_el.jacobians(j[0])[0], PLANE_C["stress"][1], j[1]), -1)),
    "thermal_plane": lambda t, j: (
        pt_el.element_thermal_load_plane(t[0], PLANE_C["strain"][0], 1.3e-5, t[2], 0.02),
        fx_el.element_thermal_load_plane(j[0], PLANE_C["strain"][1], 1.3e-5, j[2], 0.02)),
    "mass_plane": lambda t, j: (pt_el.element_mass_plane(t[0], 7850.0, 0.02),
                                fx_el.element_mass_plane(j[0], 7850.0, 0.02)),
    "stress_nodes_plane": lambda t, j: (
        pt_el.element_stress_at_nodes_plane(t[0], PLANE_C["stress"][0], t[1], 1.2e-5, t[2]),
        fx_el.element_stress_at_nodes_plane(j[0], PLANE_C["stress"][1], j[1], 1.2e-5, j[2])),
    "von_mises": lambda t, j: (
        torch.stack([pt_el.von_mises_plane(t[1][:, :, None, 0] * 1e6 * torch.ones(3, dtype=torch.float64)),
                     pt_el.von_mises_plane(t[1][..., 0, None] * torch.tensor([1.0, -2.0, 0.5]), 0.3),
                     pt_el.von_mises_axisym(t[1][..., 0, None] * torch.tensor([1.0, -2.0, 0.5, 0.7]))]),
        jnp.stack([fx_el.von_mises_plane(j[1][:, :, None, 0] * 1e6 * jnp.ones(3)),
                   fx_el.von_mises_plane(j[1][..., 0, None] * jnp.array([1.0, -2.0, 0.5]), 0.3),
                   fx_el.von_mises_axisym(j[1][..., 0, None] * jnp.array([1.0, -2.0, 0.5, 0.7]))])),
    "axisym_gauss_data": lambda t, j: (
        torch.cat([x.reshape(len(x), -1) for x in pt_el.axisym_gauss_data(t[0])], 1),
        jnp.concatenate([x.reshape(len(x), -1) for x in fx_el.axisym_gauss_data(j[0])], 1)),
    "stiffness_axisym": lambda t, j: (pt_el.element_stiffness_axisym(t[0], AX_C[0])[0],
                                      fx_el.element_stiffness_axisym(j[0], AX_C[1])[0]),
    "apply_axisym": lambda t, j: (
        pt_el.element_apply_axisym(*pt_el.axisym_gauss_data(t[0])[:3], AX_C[0], t[1]),
        fx_el.element_apply_axisym(*fx_el.axisym_gauss_data(j[0])[:3], AX_C[1], j[1])),
    "thermal_axisym": lambda t, j: (pt_el.element_thermal_load_axisym(t[0], AX_C[0], 1.2e-5, t[2]),
                                    fx_el.element_thermal_load_axisym(j[0], AX_C[1], 1.2e-5, j[2])),
    "centrifugal_axisym": lambda t, j: (pt_el.element_centrifugal_load_axisym(t[0], 7850.0 * 300.0**2),
                                        fx_el.element_centrifugal_load_axisym(j[0], 7850.0 * 300.0**2)),
    "strain_stress_axisym": lambda t, j: (
        torch.cat(pt_el.element_strain_stress_axisym(t[0], AX_C[0], t[1], 1.2e-5, t[2]), -1),
        jnp.concatenate(fx_el.element_strain_stress_axisym(j[0], AX_C[1], j[1], 1.2e-5, j[2]), -1)),
    "stress_nodes_axisym": lambda t, j: (
        pt_el.element_stress_at_nodes_axisym(t[0], AX_C[0], t[1], 1.2e-5, t[2]),
        fx_el.element_stress_at_nodes_axisym(j[0], AX_C[1], j[1], 1.2e-5, j[2])),
    "area_and_mass_hat": lambda t, j: (
        torch.cat([pt_el.element_area(t[0]), torch.from_numpy(pt_el.MASS_HAT).reshape(-1)]),
        jnp.concatenate([fx_el.element_area(j[0]), jnp.asarray(fx_el.MASS_HAT).reshape(-1)])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tri6_element_functions_match_femx(elems, case):
    got, want = CASES[case](*_pair(*elems))
    _close(got, want, 1e-12)


def test_on_axis_hoop_limit_matches_femx():
    """An element touching r = 0 takes the du_r/dr hoop limit at the axis."""
    mesh = pt_gen.rect_tri6_from_cells((2, 2), (0.05, 0.04))
    coords = mesh.points[:, :2][mesh.cells["triangle6"]]
    ue = np.random.default_rng(4).standard_normal(coords.shape)
    C = pt_el.material_matrix_axisym(E, NU)
    _close(pt_el.element_stress_at_nodes_axisym(torch.from_numpy(coords), C, torch.from_numpy(ue)),
           fx_el.element_stress_at_nodes_axisym(jnp.asarray(coords), np.asarray(C),
                                                jnp.asarray(ue)), 1e-12)


def test_2d_meshers_match_femx():
    kw = dict(force_points=[(0.5, 0.1)], fix_points=[(0.0, 0.0), (1.0, 0.0)])
    a, b = pt_gen.rect_tri6(1.0, 0.2, 0.05, **kw), fx_gen.rect_tri6(1.0, 0.2, 0.05, **kw)
    np.testing.assert_array_equal(a.points, b.points)
    for k in b.cells:
        np.testing.assert_array_equal(a.cells[k], b.cells[k])
        np.testing.assert_array_equal(a.cell_physical[k], b.cell_physical[k])
    assert a.field_data == b.field_data and a.lattice2d == b.lattice2d
    assert a.bc_embed_info == b.bc_embed_info
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (12, 3))
    tris = np.array([[0, 1, 2], [1, 3, 2], [3, 4, 2], [5, 6, 7]])
    for x, y in zip(pt_gen.tri3_to_tri6(pts, tris), fx_gen.tri3_to_tri6(pts, tris)):
        np.testing.assert_array_equal(x, np.asarray(y))


def _operators(kind, cells=(6, 4)):
    pts, conn = _mesh(kind, cells)
    mask = np.ones(2 * len(pts))
    mask[[0, 1, 5, 2 * len(pts) - 1]] = 0.0
    if kind == "plane":
        pt_op, _ = pt_ops.PlaneOperator.from_mesh(pts, conn, PLANE_C["stress"][0], thickness=0.02,
                                                  device="cpu")
        fx_op, _ = fx_ops.PlaneOperator.from_mesh(pts, conn, PLANE_C["stress"][1], thickness=0.02)
    else:
        pt_op, _ = pt_ops.AxisymOperator.from_mesh(pts, conn, AX_C[0], device="cpu")
        fx_op, _ = fx_ops.AxisymOperator.from_mesh(pts, conn, AX_C[1])
    return pt_op.with_free_mask(mask), fx_op.with_free_mask(jnp.asarray(mask))


@pytest.mark.parametrize("kind", ["plane", "axisym"])
def test_operators_match_femx(kind):
    pt_op, fx_op = _operators(kind)
    u = np.random.default_rng(6).standard_normal(pt_op.ndof)
    _close(pt_op.apply(torch.from_numpy(u)), fx_op.apply(jnp.asarray(u)), 1e-12)
    _close(pt_op.apply_constrained(torch.from_numpy(u)), fx_op.apply_constrained(jnp.asarray(u)),
           1e-12)
    _close(pt_op.block_jacobi_inverse_blocks(), fx_op.block_jacobi_inverse_blocks(), 1e-12)
    _close(pt_op.block_jacobi_preconditioner()(torch.from_numpy(u)),
           fx_op.block_jacobi_preconditioner()(jnp.asarray(u)), 1e-12)
    _close(pt_op.dense(), fx_op.dense(), 1e-12)
    if kind == "plane":
        _close(pt_op.block_diagonal(), fx_op.block_diagonal(), 1e-12)


@pytest.mark.parametrize("kind", ["plane", "axisym"])
def test_multigrid2d_vcycle_matches_femx(kind):
    """One V-cycle at 16 x 8 cells with coarse_dof_limit=200: 3 levels."""
    cells, h = (16, 8), (0.05, 0.04)
    origin = (0.05, 0.0) if kind == "axisym" else (0.0, 0.0)
    mesh = pt_gen.rect_tri6_from_cells(cells, h, origin=origin)
    mask = np.ones(2 * mesh.num_nodes)
    mask[2 * np.arange(2 * cells[1] + 1)] = 0.0  # u_x on the x = x0 edge
    mask[1] = 0.0
    C_pt, C_fx = (PLANE_C["stress"] if kind == "plane" else AX_C)
    kw = dict(thickness=0.02, coarse_dof_limit=200)
    mg = pt_mg.Multigrid2D(kind, cells, h, origin, C_pt, mask, device="cpu", **kw)
    want = fx_mg.Multigrid2D(kind, cells, h, origin, C_fx, jnp.asarray(mask), **kw)
    assert mg.n_levels == want.n_levels >= 3 and mg.level_shapes() == want.level_shapes()
    assert mg.applies_per_cycle() == 5 * (mg.n_levels - 1)
    r = np.random.default_rng(7).standard_normal(2 * mesh.num_nodes) * mask
    _close(mg(torch.from_numpy(r)), jax.jit(lambda m, x: m(x))(want, jnp.asarray(r)), 1e-10)
    uc = np.random.default_rng(8).standard_normal((5, 4, 2))
    _close(pt_mg.prolong2d(torch.from_numpy(uc)), fx_mg.prolong2d(jnp.asarray(uc)), 1e-14)
    uf = np.random.default_rng(9).standard_normal((9, 7, 2))
    _close(pt_mg.restrict2d(torch.from_numpy(uf)), fx_mg.restrict2d(jnp.asarray(uf)), 1e-14)


def _cantilever(cls, cells, lattice=True, **kw):
    gen = pt_gen if cls is PtPlane else fx_gen
    mesh = gen.rect_tri6_from_cells(cells, (1.0 / cells[0], 0.2 / cells[1]))
    if not lattice:
        del mesh.lattice2d
    if cls is PtPlane:
        kw["device"] = "cpu"
    pa = cls(mesh, [{"group": "right", "force_x": 0.0, "force_y": -1000.0}],
             [{"group": "left", "fix_x": 0, "fix_y": 0}], E=E, v=NU, thickness=0.01,
             verbose=False, **kw)
    return pa


def _run(pa, dense_limit):
    pa.DENSE_DOF_LIMIT = dense_limit
    pa.run_simulation()
    pa.compute_stresses()
    return pa


ROUTES = {"dense": ((16, 4), True, 6000, "dense_cholesky"),
          "block_jacobi": ((16, 4), False, 100, "block_jacobi_pcg"),
          "mg": ((32, 16), True, 1000, "mg_pcg_2d")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plane_analysis_routes_match_femx(route):
    cells, lattice, limit, method = ROUTES[route]
    got = _run(_cantilever(PtPlane, cells, lattice), limit)
    want = _run(_cantilever(FxPlane, cells, lattice), limit)
    assert got.solve_info["method"] == want.solve_info["method"] == method
    if method != "dense_cholesky":
        assert abs(got.solve_info["iterations"] - want.solve_info["iterations"]) <= 1
        assert got.solve_info["converged"]
    rel = np.abs(got.u - want.u).max() / np.abs(want.u).max()
    assert rel <= 1e-8
    _close(got.reaction_forces, want.reaction_forces, 1e-8)
    _close(got.stress_nodes, want.stress_nodes, 1e-7)
    np.testing.assert_allclose(got.equilibrium_residual(), 0.0, atol=1e-8 * 1000.0)


def _equilibrium64(pa):
    """|sum R + sum F| of a solution under the float64 operator."""
    op, _ = pt_ops.PlaneOperator.from_mesh(pa.points, pa.conn, PLANE_C["stress"][0],
                                           thickness=0.01, device="cpu")
    r = op.apply(torch.from_numpy(np.asarray(pa.u, dtype=np.float64))).numpy()
    fixed = pa.fixed_dofs
    react = np.array([r[fixed[fixed % 2 == c]].sum() for c in (0, 1)])
    return np.linalg.norm(react + np.array([0.0, -1000.0]))


def test_float32_route_matches_femx_and_holds_equilibrium():
    got = _run(_cantilever(PtPlane, (32, 16), dtype=np.float32), 1000)
    want = _run(_cantilever(FxPlane, (32, 16), dtype=np.float32), 1000)
    ref = _run(_cantilever(PtPlane, (32, 16)), 1000)
    assert got.solve_info["method"] == "mg_pcg_2d_mixed" and got.solve_info["converged"]
    for u in (got.u, want.u):
        assert np.abs(u - ref.u).max() <= 1e-5 * np.abs(ref.u).max()
    assert np.abs(got.u - want.u).max() <= 1e-5 * np.abs(want.u).max()
    # the witness: femx's float32 solution misses the float64 equilibrium
    # the port's float64 CG holds
    assert _equilibrium64(got) <= 1e-8 * 1000.0
    assert _equilibrium64(want) > 1e-7 * 1000.0


def test_modal_thermal_and_point_loads_match_femx():
    kw = dict(alpha=1.2e-5, temperature=lambda x, y: 50.0 + 100.0 * x * y, mode="strain")
    got = _run(_cantilever(PtPlane, (8, 4), **kw), 6000)
    want = _run(_cantilever(FxPlane, (8, 4), **kw), 6000)
    _close(got.u, want.u, 1e-10)
    _close(got.stress_nodes, want.stress_nodes, 1e-9)
    _close(got.von_mises, want.von_mises, 1e-9)
    m_got, m_want = got.modal(n_modes=5), want.modal(n_modes=5)
    np.testing.assert_allclose(m_got.omega.numpy(), np.asarray(m_want.omega), rtol=1e-9)
    mesh_kw = dict(force_points=[(0.5, 0.2)], fix_points=[(0.0, 0.0), (1.0, 0.0)])
    pa = [cls(gen.rect_tri6(1.0, 0.2, 0.1, **mesh_kw),
              [{"force_x": 10.0, "force_y": -100.0, "force_x_pstn": 0.5, "force_y_pstn": 0.2}],
              [{"pos_x": 0.0, "pos_y": 0.0, "fix_x": 0, "fix_y": 0},
               {"pos_x": 1.0, "pos_y": 0.0, "fix_x": 0, "fix_y": 0}],
              E=30e9, v=0.2, verbose=False, **extra).run_simulation()
          for cls, gen, extra in ((PtPlane, pt_gen, {"device": "cpu"}), (FxPlane, fx_gen, {}))]
    _close(pa[0].reaction_forces, pa[1].reaction_forces, 1e-10)
    assert np.abs(pa[0].equilibrium_residual()).max() < 1e-8 * 100.0


def test_tri3_promotion_inputs_and_unported_outputs(tmp_path):
    from femx_torch.mesh.core import Mesh

    pts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=float)
    mesh = Mesh(points=pts, cells={"triangle": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)},
                cell_physical={"triangle": np.ones(2, dtype=np.int32)},
                field_data={"surface": (1, 2)})
    pa = PtPlane(mesh, [{"force_x": 50.0, "force_y": 0.0, "force_x_pstn": 1.0,
                         "force_y_pstn": 1.0}],
                 [{"pos_x": 0.0, "pos_y": 0.0, "fix_x": 0, "fix_y": 0},
                  {"pos_x": 0.0, "pos_y": 1.0, "fix_x": 0, "fix_y": 0}],
                 E=1e9, v=0.3, verbose=False, device="cpu").run_simulation()
    assert pa.num_nodes == 9 and np.abs(pa.equilibrium_residual()).max() < 1e-9 * 50.0
    with pytest.raises(ValueError, match="mode"):
        PtPlane(mesh, [], [], E=1e9, v=0.3, mode="bogus", verbose=False, device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        PtPlane(mesh, [], [], E=1e9, v=0.3, temperature=5.0, verbose=False, device="cpu")
    # the outputs are ported: the report and the plot are written
    report = open(pa.generate_report(str(tmp_path / "plate.md"))).read()
    assert "## Equilibrium Check" in report and "- **Total Nodes:** 9" in report
    assert pa.plot(str(tmp_path / "plate.png")) == str(tmp_path / "plate.png")
    assert (tmp_path / "plate.png").stat().st_size > 0
    pa.MODAL_DOF_LIMIT = 10
    with pytest.raises(ValueError, match="dense 2D modal"):
        pa.modal(2)
