"""femx_torch's beam products against femx's on the same inputs (CPU, f64):
the Timoshenko element kernels (random members, vertical ones and
degenerate L = 0 / A = 0 ones: 1e-13 of max|K|), the beam BCs and frame
builders, and BeamAnalysis on the reference's portal frame with a
DistributedForce, lumped and consistent mass (u, reactions, stresses
1e-10; frequencies 1e-9; mode shapes up to sign, degenerate pairs by
subspace); plus the package surface: femx_torch.__all__ holds femx's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import femx
import femx.analysis.beam as fx_beam
import femx.bc as fx_bc
import femx.elements.beam as fx_el
import femx_torch
import femx_torch.analysis.beam as pt_beam
import femx_torch.bc as pt_bc
import femx_torch.elements.beam as pt_el

torch.set_num_threads(2)

E, NU = 2e11, 0.3
G = E / (2 * (1 + NU))
I_PARAMS = {"d": 0.05, "b": 0.025, "t_w": 0.005, "t_f": 0.005, "r": 0.001}
C_PARAMS = {"d": 0.05, "b": 0.025, "t_f": 0.005, "t_w": 0.005, "r": 0.001}
SECTIONS = [{"group": "l_section", "type": "I section", "params": I_PARAMS},
            {"group": "c_section", "type": "C section", "params": C_PARAMS}]
FIX_ALL = {"type": "Fix", "fix_x": True, "fix_y": True, "fix_z": True,
           "fix_rx": True, "fix_ry": True, "fix_rz": True}
BCS = [{"group": "fix", **FIX_ALL},
       {"group": "load_y", "type": "Force", "force_x": 0, "force_y": -3000.0, "force_z": 0},
       {"group": "c_section", "type": "DistributedForce", "wx": 0.0, "wy": -2000.0,
        "wz": 300.0}]


def _members(kind, n=24, seed=0):
    """(p1, p2, props) host arrays: random members, vertical ones (up and
    down), or degenerate ones (L = 0, A = 0, I = 0)."""
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(-2, 2, (n, 3))
    d = rng.uniform(-1, 1, (n, 3))
    props = np.column_stack([rng.uniform(1e-4, 1e-2, n), rng.uniform(1e-8, 1e-5, n),
                             rng.uniform(1e-8, 1e-5, n), rng.uniform(1e-9, 1e-6, n),
                             rng.uniform(0.3, 0.9, n), rng.uniform(0.3, 0.9, n),
                             rng.uniform(0.01, 0.2, n), rng.uniform(0.01, 0.2, n)])
    if kind == "vertical":
        d[:, :2] = rng.uniform(-1e-8, 1e-8, (n, 2))
        d[: n // 2, 2] = np.abs(d[: n // 2, 2]) + 0.1
        d[n // 2:, 2] = -np.abs(d[n // 2:, 2]) - 0.1
    elif kind == "degenerate":
        d[0::3] = 0.0  # L = 0
        props[1::3, 0] = 0.0  # A = 0
        props[2::3, 1:3] = 0.0  # I = 0
    return p1, p1 + d, props


def _femx_batch(p1, p2, props, mass):
    return [np.asarray(a) for a in fx_el.batched_element_matrices(
        jnp.asarray(p1), jnp.asarray(p2), E, G, jnp.asarray(props), 7850.0, mass)]


def _close(got, want, rel=1e-13):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, equal_nan=True)


@pytest.mark.parametrize("kind", ["random", "vertical", "degenerate"])
@pytest.mark.parametrize("mass", ["lumped", "consistent"])
def test_element_matrices_match_femx(kind, mass):
    p1, p2, props = _members(kind)
    ke, me, L = pt_el.element_matrices(torch.from_numpy(p1), torch.from_numpy(p2), E, G,
                                       torch.from_numpy(props), 7850.0, mass)
    want_k, want_m, want_L = _femx_batch(p1, p2, props, mass)
    _close(ke, want_k)
    _close(me, want_m)
    _close(L, want_L)
    if kind == "degenerate":
        assert torch.all(ke[0::3] == 0) and torch.isfinite(ke).all()


@pytest.mark.parametrize("kind", ["random", "vertical", "degenerate"])
def test_direction_cosines_and_local_kernels_match_femx(kind):
    p1, p2, props = _members(kind, seed=1)
    lam = pt_el.direction_cosine_matrix(torch.from_numpy(p1), torch.from_numpy(p2))
    want = np.stack([np.asarray(fx_el.direction_cosine_matrix(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(p1, p2)])
    _close(lam, want)
    _close(pt_el.rotation_12(lam), np.stack([np.asarray(fx_el.rotation_12(jnp.asarray(x)))
                                             for x in want]))
    L = np.linalg.norm(p2 - p1, axis=1)
    args = [props[:, i] for i in range(6)]
    k = pt_el.timoshenko_stiffness(torch.from_numpy(L), E, G, *map(torch.from_numpy, args))
    want_k = jax.vmap(lambda l, *a: fx_el.timoshenko_stiffness(l, E, G, *a))(
        jnp.asarray(L), *map(jnp.asarray, args))
    _close(k, want_k)
    ue = np.random.default_rng(2).standard_normal((len(L), 12))
    f = pt_el.local_end_forces(torch.from_numpy(p1), torch.from_numpy(p2), E, G,
                               torch.from_numpy(props), torch.from_numpy(ue))
    want_f = jax.vmap(fx_el.local_end_forces, in_axes=(0, 0, None, None, 0, 0))(
        jnp.asarray(p1), jnp.asarray(p2), E, G, jnp.asarray(props), jnp.asarray(ue))
    _close(f, want_f)
    # one member, no batch axis
    _close(pt_el.lumped_mass(float(L[3]), *props[3, [0, 1, 2, 3]], 7850.0),
           fx_el.lumped_mass(L[3], *props[3, [0, 1, 2, 3]], 7850.0))
    _close(pt_el.consistent_mass(float(L[3]), *props[3, [0, 1, 2, 3]], 7850.0),
           fx_el.consistent_mass(L[3], *props[3, [0, 1, 2, 3]], 7850.0))


def _portal(pkg, n_col=3, n_beam=2):
    fb = pkg.FrameBuilder()
    n0 = fb.add_node((0.0, 0.0, 0.0))
    n1 = fb.add_node((0.0, 1.0, 0.0))
    n2 = fb.add_node((0.7, 1.0, 0.0))
    n3 = fb.add_node((0.7, 0.0, 0.0))
    n4 = fb.add_node((0.35, 1.0, 0.0))
    fb.add_vertex_group("fix", [n0, n3])
    fb.add_vertex_group("load_y", [n4])
    fb.add_member(n0, n1, "l_section", n_elems=n_col)
    fb.add_member(n3, n2, "l_section", n_elems=n_col)
    fb.add_member(n1, n4, "c_section", n_elems=n_beam)
    fb.add_member(n4, n2, "c_section", n_elems=n_beam)
    return fb.build()


def test_frame_builders_and_beam_bcs_match_femx():
    mt, mf = _portal(femx_torch), _portal(femx)
    np.testing.assert_array_equal(mt.points, mf.points)
    for k in mf.cells:
        np.testing.assert_array_equal(mt.cells[k], mf.cells[k])
        np.testing.assert_array_equal(mt.cell_physical[k], mf.cell_physical[k])
    assert mt.field_data == mf.field_data
    ct, ft = pt_bc.beam_group_constraints_and_loads(mt, BCS)
    cf, ff = fx_bc.beam_group_constraints_and_loads(mf, BCS)
    np.testing.assert_array_equal(ct.fixed_dofs, cf.fixed_dofs)
    _close(ft, ff)
    _close(pt_bc.distributed_fixed_end_local(mt, BCS), fx_bc.distributed_fixed_end_local(mf, BCS))
    assert pt_bc.distributed_fixed_end_local(mt, BCS[:2]) is None
    with pytest.warns(UserWarning, match="no line elements"):
        pt_bc.beam_group_constraints_and_loads(
            mt, [{"group": "nope", "type": "DistributedForce", "wy": 1.0}])
    a, b = femx_torch.cantilever_line_mesh(1.5, 4), femx.cantilever_line_mesh(1.5, 4)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.cells["line"], b.cells["line"])


@pytest.fixture(scope="module", params=["lumped", "consistent"])
def portal_pair(request):
    """The portal frame (refined, with a DistributedForce) through both
    packages; the sections take the warping FEM ('auto')."""
    mass = request.param
    want = fx_beam.BeamAnalysis(_portal(femx), SECTIONS, BCS, E=E, nu=NU, rho=7800.0,
                                mass=mass).run()
    ba = pt_beam.BeamAnalysis(_portal(femx_torch), SECTIONS, BCS, E=E, nu=NU, rho=7800.0,
                              mass=mass, device="cpu")
    return ba.run(), want, ba


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_portal_statics_match_femx(portal_pair):
    got, want, ba = portal_pair
    assert _rel(got.u, want.u) <= 1e-10
    assert _rel(got.reactions(), want.reactions()) <= 1e-10
    assert _rel(got.smoothed_stresses, want.smoothed_stresses) <= 1e-10
    _close(got.K, want.K, 1e-13)
    _close(got.M, want.M, 1e-13)
    np.testing.assert_array_equal(got.fixed_dofs, want.fixed_dofs)
    for g, p in want.props_map.items():
        np.testing.assert_allclose(got.props_map[g], p, rtol=1e-8)
    assert set(ba.stage_times) == {"sections", "element_matrices", "assembly", "solve",
                                   "stresses", "eigensolve"}


def test_portal_modes_match_femx(portal_pair):
    got, want, _ = portal_pair
    np.testing.assert_allclose(got.natural_frequencies, want.natural_frequencies, rtol=1e-9)
    lam = want.natural_frequencies ** 2
    n = 12
    k = 0
    while k < n:
        # group (near-)degenerate eigenvalues and compare their subspaces
        j = k + 1
        while j < len(lam) and abs(lam[j] - lam[k]) <= 1e-6 * lam[k]:
            j += 1
        A, B = got.mode_shapes[:, k:j], want.mode_shapes[:, k:j]
        if j - k == 1:
            s = np.sign(A[:, 0] @ B[:, 0])
            assert _rel(s * A[:, 0], B[:, 0]) <= 1e-8
        else:
            # projector of one basis onto the other's span is the identity
            P = B @ np.linalg.lstsq(B, A, rcond=None)[0]
            assert _rel(P, A) <= 1e-8
        k = j


def test_golden_portal_statics_on_the_cpu():
    """tests/test_reference_goldens.py:76-87 through the port: 3.0047e-3 m
    and 283.4407 MPa at the loaded node."""
    mesh = _portal(femx_torch, 1, 1)
    res = pt_beam.BeamAnalysis(mesh, SECTIONS, BCS[:2], E=E, nu=NU, rho=7800.0,
                               mass="consistent", device="cpu").run()
    u3 = res.u.reshape(-1, 6)[:, :3]
    assert np.abs(u3).max() == pytest.approx(3.0047e-3, rel=2e-5)
    assert res.smoothed_stresses.max() / 1e6 == pytest.approx(283.4407, rel=2e-5)


def test_package_exports_every_femx_name():
    assert set(femx.__all__) <= set(femx_torch.__all__)
    for name in ("BeamAnalysis", "ShaftModalAnalysis", "PlaneAnalysis", "PipeThermalAnalysis",
                 "FrameBuilder", "cantilever_line_mesh", "compute_properties",
                 "calculate_section_properties", "SectionProperties"):
        assert getattr(femx_torch, name) is not None


def test_beam_analysis_rejects_a_mesh_without_lines():
    with pytest.raises(ValueError, match="line"):
        pt_beam.BeamAnalysis(femx_torch.box_tet10(0.1, 0.1, 0.1, 0.05), [], [], E=E, nu=NU,
                             device="cpu")
