"""femx_torch Tet10 element kernels, the generic SolidOperator, dense
assembly and the dense solves == femx's, in float64 to 1e-12 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femx import assembly as fx_asm
from femx.elements import tet10 as fx_t10
from femx.mesh import box_tet10 as fx_box
from femx.solve import dense as fx_dense
from femx_torch import assembly as pt_asm
from femx_torch.elements import tet10 as pt_t10
from femx_torch.solve import dense as pt_dense

torch.set_num_threads(2)

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=np.abs(want).max() * rtol)


@pytest.fixture(scope="module")
def mesh():
    """A small box with its nodes jittered, so elements are general tets."""
    m = fx_box(0.3, 0.2, 0.2, 0.1)
    pts = np.asarray(m.points) + np.random.default_rng(0).uniform(-0.01, 0.01, m.points.shape)
    return pts, np.asarray(m.cells["tetra10"])


@pytest.fixture(scope="module")
def C():
    return pt_t10.material_matrix(2e11, 0.3)


def test_element_kernels_match(mesh, C):
    pts, conn = mesh
    coords = pts[conn]
    a = fx_t10.jacobians(jnp.asarray(coords))
    b = pt_t10.jacobians(torch.from_numpy(coords))
    for x, y in zip(a, b):
        _close(y, x)
    ke_f, bad_f = fx_t10.element_stiffness(jnp.asarray(coords), jnp.asarray(C), weight=0.25)
    ke_p, bad_p = pt_t10.element_stiffness(torch.from_numpy(coords), C, weight=0.25)
    _close(ke_p, ke_f)
    assert bad_p == int(bad_f) == 0
    _close(pt_t10.chat_tensor(torch.from_numpy(C)), fx_t10.chat_tensor(jnp.asarray(C)))
    J = torch.from_numpy(np.random.default_rng(1).normal(size=(7, 3, 3)))
    for x, y in zip(fx_t10._inv3x3(jnp.asarray(J.numpy())), pt_t10._inv3x3(J)):
        _close(y, x)
    ue = np.random.default_rng(2).normal(size=(len(conn), 10, 3))
    _close(pt_t10.element_apply(b[0], b[1], C, torch.from_numpy(ue)),
           fx_t10.element_apply(a[0], a[1], jnp.asarray(C), jnp.asarray(ue)))


def test_inverted_element_is_counted(mesh, C):
    pts, conn = mesh
    coords = pts[conn[:3]].copy()
    coords[0, [1, 2]] = coords[0, [2, 1]]  # swap two corners: negative detJ
    coords[0, [4, 6]] = coords[0, [6, 4]]  # and their edges' midsides
    coords[0, [8, 9]] = coords[0, [9, 8]]
    ke_f, bad_f = fx_t10.element_stiffness(jnp.asarray(coords), jnp.asarray(C))
    ke_p, bad_p = pt_t10.element_stiffness(torch.from_numpy(coords), C)
    assert bad_p == int(bad_f) > 0
    _close(ke_p, ke_f)


@pytest.fixture(scope="module")
def ops(mesh, C):
    pts, conn = mesh
    fx, detJ_f = fx_asm.SolidOperator.from_mesh(pts, conn, C)
    pt, detJ_p = pt_asm.SolidOperator.from_mesh(pts, conn, C, device="cpu")
    _close(detJ_p, detJ_f)
    mask = (np.random.default_rng(3).random(3 * len(pts)) > 0.15).astype(np.float64)
    return fx.with_free_mask(jnp.asarray(mask)), pt.with_free_mask(mask), mask


def test_solid_operator_matches(ops):
    fx, pt, _mask = ops
    u = np.random.default_rng(4).normal(size=pt.ndof)
    _close(pt.apply(torch.from_numpy(u)), fx.apply(jnp.asarray(u)))
    _close(pt.apply_constrained(torch.from_numpy(u)), fx.apply_constrained(jnp.asarray(u)))
    _close(pt.diagonal(), fx.diagonal())
    _close(pt.block_diagonal(), fx.block_diagonal())
    _close(pt.element_stiffness(), fx.element_stiffness())
    _close(pt.block_jacobi_preconditioner()(torch.from_numpy(u)),
           fx.block_jacobi_preconditioner()(jnp.asarray(u)))


def test_dense_assembly_and_solves_match(ops):
    fx, pt, mask = ops
    ndof = pt.ndof
    ed_f = fx_asm.dof_map(fx.conn, 3)
    ed_p = pt_asm.dof_map(pt.conn, 3)
    np.testing.assert_array_equal(ed_p.numpy(), np.asarray(ed_f))
    K_f = fx_asm.assemble_dense(fx.element_stiffness(), ed_f, ndof)
    K_p = pt_asm.assemble_dense(pt.element_stiffness(), ed_p, ndof)
    _close(K_p, K_f)
    fe = np.random.default_rng(5).normal(size=(ed_p.shape[0], 30))
    _close(pt_asm.assemble_vector(torch.from_numpy(fe), ed_p, ndof),
           fx_asm.assemble_vector(jnp.asarray(fe), ed_f, ndof))

    f = np.random.default_rng(6).normal(size=ndof) * 1e3
    # 15 % of the DOFs fixed at random hold every rigid mode: K_ff is SPD
    u_f = fx_dense.solve_dense(K_f, jnp.asarray(f), free_mask=jnp.asarray(mask))
    u_p = pt_dense.solve_dense(K_p, torch.from_numpy(f), free_mask=mask)
    _close(u_p, u_f)
    assert np.all(u_p.numpy()[mask == 0] == 0.0)
    fixed = np.flatnonzero(mask == 0)
    presc = np.random.default_rng(7).normal(size=fixed.size) * 1e-6
    _close(pt_dense.partitioned_solve(K_p.numpy(), f, fixed, presc, device="cpu"),
           fx_dense.partitioned_solve(np.asarray(K_f), f, fixed, presc))
    # LU path on a nonsymmetric system
    A = np.random.default_rng(8).normal(size=(40, 40)) + 40 * np.eye(40)
    b = np.random.default_rng(9).normal(size=40)
    _close(pt_dense.solve_dense(torch.from_numpy(A), torch.from_numpy(b), assume_spd=False),
           fx_dense.solve_dense(jnp.asarray(A), jnp.asarray(b), assume_spd=False))
