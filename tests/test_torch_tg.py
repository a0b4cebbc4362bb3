"""femx_torch SoA kernels, SolidOperatorSoA and the transpose-gather
SolidOperatorTG == femx's on a relabelled box: the same relabelling and
degree buckets, and apply, diagonal and block-Jacobi to 1e-12 relative in
float64, both for the port's own build and for femx's arrays carried across
with femx_torch.convert; block-Jacobi PCG takes femx's iteration count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femx.assembly_soa import SolidOperatorSoA as FxSoA
from femx.assembly_tg import SolidOperatorTG as FxTG
from femx.elements import tet10_soa as fx_soa
from femx.mesh import box_tet10 as fx_box
from femx.solve.cg import pcg as fx_pcg
from femx_torch import convert
from femx_torch.assembly_soa import SolidOperatorSoA as PtSoA
from femx_torch.assembly_tg import SolidOperatorTG as PtTG
from femx_torch.elements import tet10_soa as pt_soa
from femx_torch.elements.tet10 import material_matrix
from femx_torch.gather import take_rows
from femx_torch.solve.cg import pcg as pt_pcg

torch.set_num_threads(2)

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=np.abs(want).max() * rtol)


@pytest.fixture(scope="module")
def scrambled():
    """tests/test_assembly_tg.py's relabelled box, with a random DOF mask."""
    mesh = fx_box(0.3, 0.2, 0.4, mesh_size=0.1)
    conn = np.asarray(mesh.cells["tetra10"])
    pts = np.asarray(mesh.points)
    relabel = np.random.default_rng(0).permutation(len(pts))
    pts_s = np.empty_like(pts)
    pts_s[relabel] = pts
    mask = (np.random.default_rng(1).random(3 * len(pts)) > 0.1).astype(np.float64)
    return pts_s, relabel[conn], mask


def test_soa_kernels_match(scrambled):
    pts, conn, _ = scrambled
    pts = pts + np.random.default_rng(2).uniform(-0.005, 0.005, pts.shape)
    c = fx_soa.coords_soa(pts, conn, np.float64)
    np.testing.assert_array_equal(pt_soa.coords_soa(pts, conn, np.float64), c)
    np.testing.assert_array_equal(pt_soa.dof_table(conn), fx_soa.dof_table(conn))
    a = fx_soa.geometry(jnp.asarray(c))
    b = pt_soa.geometry(torch.from_numpy(c))
    for x, y in zip(a, b):
        _close(y, x)
    C6 = material_matrix(2e11, 0.3)
    ue = np.random.default_rng(3).normal(size=(30, conn.shape[0]))
    _close(pt_soa.apply_element_forces(b[0], b[1], C6, torch.from_numpy(ue), 0.25),
           fx_soa.apply_element_forces(a[0], a[1], C6, jnp.asarray(ue), 0.25))
    chat = fx_soa.chat_numpy(C6)
    np.testing.assert_allclose(pt_soa.chat_numpy(C6), chat, rtol=1e-15)
    _close(pt_soa.block_diagonal_entries(b[0], b[1], chat),
           fx_soa.block_diagonal_entries(a[0], a[1], chat))


def test_soa_operator_matches(scrambled):
    pts, conn, mask = scrambled
    fx, dfx = FxSoA.from_mesh(pts, conn, 2e11, 0.3, dtype=np.float64)
    pt, dpt = PtSoA.from_mesh(pts, conn, 2e11, 0.3, dtype=np.float64, device="cpu")
    _close(dpt, dfx)
    fx, pt = fx.with_free_mask(jnp.asarray(mask)), pt.with_free_mask(mask)
    u = np.random.default_rng(4).normal(size=pt.ndof)
    _close(pt.apply_constrained(torch.from_numpy(u)), fx.apply_constrained(jnp.asarray(u)))
    _close(pt.diagonal(), fx.diagonal())
    _close(pt.block_jacobi_tensors(), fx.block_jacobi_tensors())
    _close(pt.block_jacobi_preconditioner()(torch.from_numpy(u)),
           fx.block_jacobi_preconditioner()(jnp.asarray(u)))
    p32 = pt.astype(np.float32)
    assert p32.dNg.dtype == torch.float32 and p32.C6.dtype == np.float32
    _close(p32.apply_constrained(torch.from_numpy(u.astype(np.float32))),
           fx.astype(np.float32).apply_constrained(jnp.asarray(u, jnp.float32)), rtol=1e-5)


@pytest.fixture(scope="module")
def tg_pair(scrambled):
    pts, conn, mask = scrambled
    fx, dfx = FxTG.from_mesh(pts, conn, 2e11, 0.3, dtype=np.float64)
    pt, dpt = PtTG.from_mesh(pts, conn, 2e11, 0.3, dtype=np.float64, device="cpu")
    _close(dpt, dfx)
    m_int = fx.to_internal(mask)
    return fx.with_free_mask(jnp.asarray(m_int)), pt.with_free_mask(m_int), mask


def _carried(fx):
    """femx's TG operator carried across as arrays."""
    return convert.tg_operator_from_arrays(
        np.asarray(fx.soa.dNg), np.asarray(fx.soa.wdet), fx.soa.C6, np.asarray(fx.connT),
        [np.asarray(b) for b in fx.bucket_idx], fx.bucket_degrees, fx.new_of_old,
        fx.soa.weight, free_mask=np.asarray(fx.free_mask), device="cpu")


def test_tg_build_matches_femx(tg_pair):
    fx, pt, _ = tg_pair
    np.testing.assert_array_equal(pt.new_of_old, fx.new_of_old)
    np.testing.assert_array_equal(pt.connT.numpy(), np.asarray(fx.connT))
    assert pt.bucket_degrees == fx.bucket_degrees
    for a, b in zip(fx.bucket_idx, pt.bucket_idx):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert pt.gathers_per_apply == 1 + sum(1 for d in fx.bucket_degrees if d)
    x = np.arange(pt.ndof, dtype=np.float64)
    np.testing.assert_array_equal(pt.to_internal(x), fx.to_internal(x))
    np.testing.assert_array_equal(pt.to_global(pt.to_internal(x)), x)


@pytest.mark.parametrize("carried", [False, True])
def test_tg_apply_diagonal_and_block_jacobi_match(tg_pair, carried):
    fx, pt, _ = tg_pair
    if carried:
        pt = _carried(fx)
    u = np.random.default_rng(5).normal(size=pt.ndof)
    _close(pt.apply(torch.from_numpy(u)), fx.apply(jnp.asarray(u)))
    _close(pt.apply_constrained(torch.from_numpy(u)), fx.apply_constrained(jnp.asarray(u)))
    _close(pt.diagonal(), fx.diagonal())
    _close(pt.block_jacobi_preconditioner()(torch.from_numpy(u)),
           fx.block_jacobi_preconditioner()(jnp.asarray(u)))


def test_tg_row_gathers_are_take_rows(tg_pair):
    """The apply's gathers through take_rows equal numpy's fancy indexing
    (the CPU runs the plain version; tests/test_torch_cuda.py holds the
    kernel to it on the card)."""
    _, pt, _ = tg_pair
    u3 = np.random.default_rng(6).normal(size=(pt.n_nodes, 3))
    np.testing.assert_array_equal(take_rows(torch.from_numpy(u3), pt.connT).numpy(),
                                  u3[pt.connT.numpy()])


def test_tg_f32_and_pcg_match(tg_pair):
    fx, pt, mask = tg_pair
    p32 = pt.astype(np.float32)
    assert p32.dtype == torch.float32 and p32.astype(np.float32) is p32
    u = np.random.default_rng(7).normal(size=pt.ndof).astype(np.float32)
    _close(p32.apply_constrained(torch.from_numpy(u)),
           fx.astype(np.float32).apply_constrained(jnp.asarray(u)), rtol=1e-5)
    f = np.random.default_rng(8).normal(size=pt.ndof) * np.asarray(fx.free_mask) * 1e3
    rf = fx_pcg(fx.apply_constrained, jnp.asarray(f), M_inv_diag=fx.block_jacobi_preconditioner(),
                tol=1e-10, maxiter=4000)
    rp = pt_pcg(pt.apply_constrained, torch.from_numpy(f),
                M_inv_diag=pt.block_jacobi_preconditioner(), tol=1e-10, maxiter=4000)
    assert rp.converged and rp.iterations == int(rf.iterations)
    _close(rp.x, rf.x, rtol=1e-9)
