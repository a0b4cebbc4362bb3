"""femx_torch transfers, multigrid hierarchy, V-cycle and (refined) PCG ==
femx's on the same systems."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femx.mesh import box_tet10 as fx_box
from femx.solve import multigrid as fx_mg
from femx.solve.cg import pcg as fx_pcg
from femx.solve.cg import pcg_refined as fx_pcg_refined
from femx_torch import convert
from femx_torch.solve import multigrid as pt_mg
from femx_torch.solve.cg import pcg as pt_pcg
from femx_torch.solve.cg import pcg_refined as pt_pcg_refined

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    # femx would read/write its hierarchy cache under $HOME otherwise
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


def _cantilever(dims, ms):
    """tests/test_multigrid.py's face-clamped cantilever with a tip load."""
    mesh = fx_box(*dims, mesh_size=ms)
    mask = np.ones(3 * mesh.num_nodes)
    fixed = np.where(mesh.points[:, 2] < 1e-9)[0]
    mask[(3 * fixed[:, None] + np.arange(3)).ravel()] = 0
    f = np.zeros(3 * mesh.num_nodes)
    tip = np.where(mesh.points[:, 2] > dims[2] - 1e-9)[0]
    f[3 * tip + 1] = -1000.0 / len(tip)
    return mesh, mask, f


def _arrays(op, binv=None):
    """A femx operator (and its block-Jacobi tensors) as numpy arrays."""
    w = {k: None if getattr(op, k) is None else np.asarray(getattr(op, k))
         for k in ("x_weight", "y_weight", "z_weight")}
    out = dict(Kcell=np.asarray(op.Kcell), n_cells=op.n_cells, grid_shape=op.grid_shape,
               weight=op.weight, spacing=op.spacing, free_mask=np.asarray(op.free_mask), **w)
    if binv is not None:
        out["binv"] = [np.asarray(b) for b in binv]
    return out


def _convert(mg):
    return convert.multigrid_from_arrays(
        [_arrays(lv.op, lv.binv) for lv in mg.levels], mg.omegas,
        np.asarray(mg._coarse_inv), mg._coarsen_axes, mg._pad_nodes,
        crop_nodes=mg._crop_nodes, n_smooth=mg.n_smooth, smoother=mg.smoother,
        lmaxs=mg.lmaxs, cheb_lower=mg.cheb_lower, cheb_upper=mg.cheb_upper,
        device="cpu")


def test_transfers_match_and_are_adjoint():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(3, 5, 4, 6))
    f = rng.normal(size=(3, 9, 7, 11))
    for axes in ((1, 2, 3), (3,), (1, 2)):
        fine = (3,) + tuple(2 * n - 1 if i + 1 in axes else n
                            for i, n in enumerate(c.shape[1:]))
        ff = rng.normal(size=fine)
        np.testing.assert_allclose(pt_mg.prolong(torch.from_numpy(c), axes).numpy(),
                                   np.asarray(fx_mg.prolong(jnp.asarray(c), axes)),
                                   rtol=1e-15)
        np.testing.assert_allclose(pt_mg.restrict(torch.from_numpy(ff), axes).numpy(),
                                   np.asarray(fx_mg.restrict(jnp.asarray(ff), axes)),
                                   rtol=1e-15)
    # <R f, c> == <f, P c>
    lhs = float(torch.dot(pt_mg.restrict(torch.from_numpy(f)).ravel(),
                          torch.from_numpy(c).ravel()))
    rhs = float(torch.dot(torch.from_numpy(f).ravel(),
                          pt_mg.prolong(torch.from_numpy(c)).ravel()))
    assert lhs == pytest.approx(rhs, rel=1e-12)


# (dims, mesh_size, constructor kwargs): uniform 2x coarsening; semi-
# coarsening with anisotropic (power-iteration) damping; an odd-cell grid
# that needs ghost padding; the Chebyshev smoother
HIERARCHIES = {
    "uniform": ((0.4, 0.4, 1.6), 0.1, {}),
    "semi": ((0.1, 0.1, 0.8), 0.05, dict(coarse_dof_limit=400, semi_stop_dof=0)),
    "padded": ((0.5, 0.5, 1.0), 0.1, dict(coarse_dof_limit=400, coarse_dense_limit=1500)),
    "chebyshev": ((0.4, 0.4, 0.8), 0.1, dict(smoother="chebyshev")),
}


@pytest.fixture(scope="module", params=sorted(HIERARCHIES))
def pair(request):
    dims, ms, kw = HIERARCHIES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEMX_MG_CACHE", "0")
        mesh, mask, f = _cantilever(dims, ms)
        n = mesh.structured.n_cells
        fx = fx_mg.StructuredMultigrid(dims, n, 2e11, 0.3, mask, dtype=np.float64, **kw)
        pt = pt_mg.StructuredMultigrid(dims, n, 2e11, 0.3, mask, dtype=np.float64,
                                       device="cpu", **kw)
    return request.param, fx, pt, mask, f


def test_hierarchy_matches(pair):
    name, fx, pt, _mask, _f = pair
    assert [lv.op.n_cells for lv in pt.levels] == [lv.op.n_cells for lv in fx.levels]
    assert len(pt.levels) >= 2
    assert pt._coarsen_axes == fx._coarsen_axes
    assert pt._pad_nodes == fx._pad_nodes
    if name == "padded":
        assert any(any(p) for p in pt._pad_nodes)
    np.testing.assert_allclose(pt.omegas, fx.omegas, rtol=1e-12)
    if name == "semi":
        assert min(pt.omegas) < 0.7  # power-iteration damping was exercised
    if fx.lmaxs is not None:
        np.testing.assert_allclose(pt.lmaxs, fx.lmaxs, rtol=1e-12)
    for a, b in zip(fx.levels, pt.levels):
        np.testing.assert_array_equal(b.op.Kcell_host, np.asarray(a.op.Kcell))
        np.testing.assert_array_equal(b.op.free_mask_host, np.asarray(a.op.free_mask))
        for w in ("x_weight", "y_weight", "z_weight"):
            wa, wb = getattr(a.op, w), getattr(b.op, w)
            assert (wa is None) == (wb is None)
            if wa is not None:
                np.testing.assert_array_equal(wb.numpy(), np.asarray(wa))
        for ba, bb in zip(a.binv, b.binv):
            np.testing.assert_array_equal(bb.numpy(), np.asarray(ba))
    ci = np.asarray(fx._coarse_inv)
    np.testing.assert_allclose(pt._coarse_inv.numpy(), ci, rtol=1e-9,
                               atol=np.abs(ci).max() * 1e-12)


def test_vcycle_matches_on_converted_hierarchy(pair):
    _name, fx, pt, _mask, _f = pair
    mg = _convert(fx)
    r = np.random.default_rng(1).normal(size=fx.fine_op.ndof)
    r = r * np.asarray(fx.fine_op.free_mask)
    want = np.asarray(jax.jit(lambda m, v: m(v))(fx, jnp.asarray(r)))
    got = mg(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=np.abs(want).max() * 1e-12)
    # the port's own hierarchy gives the same V-cycle
    got_own = pt(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got_own, want, rtol=1e-9, atol=np.abs(want).max() * 1e-10)


def test_vcycle_matches_with_lane_crop():
    """A lane-padded femx hierarchy (fine level padded in z, gap-0 crop)
    carried across with convert.multigrid_from_arrays."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEMX_MG_CACHE", "0")
        mesh, mask, _f = _cantilever((0.4, 0.4, 1.2), 0.1)  # (4, 4, 12) cells
        g = mesh.structured.grid_shape
        mask_p = np.zeros((g[0], g[1], g[2] + 8, 3))
        mask_p[:, :, :g[2]] = mask.reshape(g[0], g[1], g[2], 3)
        fx = fx_mg.StructuredMultigrid(None, (4, 4, 16), 2e11, 0.3, mask_p.ravel(),
                                       dtype=np.float64, spacing=mesh.structured.spacing,
                                       real_cells=(4, 4, 12))
    assert any(fx._crop_nodes)
    mg = _convert(fx)
    r = np.random.default_rng(2).normal(size=fx.fine_op.ndof) * np.asarray(fx.fine_op.free_mask)
    want = np.asarray(jax.jit(lambda m, v: m(v))(fx, jnp.asarray(r)))
    got = mg(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=np.abs(want).max() * 1e-12)


@pytest.fixture(scope="module")
def f32_system():
    """tests/test_multigrid.py:70-80: f32 MG-PCG on the (4, 4, 16) cantilever."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEMX_MG_CACHE", "0")
        dims = (0.4, 0.4, 1.6)
        mesh, mask, f = _cantilever(dims, 0.1)
        fx = fx_mg.StructuredMultigrid(dims, mesh.structured.n_cells, 2e11, 0.3, mask,
                                       dtype=np.float32)
    op = fx.fine_op
    b64 = op.to_internal(f * mask)
    return fx, _convert(fx), b64


def test_pcg_iterations_match_f32(f32_system):
    fx, mg, b64 = f32_system
    res_fx = jax.jit(lambda b, m: fx_pcg(m.fine_op.apply_constrained, b, M_inv_diag=m,
                                         tol=1e-5, maxiter=100))(
        jnp.asarray(b64, jnp.float32), fx)
    res = pt_pcg(mg.fine_op.apply_constrained, torch.from_numpy(b64.astype(np.float32)),
                 M_inv_diag=mg, tol=1e-5, maxiter=100)
    assert res.converged and bool(res_fx.converged)
    assert res.x.dtype == torch.float32
    assert res.iterations == int(res_fx.iterations)
    assert res.residual_norm == pytest.approx(float(res_fx.residual_norm), rel=1e-3)


def test_pcg_refined_iterations_match_f32(f32_system):
    fx, mg, b64 = f32_system
    op64_fx = fx.fine_op.astype(np.float64)
    res_fx = jax.jit(lambda b, bh, m, o: fx_pcg_refined(
        m.fine_op.apply_constrained, b, M_inv_diag=m, tol=1e-5, maxiter=200,
        refine_steps=6, A_residual=o.apply_constrained, b_residual=bh,
        outer_tol=1e-8))(jnp.asarray(b64, jnp.float32), jnp.asarray(b64), fx, op64_fx)
    op64 = mg.fine_op.astype(np.float64)
    res = pt_pcg_refined(mg.fine_op.apply_constrained,
                         torch.from_numpy(b64.astype(np.float32)), M_inv_diag=mg,
                         tol=1e-5, maxiter=200, refine_steps=6,
                         A_residual=op64.apply_constrained,
                         b_residual=torch.from_numpy(b64), outer_tol=1e-8)
    assert res.x.dtype == torch.float64
    assert res.converged and bool(res_fx.converged)
    assert res.residual_norm <= 1e-8
    assert res.iterations == int(res_fx.iterations)
