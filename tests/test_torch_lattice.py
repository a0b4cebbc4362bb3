"""femx_torch lattice preconditioner == femx's on tests/test_lattice_precond.py's
problem: the same lattice, transfer structure and hierarchy; both transfers,
coarse_correct and the preconditioner in all three modes to 1e-11 relative
(femx's preconditioner carried across with femx_torch.convert); PCG and FCG
take femx's iteration counts."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femx.assembly_tg import SolidOperatorTG as FxTG
from femx.mesh import box_tet10 as fx_box
from femx.solve import lattice_precond as fx_lp
from femx.solve.cg import fcg as fx_fcg
from femx.solve.cg import pcg as fx_pcg
from femx_torch import convert
from femx_torch.assembly_soa import SolidOperatorSoA
from femx_torch.assembly_tg import SolidOperatorTG as PtTG
from femx_torch.solve import lattice_precond as pt_lp
from femx_torch.solve.cg import fcg as pt_fcg
from femx_torch.solve.cg import pcg as pt_pcg

torch.set_num_threads(2)

RTOL = 1e-11


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=np.abs(want).max() * rtol)


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


def _problem(mesh_size=0.025, dims=(0.1, 0.1, 0.4)):
    """tests/test_lattice_precond.py:14-33: a relabelled face-clamped bar
    with a tip load, on femx's and the port's TG operators."""
    mesh = fx_box(*dims, mesh_size=mesh_size)
    conn = np.asarray(mesh.cells["tetra10"])
    pts = np.asarray(mesh.points)
    relabel = np.random.default_rng(0).permutation(len(pts))
    pts_s = np.empty_like(pts)
    pts_s[relabel] = pts
    conn_s = relabel[conn]
    fx, _ = FxTG.from_mesh(pts_s, conn_s, 2e11, 0.3, dtype=np.float64)
    pt, _ = PtTG.from_mesh(pts_s, conn_s, 2e11, 0.3, dtype=np.float64, device="cpu")
    mask = np.ones(fx.ndof)
    for n in np.where(pts_s[:, 2] < 1e-9)[0]:
        mask[3 * n:3 * n + 3] = 0
    m_int = fx.to_internal(mask)
    f = np.zeros(fx.ndof)
    tips = np.where(pts_s[:, 2] > dims[2] - 1e-9)[0]
    f[3 * tips + 1] = -1000.0 / len(tips)
    return (pts_s, conn_s, mask, fx.with_free_mask(jnp.asarray(m_int)),
            pt.with_free_mask(m_int), fx.to_internal(f * mask))


@pytest.fixture(scope="module")
def problem():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEMX_MG_CACHE", "0")
        pts, conn, mask, fx_op, pt_op, f_int = _problem()
        fx_bj = fx_op.soa.block_jacobi_tensors()
        fx = fx_lp.LatticePreconditioner(pts, conn, 2e11, 0.3, mask, dtype=np.float64,
                                         node_perm=fx_op.new_of_old,
                                         bj_fn=type(fx_op.soa).apply_block_jacobi,
                                         bj_data=fx_bj)
    pt = pt_lp.LatticePreconditioner(pts, conn, 2e11, 0.3, mask, dtype=np.float64,
                                     node_perm=pt_op.new_of_old,
                                     bj_fn=SolidOperatorSoA.apply_block_jacobi,
                                     bj_data=pt_op.soa.block_jacobi_tensors(), device="cpu")
    return dict(pts=pts, conn=conn, mask=mask, fx_op=fx_op, pt_op=pt_op, f=f_int,
                fx=fx, pt=pt, fx_bj=fx_bj)


def _mg_arrays(mg):
    def op_arrays(op, binv):
        w = {k: None if getattr(op, k) is None else np.asarray(getattr(op, k))
             for k in ("x_weight", "y_weight", "z_weight")}
        return dict(Kcell=np.asarray(op.Kcell), n_cells=op.n_cells, grid_shape=op.grid_shape,
                    weight=op.weight, spacing=op.spacing, free_mask=np.asarray(op.free_mask),
                    binv=[np.asarray(b) for b in binv], **w)

    return dict(levels=[op_arrays(lv.op, lv.binv) for lv in mg.levels], omegas=mg.omegas,
                coarse_inv=np.asarray(mg._coarse_inv), coarsen_axes=mg._coarsen_axes,
                pad_nodes=mg._pad_nodes, crop_nodes=mg._crop_nodes, n_smooth=mg.n_smooth,
                smoother=mg.smoother, lmaxs=mg.lmaxs, cheb_lower=mg.cheb_lower,
                cheb_upper=mg.cheb_upper)


def _transfer_arrays(t):
    if isinstance(t, fx_lp.LatticeTransferPruned):
        return dict(n_idx=[np.asarray(b) for b in t.n_idx], n_w=[np.asarray(b) for b in t.n_w],
                    node_rank=np.asarray(t.node_rank), l_idx=[np.asarray(b) for b in t.l_idx],
                    l_w=[np.asarray(b) for b in t.l_w], lat_rank=np.asarray(t.lat_rank),
                    phase_counts=t.phase_counts)
    return dict(idx=np.asarray(t.idx), w=np.asarray(t.w),
                bucket_idx=[[np.asarray(b) for b in bp] for bp in t.bucket_idx],
                bucket_w=[[np.asarray(b) for b in bp] for bp in t.bucket_w],
                perm_back=[np.asarray(p) for p in t.perm_back], phase_counts=t.phase_counts)


def test_construction_matches(problem):
    fx, pt = problem["fx"], problem["pt"]
    assert pt.n_cells == fx.n_cells and pt.n_cal == fx.n_cal
    assert pt.spacing == pytest.approx(fx.spacing, rel=1e-15)
    assert isinstance(fx.transfer, fx_lp.LatticeTransferPruned)
    assert isinstance(pt.transfer, pt_lp.LatticeTransferPruned)
    for key, want in _transfer_arrays(fx.transfer).items():
        got = getattr(pt.transfer, key)
        if key == "phase_counts":
            assert tuple(got) == tuple(want)
        elif isinstance(want, list):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pt._mask_cal.numpy(), np.asarray(fx._mask_cal))
    np.testing.assert_array_equal(pt._lat_mask.numpy(), np.asarray(fx._lat_mask))
    assert [lv.op.n_cells for lv in pt.mg.levels] == [lv.op.n_cells for lv in fx.mg.levels]
    assert pt.launches_per_call() == {
        "take_rows": sum(1 for b in fx.transfer.n_idx if b.shape[1]) + 1
        + sum(1 for b in fx.transfer.l_idx if b.shape[1]) + 1,
        "structured_cell_matmul": 2 * 5 * (len(fx.mg.levels) - 1) + 1}


@pytest.mark.parametrize("kind", ["pruned", "dense", "jittered"])
def test_transfers_match(problem, kind):
    fx, pt_op = problem["fx"], problem["pt_op"]
    pts, n = problem["pts"], pt_op.n_nodes
    gs = fx.mg.fine_op.grid_shape
    lo = pts.min(axis=0)
    half_h = np.asarray(fx.spacing) / 2.0
    pts_cal = pts[np.argsort(pt_op.new_of_old, kind="stable")]
    rng = np.random.default_rng(3)
    if kind == "jittered":
        pts_cal = pts_cal + rng.uniform(-0.3, 0.3, pts_cal.shape) * half_h[None, :]
        lo = pts_cal.min(axis=0)
    if kind == "dense":
        t_fx = fx_lp.build_lattice_transfer(pts_cal, lo, half_h, gs, dtype=np.float64)
        t_pt = pt_lp.build_lattice_transfer(pts_cal, lo, half_h, gs, dtype=np.float64,
                                            device="cpu")
    else:
        t_fx = fx_lp.build_lattice_transfer_pruned(pts_cal, lo, half_h, gs, dtype=np.float64)
        t_pt = pt_lp.build_lattice_transfer_pruned(pts_cal, lo, half_h, gs, dtype=np.float64,
                                                   device="cpu")
    t_cv = convert.lattice_transfer_from_arrays(_transfer_arrays(t_fx), device="cpu")
    e = rng.standard_normal(3 * int(np.prod(gs)))
    r = rng.standard_normal(3 * n)
    want_i = jax.jit(lambda t, v: t.interpolate(v, n))(t_fx, jnp.asarray(e))
    want_r = jax.jit(lambda t, v: t.restrict(v))(t_fx, jnp.asarray(r))
    for t in (t_pt, t_cv):
        _close(t.interpolate(torch.from_numpy(e), n), want_i)
        _close(t.restrict(torch.from_numpy(r)), want_r)
    # adjoint pair
    lhs = float(torch.dot(t_pt.restrict(torch.from_numpy(r)), torch.from_numpy(e)))
    rhs = float(torch.dot(torch.from_numpy(r), t_pt.interpolate(torch.from_numpy(e), n)))
    assert lhs == pytest.approx(rhs, rel=1e-10)


@pytest.fixture(scope="module")
def omega(problem):
    fx_op = problem["fx_op"]
    lam_fx = fx_lp.estimate_bj_lambda_max(fx_op, type(fx_op.soa).apply_block_jacobi,
                                          problem["fx_bj"])
    lam_pt = pt_lp.estimate_bj_lambda_max(problem["pt_op"], SolidOperatorSoA.apply_block_jacobi,
                                          problem["pt_op"].soa.block_jacobi_tensors())
    assert lam_pt == pytest.approx(lam_fx, rel=1e-10)
    return 1.0 / lam_fx


def _pair(problem, mode, omega):
    """femx's preconditioner in `mode` and the port's copy of it (convert)."""
    fx0, fx_op = problem["fx"], problem["fx_op"]
    om = omega if mode == "mult_sym" else None
    fx = copy.copy(fx0)  # the same lattice hierarchy and transfers, another mode
    fx.mode, fx.op = mode, None if mode == "add" else fx_op
    fx.omega = None if om is None else jnp.asarray(om)
    pt = convert.lattice_preconditioner_from_arrays(
        _mg_arrays(fx0.mg), _transfer_arrays(fx0.transfer), np.asarray(fx0._mask_cal),
        np.asarray(problem["fx_bj"]), fx0.n_nodes, fx0.n_cells, fx0.spacing, mode=mode,
        op=None if mode == "add" else problem["pt_op"], omega=om, n_cal=fx0.n_cal,
        device="cpu")
    return fx, pt


@pytest.mark.parametrize("mode", ["add", "mult", "mult_sym"])
def test_coarse_correct_and_call_match(problem, omega, mode):
    fx, pt = _pair(problem, mode, omega)
    m_int = np.asarray(problem["fx_op"].free_mask)
    r = np.random.default_rng(4).standard_normal(m_int.size) * m_int
    want = fx(jnp.asarray(r))
    _close(pt(torch.from_numpy(r)), want)
    if mode == "add":  # the coarse correction is the same in every mode
        _close(pt.coarse_correct(torch.from_numpy(r)), fx.coarse_correct(jnp.asarray(r)))
        # the port's own build gives the same preconditioner
        _close(problem["pt"](torch.from_numpy(r)), want)


@pytest.mark.parametrize("mode,solver", [("add", "pcg"), ("mult", "fcg")])
def test_krylov_iterations_match(problem, omega, mode, solver):
    fx, pt = _pair(problem, mode, omega)
    fx_op, pt_op, f = problem["fx_op"], problem["pt_op"], problem["f"]
    fx_solve, pt_solve = (fx_pcg, pt_pcg) if solver == "pcg" else (fx_fcg, pt_fcg)
    rf = fx_solve(fx_op.apply_constrained, jnp.asarray(f), fx, tol=1e-9, maxiter=2000)
    rp = pt_solve(pt_op.apply_constrained, torch.from_numpy(f), pt, tol=1e-9, maxiter=2000)
    assert rp.converged and bool(rf.converged)
    assert rp.iterations == int(rf.iterations)
    _close(rp.x, rf.x, rtol=1e-8)
