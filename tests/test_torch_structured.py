"""femx_torch structured operator == femx's StructuredSolidOperator (f64)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femx.assembly_structured import StructuredSolidOperator as FxOp
from femx.assembly_structured import _cell_stiffness as fx_cell_stiffness
from femx.mesh import box_tet10 as fx_box
from femx_torch.assembly_structured import StructuredSolidOperator as PtOp
from femx_torch.assembly_structured import _cell_stiffness as pt_cell_stiffness
from femx_torch.mesh import box_tet10 as pt_box

torch.set_num_threads(2)

RTOL = 1e-13  # summation order of the 81x81 products differs (BLAS vs XLA)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=np.abs(want).max() * 1e-14)


@pytest.mark.parametrize("spacing,weight", [
    ((0.1, 0.1, 0.1), 1.0 / 24.0),
    ((0.05, 0.07, 0.06), 0.25),
    ((1.0 / 11, 0.03, 0.09), 1.0 / 24.0),
])
def test_cell_stiffness_matches(spacing, weight):
    a = fx_cell_stiffness(spacing, 2e11, 0.3, weight, np.float64)
    b = pt_cell_stiffness(spacing, 2e11, 0.3, weight, np.float64)
    np.testing.assert_allclose(b, a, rtol=1e-14, atol=np.abs(a).max() * 1e-14)


def _mask(ndof, seed):
    m = np.ones(ndof)
    m[np.random.default_rng(seed).choice(ndof, ndof // 10, replace=False)] = 0.0
    return m


@pytest.fixture(scope="module")
def ops():
    """femx and port operators on the tests/test_pallas.py grid, with the
    same random free mask."""
    fx = FxOp.from_mesh(fx_box(1.6, 0.3, 0.4, 0.1), 2e11, 0.3, dtype=np.float64)
    pt = PtOp.from_mesh(pt_box(1.6, 0.3, 0.4, 0.1), 2e11, 0.3, dtype=np.float64,
                        device="cpu")
    m_int = fx.to_internal(_mask(fx.ndof, 1))
    return fx.with_free_mask(m_int), pt.with_free_mask(m_int)


def _weighted(fx, pt, nx_w, ny_w, nz_w):
    fxw = dataclasses.replace(fx, x_weight=jnp.asarray(nx_w), y_weight=jnp.asarray(ny_w),
                              z_weight=jnp.asarray(nz_w))
    ptw = PtOp.from_host(pt.Kcell_host, pt.n_cells, pt.weight, spacing=pt.spacing,
                         free_mask=pt.free_mask_host, x_weight=nx_w, y_weight=ny_w,
                         z_weight=nz_w, device="cpu")
    return fxw, ptw


def test_layout_matches(ops):
    fx, pt = ops
    assert pt.n_cells == fx.n_cells == (16, 3, 4)
    assert pt.grid_shape == fx.grid_shape and pt.ndof == fx.ndof
    assert pt._phase_offsets() == fx._phase_offsets()
    np.testing.assert_array_equal(pt._permutation(), fx._permutation())
    x = np.random.default_rng(2).normal(size=fx.ndof)
    np.testing.assert_array_equal(pt.to_internal(x), fx.to_internal(x))
    np.testing.assert_array_equal(pt.to_global(x), fx.to_global(x))
    np.testing.assert_array_equal(pt.to_global(pt.to_internal(x)), x)


@pytest.mark.parametrize("weighted", [False, True])
def test_apply_and_constrained_match(ops, weighted):
    fx, pt = ops
    if weighted:  # ghost-padded style layer weights: fractional and zero
        rng = np.random.default_rng(3)
        fx, pt = _weighted(fx, pt, np.clip(rng.uniform(-0.2, 1.2, 16), 0, 1),
                           np.array([1.0, 0.5, 0.0]), np.array([1.0, 1.0, 0.25, 0.0]))
    u = np.random.default_rng(0).normal(size=fx.ndof)
    _close(pt.apply(torch.from_numpy(u)), fx.apply(jnp.asarray(u)))
    _close(pt.apply_constrained(torch.from_numpy(u)), fx.apply_constrained(jnp.asarray(u)))


@pytest.mark.parametrize("weighted", [False, True])
def test_block_jacobi_matches(ops, weighted):
    fx, pt = ops
    if weighted:
        fx, pt = _weighted(fx, pt, np.linspace(1.0, 0.25, 16), np.ones(3),
                           np.array([1.0, 1.0, 0.5, 0.5]))
    np.testing.assert_allclose(pt.block_diagonal_internal(), fx.block_diagonal_internal(),
                               rtol=1e-14)
    b_fx = fx.block_jacobi_tensors()
    b_pt = pt.block_jacobi_tensors()
    for a, b in zip(b_fx, b_pt):
        np.testing.assert_array_equal(b, a)
    r = np.random.default_rng(4).normal(size=fx.ndof)
    want = fx.apply_block_jacobi([jnp.asarray(b) for b in b_fx], jnp.asarray(r))
    got = pt.apply_block_jacobi([torch.from_numpy(b) for b in b_pt], torch.from_numpy(r))
    _close(got, want)


def test_astype_coarsened_and_f32_apply(ops):
    fx, pt = ops
    pt32, fx32 = pt.astype(np.float32), fx.astype(np.float32)
    assert pt32.Kcell.dtype == torch.float32 and pt32.free_mask.dtype == torch.float32
    np.testing.assert_array_equal(pt32.Kcell_host, np.asarray(fx32.Kcell))
    np.testing.assert_array_equal(pt32.free_mask_host, np.asarray(fx32.free_mask))
    assert pt32.astype(np.float64).Kcell.dtype == torch.float64
    u = np.random.default_rng(5).normal(size=fx.ndof).astype(np.float32)
    got = pt32.apply_constrained(torch.from_numpy(u)).numpy()
    want = np.asarray(fx32.apply_constrained(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=np.abs(want).max() * 1e-6)

    fx8 = FxOp.from_lattice((4, 2, 6), (0.05, 0.07, 0.06), 2e11, 0.3, dtype=np.float64)
    pt8 = PtOp.from_lattice((4, 2, 6), (0.05, 0.07, 0.06), 2e11, 0.3, dtype=np.float64,
                            device="cpu")
    fc, pc = fx8.coarsened(), pt8.coarsened()
    assert pc.n_cells == fc.n_cells == (2, 1, 3)
    assert pc.spacing == pytest.approx(fc.spacing, rel=1e-15)
    np.testing.assert_array_equal(pc.Kcell_host, np.asarray(fc.Kcell))
    with pytest.raises(ValueError, match="divisible"):
        pc.coarsened()
