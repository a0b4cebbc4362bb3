"""The host side of the CUDA kernels, which the CPU reaches: the launch
planner and the packed cell matrix of structured_cell_matmul (the test
re-reads the packed buffer the way the kernels' inner loops do), and
take_rows' plain version against jnp.take at the widths the kernels serve.
The kernels themselves run in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import femx  # noqa: F401  (importing femx enables float64 in JAX)
from femx_torch import gather
from femx_torch.elements import cell_matmul as cm

torch.set_num_threads(2)

LATTICES = [(24, 24, 96), (12, 12, 48), (6, 6, 24), (3, 3, 12), (5, 3, 7), (1, 1, 1),
            (7, 5, 33)]
PLANS = [(torch.float32, "fma"), (torch.float64, "fma"), (torch.float64, "dmma")]
ALL_VARIANTS = sorted({(dt, v) for dt, vs in cm.BUILT.items() for v in vs},
                      key=lambda p: (str(p[0]), p[1].code))


@pytest.mark.parametrize("dtype,family", PLANS)
@pytest.mark.parametrize("n", LATTICES)
@pytest.mark.parametrize("sms", [132, 7])
def test_plan_covers_every_cell_once(n, dtype, family, sms):
    cells = n[0] * n[1] * n[2]
    plan = cm.plan_launch(cells, dtype, sms, family)
    tile = plan.variant.tile
    assert plan.variant in cm.BUILT[dtype]
    assert plan.n_tiles == -(-cells // tile)
    # block b walks tiles b, b + grid, ...; tile t holds cells [t tile, (t + 1) tile)
    seen = np.zeros(cells, dtype=int)
    for b in range(plan.grid):
        for t in range(b, plan.n_tiles, plan.grid):
            seen[t * tile:min((t + 1) * tile, cells)] += 1
    assert (seen == 1).all()
    assert plan.smem == plan.variant.smem_bytes(torch.finfo(dtype).bits // 8)
    assert plan.smem <= cm.MAX_DYNAMIC_SMEM == 232_448
    assert min(sms, plan.n_tiles) <= plan.grid <= plan.n_tiles
    assert plan.variant.threads <= 1024


def test_plan_defaults_and_tiles_follow_the_cell_count():
    assert cm.plan_launch(55_296, torch.float32, 132).variant.family == "fma"
    assert cm.plan_launch(55_296, torch.float64, 132).variant.family == "dmma"
    tiles = [cm.plan_launch(c, torch.float32, 132).variant.tile
             for c in (55_296, 6_912, 864, 108)]
    assert tiles == sorted(tiles, reverse=True) and tiles[0] > tiles[-1]
    # a coarse level still gives every SM a tile where the cells allow it
    assert cm.plan_launch(6_912, torch.float32, 132).grid >= 132


@pytest.mark.parametrize("dtype,variant", ALL_VARIANTS,
                         ids=[f"{str(d)[6:]}-{v.code}" for d, v in ALL_VARIANTS])
def test_every_built_variant_fits_shared_memory(dtype, variant):
    itemsize = torch.finfo(dtype).bits // 8
    assert variant.smem_bytes(itemsize) <= cm.MAX_DYNAMIC_SMEM
    assert cm.blocks_per_sm(variant, itemsize) >= 1
    assert variant.tile % 32 == 0  # the gather works in chunks of 32 cells


def _integer_inputs(dtype, cells=37):
    """Small integers: every product and sum is exact in either type, so
    padding and any summation order must give the same bits."""
    rng = np.random.default_rng(0)
    k = rng.integers(-8, 9, size=(81, 81)).astype(dtype)
    assert not np.array_equal(k, k.T)
    ue = rng.integers(-8, 9, size=(81, cells)).astype(dtype)
    return k, ue


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fma_packing_is_k_major_per_warp(dtype):
    k, ue = _integer_inputs(dtype)
    v = cm.PLANNED[("fma", torch.float32 if dtype == np.float32 else torch.float64)][0]
    kpad = v.kpad(np.dtype(dtype).itemsize)
    packed = cm.pack_kcell(torch.from_numpy(k), v).numpy()
    assert packed.dtype == dtype and packed.size == v.packed_numel(np.dtype(dtype).itemsize)
    assert (kpad * np.dtype(dtype).itemsize) % 16 == 0  # whole 16-byte words
    ks = packed.reshape(81, 9, kpad)
    assert (ks[:, :, 9:] == 0).all()
    # the kernel: warp w, row r of it, depth kk reads ks[kk, w, r]
    fe = np.zeros((81, ue.shape[1]), dtype=dtype)
    for w in range(9):
        for r in range(9):
            fe[9 * w + r] = ks[:, w, r] @ ue
    np.testing.assert_array_equal(fe, k @ ue)


@pytest.mark.parametrize("m8", [1, 2])
def test_dmma_packing_is_fragment_order(m8):
    k, ue = _integer_inputs(np.float64)
    v = next(v for v in cm.BUILT[torch.float64] if (v.family, v.m8) == ("dmma", m8))
    mp, kp = v.padded
    assert mp % (8 * m8) == 0 and kp % 4 == 0 and mp >= 81 and kp >= 81
    packed = cm.pack_kcell(torch.from_numpy(k), v).numpy()
    assert packed.size == mp * kp == v.packed_numel(8)
    # re-read the buffer as the kernel's lanes do: value i of lane 4g + t in
    # product (s, m) is A[8 m8 m + g + 8 i, 4 s + t]
    mt = mp // (8 * m8)
    a = np.full((mp, kp), np.nan)
    for s in range(kp // 4):
        for m in range(mt):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(m8):
                    a[8 * m8 * m + g + 8 * i, 4 * s + t] = packed[((s * mt + m) * 32 + lane) * m8 + i]
    assert not np.isnan(a).any()
    assert (a[81:] == 0).all() and (a[:, 81:] == 0).all()
    ue_pad = np.zeros((kp, ue.shape[1]))
    ue_pad[:81] = ue
    np.testing.assert_array_equal((a @ ue_pad)[:81], k @ ue)


def test_packed_cell_matrix_is_cached_per_tensor_and_version():
    k = torch.from_numpy(_integer_inputs(np.float64)[0])
    v = cm.PLANNED[("dmma", torch.float64)][0]
    first = cm._packed_kcell(k, v)
    assert cm._packed_kcell(k, v) is first
    k.mul_(2.0)  # an in-place edit must not serve the stale copy
    second = cm._packed_kcell(k, v)
    assert second is not first
    torch.testing.assert_close(second, 2.0 * first, rtol=0, atol=0)
    key = (id(k), v.family, v.m8)
    assert key in cm._PACKED
    del k, first, second
    assert key not in cm._PACKED  # dropped with the tensor


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width,shape", [(1, (50,)), (3, (10, 40)), (128, (8, 16)), (0, (7,))])
def test_take_rows_plain_matches_jnp_take(dtype, width, shape):
    """Widths 1, 3 and 128 and a 1-D table (width 0 here), the shapes the
    three take_rows kernels serve, against jnp.take along axis 0."""
    rng = np.random.default_rng(3)
    tab = rng.standard_normal((200, width) if width else (200,)).astype(dtype)
    idx = rng.integers(0, 200, size=shape)
    want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx), axis=0))
    got = gather.take_rows(torch.from_numpy(tab), gather.index_tensor(idx, 200, "cpu"))
    assert got.shape == want.shape and got.dtype == torch.from_numpy(tab).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather.take_rows_plain(torch.from_numpy(tab), torch.from_numpy(idx).int()).numpy(), want)
