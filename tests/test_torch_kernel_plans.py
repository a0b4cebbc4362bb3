"""The host side of the CUDA kernels, which the CPU reaches: the launch
planner and the packed cell matrix of structured_cell_matmul (the test
re-reads the packed buffer the way the kernels' inner loops do), and
take_rows' plain version against jnp.take at the widths the kernels serve,
take_along_axis' launch plan (its tiling emulated in numpy) and the shared
launch path with the C entries stubbed. The kernels themselves run in
tests/test_torch_cuda.py."""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import femx  # noqa: F401  (importing femx enables float64 in JAX)
from femx_torch import gather, launch
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
@pytest.mark.parametrize("width,shape", [(1, (50,)), (2, (10, 6)), (3, (10, 40)),
                                         (128, (8, 16)), (0, (7,))])
def test_take_rows_plain_matches_jnp_take(dtype, width, shape):
    """Widths 1, 3 and 128 and a 1-D table (width 0 here), the shapes the
    three take_rows kernels serve, and the 2D operators' Tri6 gather (rows
    of 2, (E, 6) indices), against jnp.take along axis 0."""
    rng = np.random.default_rng(3)
    tab = rng.standard_normal((200, width) if width else (200,)).astype(dtype)
    idx = rng.integers(0, 200, size=shape)
    want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx), axis=0))
    got = gather.take_rows(torch.from_numpy(tab), gather.index_tensor(idx, 200, "cpu"))
    assert got.shape == want.shape and got.dtype == torch.from_numpy(tab).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather.take_rows_plain(torch.from_numpy(tab), torch.from_numpy(idx).int()).numpy(), want)


# -- take_along_axis: the launch plan (gather.plan_take_along) -----------------
SRC_ALONG = (Path(__file__).resolve().parent.parent / "femx_torch" / "csrc"
             / "take_along_axis.cu").read_text()
LIMIT_H = gather.MAX_DYNAMIC_SMEM // gather.SLAB_BYTES  # 7,264 table rows


def _constexpr(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC_ALONG).group(1))


def test_plan_constants_mirror_the_source():
    assert gather.SLAB_BYTES == _constexpr("kSlabBytes") == 32
    assert gather.SLAB_THREADS == _constexpr("kSlabThreads")
    assert gather.SIMPLE_THREADS == _constexpr("kSimpleThreads")
    assert gather.SIMPLE_PER_THREAD == _constexpr("kSimplePerThread")
    assert gather.MAX_DYNAMIC_SMEM == _constexpr("kMaxDynamicSmem")
    enum = dict((n, int(v)) for n, v in re.findall(r"k(\w+) = (\d+)", re.search(
        r"enum Variant \{([^}]*)\}", SRC_ALONG).group(1)))
    assert enum == {"SlabVec": gather.ALONG_VARIANTS["slab"],
                    "SlabScalar": gather.ALONG_VARIANTS["slab_scalar"],
                    "L2": gather.ALONG_VARIANTS["l2"], "Axis1": gather.ALONG_VARIANTS["axis1"]}
    # the source's slab: kSlabBytes per table row, its swizzle the host's
    assert "return static_cast<size_t>(tab_rows) * kSlabBytes;" in SRC_ALONG
    assert "return k * kS + (c ^ ((k >> 2) & (kS - 1)));" in SRC_ALONG


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("tab_rows,want", [(8, "slab"), (4096, "slab"), (LIMIT_H - 1, "slab"),
                                           (LIMIT_H, "slab"), (LIMIT_H + 1, "l2"),
                                           (20_000, "l2")])
def test_plan_variant_by_table_height(itemsize, tab_rows, want):
    plan = gather.plan_take_along(262_144, 128, tab_rows, 128, 0, itemsize, 132)
    assert plan.variant == want
    if want == "slab":
        assert plan.smem == tab_rows * gather.SLAB_BYTES <= gather.MAX_DYNAMIC_SMEM
        assert plan.n_slabs == 128 // gather.slab_columns(itemsize)
        assert plan.threads == gather.SLAB_THREADS
    else:
        assert plan.smem == 0 and plan.grid == -(-262_144 * 128 // 1024)


@pytest.mark.parametrize("itemsize,cols,aligned,want", [
    (4, 128, True, "slab"), (4, 132, True, "slab"), (4, 130, True, "slab_scalar"),
    (4, 7, True, "slab_scalar"), (4, 50, True, "slab_scalar"), (4, 128, False, "slab_scalar"),
    (8, 130, True, "slab"), (8, 50, True, "slab"), (8, 7, True, "slab_scalar"),
    (8, 128, False, "slab_scalar")])
def test_plan_vector_words_need_whole_aligned_words(itemsize, cols, aligned, want):
    assert gather.plan_take_along(300, cols, 512, cols, 0, itemsize, 132, aligned).variant == want
    assert gather.plan_take_along(300, cols, 512, cols, 1, itemsize, 132,
                                  aligned).variant == "axis1"


def test_plan_fills_the_sms_once_and_refuses_32_bit_overflow():
    # bench_dyngather's sweep: every slab block resident at once
    for h in (8, 32, 128, 512, 2048, 4096):
        plan = gather.plan_take_along(262_144, 128, h, 128, 0, 4, 132)
        per_sm = min(launch.SM_SMEM // (plan.smem + launch.BLOCK_RESERVED_SMEM),
                     2048 // gather.SLAB_THREADS)
        assert plan.grid <= 132 * per_sm and plan.grid > 132 * per_sm - plan.n_slabs
    with pytest.raises(ValueError, match="32 bits"):
        gather.plan_take_along(2 ** 24, 128, 8, 128, 0, 4, 132)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("tab_rows", [1, 5, 32, 100])
def test_slab_swizzle_is_a_bijection_that_spreads_banks(itemsize, tab_rows):
    s = gather.slab_columns(itemsize)
    k, c = np.divmod(np.arange(tab_rows * s), s)
    pos = gather.slab_position(k, c, itemsize)
    assert sorted(pos) == list(range(tab_rows * s))
    # a bank is 4 bytes: float32 bank = pos % 32, float64 bank pair = pos % 16
    banks = 128 // itemsize
    ks = np.arange(banks)
    for col in range(s):  # any one column of `banks` consecutive rows: all banks
        assert len(set(gather.slab_position(ks, col, itemsize) % banks)) == banks
    # the staging: a warp's stores (4 rows of one sector) hit distinct banks
    for k0 in range(0, 32, 4):
        kk, cc = np.divmod(np.arange(4 * s), s)
        assert len(set(gather.slab_position(k0 + kk, cc, itemsize) % banks)) == 4 * s


def _emulate(tab, idx, axis, plan):
    """The kernel's tiling in numpy: which thread writes which output from
    where. Returns the output and how often each element was written."""
    rows, cols = idx.shape
    out = np.full(idx.shape, np.nan, dtype=tab.dtype)
    hits = np.zeros(idx.shape, dtype=int)
    if plan.variant in ("l2", "axis1"):
        per_block = plan.threads * gather.SIMPLE_PER_THREAD
        b, u, t = np.meshgrid(np.arange(plan.grid), np.arange(gather.SIMPLE_PER_THREAD),
                              np.arange(plan.threads), indexing="ij")
        e = (b * per_block + u * plan.threads + t).ravel()
        e = e[e < rows * cols]
        i, j = np.divmod(e, cols)
        k = idx.ravel()[e]
        out.ravel()[e] = tab[k, j] if axis == 0 else tab[i, k]
        np.add.at(hits.ravel(), e, 1)
        return out, hits
    s = gather.slab_columns(tab.itemsize)
    vec = plan.variant == "slab"
    chunk = gather.word_columns(tab.itemsize) if vec else 1
    lanes = s // chunk                       # threads across one row of the slab
    step = plan.threads // lanes             # rows between a thread's rows
    t = np.arange(plan.threads)
    for b in range(plan.grid):
        c0 = (b % plan.n_slabs) * s
        r_begin = (b // plan.n_slabs) * plan.rows_per_block
        r_end = min(rows, r_begin + plan.rows_per_block)
        slab = np.full(tab.shape[0] * s, np.nan, dtype=tab.dtype)
        k, c = np.divmod(np.arange(tab.shape[0] * s), s)
        m = c0 + c < cols
        slab[gather.slab_position(k[m], c[m], tab.itemsize)] = tab[k[m], c0 + c[m]]
        for j in range(chunk):
            col = chunk * (t % lanes) + j  # column within the slab
            live = c0 + chunk * (t % lanes) < cols if vec else c0 + col < cols
            r = r_begin + (t // lanes)[:, None] + step * np.arange(
                -(-plan.rows_per_block // step))[None, :]
            rr, cc = np.broadcast_arrays(r, col[:, None])
            keep = live[:, None] & (rr < r_end)
            rr, cc = rr[keep], cc[keep]
            out[rr, c0 + cc] = slab[gather.slab_position(idx[rr, c0 + cc], cc, tab.itemsize)]
            np.add.at(hits, (rr, c0 + cc), 1)
    return out, hits


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("tab_rows", [8, 37, 512])
@pytest.mark.parametrize("cols", [7, 50, 128, 130, 132])
@pytest.mark.parametrize("sms", [1, 3])
def test_slab_tiling_covers_every_output_once(dtype, tab_rows, cols, sms):
    rng = np.random.default_rng(5)
    rows = 3 * tab_rows + 11
    tab = rng.standard_normal((tab_rows, cols)).astype(dtype)
    idx = rng.integers(0, tab_rows, size=(rows, cols)).astype(np.int32)
    plan = gather.plan_take_along(rows, cols, tab_rows, cols, 0, tab.itemsize, sms)
    assert plan.variant == ("slab" if cols % (16 // tab.itemsize) == 0 else "slab_scalar")
    out, hits = _emulate(tab, idx, 0, plan)
    assert (hits == 1).all()
    np.testing.assert_array_equal(out, np.take_along_axis(tab, idx, 0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis,tab_shape,idx_shape", [(0, (LIMIT_H + 1, 6), (700, 6)),
                                                      (1, (8, 128), (8, 128)),
                                                      (1, (6, 50), (6, 7))])
def test_simple_tiling_covers_every_output_once(dtype, axis, tab_shape, idx_shape):
    rng = np.random.default_rng(6)
    tab = rng.standard_normal(tab_shape).astype(dtype)
    idx = rng.integers(0, tab_shape[axis], size=idx_shape).astype(np.int32)
    plan = gather.plan_take_along(*idx_shape, *tab_shape, axis, tab.itemsize, 132)
    assert plan.variant == ("l2" if axis == 0 else "axis1")
    out, hits = _emulate(tab, idx, axis, plan)
    assert (hits == 1).all()
    np.testing.assert_array_equal(out, np.take_along_axis(tab, idx, axis))


# -- the shared launch path (femx_torch/launch.py), with the C entry and the
# stream getter stubbed ---------------------------------------------------------
@pytest.fixture
def stubbed_launch(monkeypatch):
    """Every C entry replaced by a recorder returning `rc[0]`; streams 100,
    101, ... one per read; device 0 current; device guards recorded."""
    calls, guards, rc = [], [], [0]
    streams = iter(range(100, 10_000))

    def bind(library, symbol, argtypes, counter, key):
        def fn(*args):
            calls.append((symbol, args))
            return rc[0]
        return launch.Entry(library, fn, counter, key)

    @contextlib.contextmanager
    def device(index):
        guards.append(index)
        yield

    monkeypatch.setattr(launch, "bind", bind)
    monkeypatch.setattr(launch, "_raw_stream", lambda index: next(streams))
    monkeypatch.setattr(launch, "_current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(gather, "_ENTRIES", {})
    monkeypatch.setattr(cm, "_ENTRIES", {})
    return calls, guards, rc


@pytest.mark.parametrize("kernel,dtype,symbol", [
    ("take_rows", torch.float32, "femx_take_rows_f32"),
    ("take_along_axis", torch.float64, "femx_take_along_axis_f64"),
    ("row_copy", torch.float32, "femx_row_copy_f32"),
    ("slot_copy_in", torch.float32, "femx_slot_copy_in_f32"),
    ("slot_copy_out", torch.float64, "femx_slot_copy_out_f64")])
def test_launch_reads_the_stream_every_call_and_counts_once(stubbed_launch, kernel, dtype,
                                                            symbol):
    calls, guards, rc = stubbed_launch
    key = f"{kernel}/{str(dtype)[6:]}"
    before = gather.LAUNCHES[key]
    entry = gather._entry(kernel, dtype)
    assert entry is gather._entry(kernel, dtype) and entry.key == key
    for _ in range(3):
        launch.launch(entry, 0, 1, 2, 3)
    assert calls == [(symbol, (1, 2, 3, s)) for s in (100, 101, 102)]
    assert gather.LAUNCHES[key] == before + 3 and guards == []
    launch.launch(entry, 1, 7)  # another device than the current one: guarded
    assert guards == [1] and calls[-1] == (symbol, (7, 103))
    rc[0] = 1001  # a refused plan raises and counts nothing
    with pytest.raises(RuntimeError, match="1001"):
        launch.launch(entry, 0, 1)
    assert gather.LAUNCHES[key] == before + 4
    gather.LAUNCHES[key] = before


def test_slot_kernels_bind_from_one_library(stubbed_launch, monkeypatch):
    """slot_set (no dtype), slot_copy_in and slot_copy_out are entries of
    csrc/slot_copy.cu; slot_set counts under its bare name."""
    libraries = []
    bind = launch.bind
    monkeypatch.setattr(launch, "bind", lambda library, *a: libraries.append(library)
                        or bind(library, *a))
    calls, _, _ = stubbed_launch
    entry = gather._entry("slot_set", None)
    assert entry.key == "slot_set" and entry.counter is gather.LAUNCHES
    before = gather.LAUNCHES["slot_set"]
    launch.launch(entry, 0, 1, 2, 3)
    assert calls == [("femx_slot_set", (1, 2, 3, 100))]
    assert gather.LAUNCHES["slot_set"] == before + 1
    gather.LAUNCHES["slot_set"] = before
    gather._entry("slot_copy_in", torch.float64)
    gather._entry("slot_copy_out", torch.float32)
    gather._entry("row_copy", torch.float32)
    assert libraries == ["slot_copy"] * 3 + ["row_copy"]


def test_slot_wrappers_refuse_cpu_tensors_and_bad_tables():
    slots, buf = torch.zeros(2, dtype=torch.int64), torch.zeros(8)
    for fn, args in ((gather.slot_set, (slots, 0, 0)), (gather.slot_copy_in, (slots, buf)),
                     (gather.slot_copy_out, (slots, buf))):
        with pytest.raises(RuntimeError, match="no slot_.* kernel for device cpu"):
            fn(*args)
    with pytest.raises(ValueError, match="int64 tensor of 2"):
        gather.slot_copy_in(torch.zeros(3, dtype=torch.int64), buf)
    with pytest.raises(TypeError, match="float32 or float64"):
        gather.slot_copy_out(slots, torch.zeros(8, dtype=torch.int32))


def test_cell_matmul_launches_through_the_shared_path(stubbed_launch):
    calls, guards, _ = stubbed_launch
    before = cm.LAUNCHES["float32"]
    entry = cm._entry(torch.float32)
    assert entry.key == "float32" and entry.counter is cm.LAUNCHES
    launch.launch(entry, 0, 5)
    launch.launch(entry, 0, 6)
    assert calls == [("femx_structured_cell_matmul_f32", (5, 100)),
                     ("femx_structured_cell_matmul_f32", (6, 101))]
    assert cm.LAUNCHES["float32"] == before + 2 and guards == []
    cm.LAUNCHES["float32"] = before
