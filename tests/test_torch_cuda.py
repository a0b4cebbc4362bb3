"""femx_torch on a CUDA card: each hand-written kernel against its plain
version (structured_cell_matmul within a tolerance; take_rows,
take_along_axis and row_copy exactly), the example repros, and the
structured, transpose-gather, group-ELL and cluster applies and solves
against the same runs on the CPU. Every test here carries the `cuda`
marker and skips without a card.

This file imports neither jax nor femx, so it also runs on a GPU machine
without JAX; tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import re

import numpy as np
import pytest
import torch

import femx_torch
from femx_torch import gather
from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.assembly_tg import SolidOperatorTG
from femx_torch.elements import cell_matmul as cm
from femx_torch.examples import gather_repros, mosaic_repros
from femx_torch.mesh import relabel_nodes, write_msh
from femx_torch.solve import multigrid
from femx_torch.solve.multigrid import StructuredMultigrid

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _op(n, dtype, device):
    return StructuredSolidOperator.from_lattice(n, (0.05, 0.07, 0.06), 2e11, 0.3,
                                                dtype=dtype, device=device)


LATTICES = [(4, 4, 8), (5, 3, 7), (1, 1, 1), (24, 24, 96), (12, 12, 48), (6, 6, 24),
            (3, 3, 12), (7, 5, 33)]


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("n", LATTICES)
def test_kernel_matches_plain(cuda, dtype, rtol, n):
    """Compiled-path check (the counterpart of tests/test_pallas.py's TPU
    test). The kernel sums in another order than the plain matmul, hence a
    bound on max|kernel - plain| relative to max|plain|."""
    op = _op(n, dtype, cuda)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(op.ndof).astype(dtype),
                        device=cuda)
    name = np.dtype(dtype).name
    before = cm.LAUNCHES[name]
    got = cm.structured_cell_matmul(u, op.Kcell, n)
    torch.cuda.synchronize()
    assert cm.LAUNCHES[name] == before + 1
    want = cm.structured_cell_matmul_plain(u, op.Kcell, n)
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), err


def _built_variants():
    return [(dt, v) for dt, vs in cm.BUILT.items() for v in vs]


@pytest.mark.parametrize("dtype,variant", _built_variants(),
                         ids=[f"{str(d)[6:]}-{v.code}" for d, v in _built_variants()])
@pytest.mark.parametrize("n", [(7, 5, 33), (6, 6, 24), (1, 1, 1)])
def test_every_variant_matches_plain_with_a_non_symmetric_matrix(cuda, dtype, variant, n):
    """Each built kernel variant (both float64 families, every tile) with a
    random cell matrix that is not symmetric: a transposed fragment or a
    misplaced pad shows here and not with the operator's own matrix."""
    rng = np.random.default_rng(1)
    ndt = np.float32 if dtype == torch.float32 else np.float64
    kcell = torch.as_tensor(rng.standard_normal((81, 81)).astype(ndt), device=cuda)
    u = torch.as_tensor(rng.standard_normal(cm.phase_offsets(n)[-1]).astype(ndt), device=cuda)
    want = cm.structured_cell_matmul_plain(u, kcell, n)
    fe = torch.full_like(want, float("nan"))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = cm.plan_launch(n[0] * n[1] * n[2], dtype, sms, variant=variant)
    assert cm._launcher(u, kcell, fe, n, plan)() == 0
    torch.cuda.synchronize()
    err = (fe - want).abs().max().item()
    assert err <= (1e-5 if dtype == torch.float32 else 1e-12) * want.abs().max().item(), err


def test_f32_operator_stays_symmetric(cuda):
    """|v.Ku - u.Kv| small: true FP32 products (TF32 would break this)."""
    n = (12, 12, 48)
    op = _op(n, np.float32, cuda)
    rng = np.random.default_rng(3)
    u, v = (torch.as_tensor(rng.standard_normal(op.ndof).astype(np.float32), device=cuda)
            for _ in range(2))
    Ku, Kv = op.apply(u).double(), op.apply(v).double()
    asym = abs((v.double() @ Ku - u.double() @ Kv).item())
    assert asym <= 1e-5 * (u.double().norm() * Kv.norm()).item()


def test_kernel_rejects_non_contiguous(cuda):
    op = _op((2, 2, 2), np.float64, cuda)
    u = torch.zeros(2 * op.ndof, dtype=torch.float64, device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        cm.structured_cell_matmul(u, op.Kcell, (2, 2, 2))


@pytest.mark.parametrize("weighted", [False, True])
def test_apply_matches_cpu(cuda, weighted):
    n = (6, 4, 10)
    cpu = _op(n, np.float64, "cpu")
    mask = np.ones(cpu.ndof)
    mask[np.random.default_rng(1).choice(cpu.ndof, cpu.ndof // 10, replace=False)] = 0
    w = dict(x_weight=np.linspace(1.0, 0.2, 6), z_weight=np.r_[np.ones(8), 0.5, 0.0]) \
        if weighted else {}
    ops = [StructuredSolidOperator.from_host(cpu.Kcell_host, n, cpu.weight, free_mask=mask,
                                             device=d, **w) for d in ("cpu", cuda)]
    u = np.random.default_rng(2).standard_normal(cpu.ndof)
    want = ops[0].apply_constrained(torch.from_numpy(u)).numpy()
    got = ops[1].apply_constrained(torch.as_tensor(u, device=cuda)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=np.abs(want).max() * 1e-13)


@pytest.mark.parametrize("dtype,solver", [(np.float64, "cg"), (np.float32, "mg")])
def test_solve_matches_cpu(cuda, dtype, solver):
    corners = [(x, y, 0.0) for x in (0, 0.4) for y in (0, 0.4)]
    mesh = femx_torch.box_tet10(0.4, 0.4, 0.8, 0.1, force_points=[(0.2, 0.4, 0.8)],
                                fix_points=corners)
    force = [{"force_x": 0, "force_y": -500.0, "force_z": 100.0,
              "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 0.8}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    runs = [femx_torch.SolidReactionAnalysis(mesh, force, fix, E=2e11, v=0.3, dtype=dtype,
                                             solver=solver, cg_tol=1e-10, verbose=False,
                                             device=d).run_simulation()
            for d in ("cpu", "cuda")]
    assert all(r.solve_info["converged"] for r in runs)
    R = [r.reaction_forces for r in runs]
    np.testing.assert_allclose(R[1], R[0], rtol=1e-7, atol=np.abs(R[0]).max() * 1e-8)
    np.testing.assert_allclose(runs[1].equilibrium_residual(), 0.0, atol=1e-6)


# -- the data-movement kernels (csrc/take_rows.cu, take_along_axis.cu,
# row_copy.cu): pure copies, so the kernel must equal its plain version
# exactly ------------------------------------------------------------------

def _counted(key):
    before = gather.LAUNCHES[key]
    return lambda: gather.LAUNCHES[key] - before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,width", [((10, 4000), 3), ((8, 128), 128), ((8, 128), 0),
                                         ((5,), 3), ((1, 0), 3), ((1023,), 3), ((1025,), 3),
                                         ((341,), 3), ((3, 43), 3), ((129,), 128), ((7,), 2)])
def test_take_rows_matches_plain(cuda, dtype, shape, width):
    rng = np.random.default_rng(0)
    tab_np = rng.standard_normal((1000, width) if width else (1000,)).astype(dtype)
    idx_np = rng.integers(0, 1000, size=shape)
    tab = torch.as_tensor(tab_np, device=cuda)
    idx = gather.index_tensor(idx_np, 1000, cuda)
    assert idx.dtype == torch.int32
    n = _counted(f"take_rows/{np.dtype(dtype).name}")
    got = gather.take_rows(tab, idx)
    torch.cuda.synchronize()
    assert n() == (1 if got.numel() else 0)
    assert got.shape == (*shape, *tab_np.shape[1:])
    np.testing.assert_array_equal(got.cpu().numpy(), tab_np[idx_np])
    torch.testing.assert_close(got, gather.take_rows_plain(tab, idx), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis,tab_shape,idx_shape", [(0, (512, 128), (8, 128)),
                                                      (0, (8, 128), (4096, 128)),
                                                      (1, (8, 128), (8, 128)),
                                                      (1, (6, 50), (6, 7))])
def test_take_along_axis_matches_plain(cuda, dtype, axis, tab_shape, idx_shape):
    rng = np.random.default_rng(1)
    tab_np = rng.standard_normal(tab_shape).astype(dtype)
    idx_np = rng.integers(0, tab_shape[axis], size=idx_shape)
    tab = torch.as_tensor(tab_np, device=cuda)
    idx = gather.index_tensor(idx_np, tab_shape[axis], cuda)
    n = _counted(f"take_along_axis/{np.dtype(dtype).name}")
    got = gather.take_along_axis(tab, idx, axis)
    torch.cuda.synchronize()
    assert n() == 1
    np.testing.assert_array_equal(got.cpu().numpy(), np.take_along_axis(tab_np, idx_np, axis))
    torch.testing.assert_close(got, gather.take_along_axis_plain(tab, idx, axis),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows,row0,n_rows,scale", [(16, 4, 8, 1.0), (8, 0, 8, 2.0),
                                                    (1000, 17, 900, -0.5)])
def test_row_copy_matches_plain(cuda, dtype, rows, row0, n_rows, scale):
    x_np = np.random.default_rng(2).standard_normal((rows, 130)).astype(dtype)
    x = torch.as_tensor(x_np, device=cuda)
    r0 = torch.tensor([row0], dtype=torch.int32, device=cuda)
    n = _counted(f"row_copy/{np.dtype(dtype).name}")
    got = gather.row_copy(x, r0, n_rows, scale)
    torch.cuda.synchronize()
    assert n() == 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  (scale * x_np[row0:row0 + n_rows]).astype(dtype))
    torch.testing.assert_close(got, gather.row_copy_plain(x, r0, n_rows, scale), rtol=0, atol=0)


LIMIT_H = gather.MAX_DYNAMIC_SMEM // gather.SLAB_BYTES  # the tallest slab table


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("h", [8, 512, LIMIT_H, LIMIT_H + 1])
@pytest.mark.parametrize("w", [7, 50, 128, 130])
def test_take_along_axis_every_variant_is_exact(cuda, dtype, axis, h, w):
    """axis 0: tab (h, w), idx (300, w), both sides of the slab limit, every
    width class (16-byte words, ragged slab, scalar); axis 1: tab (300, h)."""
    rng = np.random.default_rng(7)
    tab_shape = (h, w) if axis == 0 else (300, h)
    tab_np = rng.standard_normal(tab_shape).astype(dtype)
    idx_np = rng.integers(0, tab_shape[axis], size=(300, w))
    tab = torch.as_tensor(tab_np, device=cuda)
    idx = gather.index_tensor(idx_np, tab_shape[axis], cuda)
    plan = gather.plan_take_along(300, w, *tab_shape, axis, tab.element_size(),
                                  torch.cuda.get_device_properties(cuda).multi_processor_count)
    want_variant = ("axis1" if axis else "l2" if h > LIMIT_H
                    else "slab" if w % gather.word_columns(tab.element_size()) == 0
                    else "slab_scalar")
    assert plan.variant == want_variant
    n = _counted(f"take_along_axis/{np.dtype(dtype).name}")
    got = gather.take_along_axis(tab, idx, axis)
    torch.cuda.synchronize()
    assert n() == 1
    np.testing.assert_array_equal(got.cpu().numpy(), np.take_along_axis(tab_np, idx_np, axis))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_take_along_axis_misaligned_index_takes_the_scalar_slab(cuda, dtype):
    rng = np.random.default_rng(8)
    tab_np = rng.standard_normal((64, 128)).astype(dtype)
    idx_np = rng.integers(0, 64, size=(500, 128))
    flat = gather.index_tensor(np.r_[0, idx_np.ravel()], 64, cuda)
    idx = flat[1:].view(500, 128)  # contiguous, 4 bytes past a 16-byte boundary
    assert idx.is_contiguous() and idx.data_ptr() % 16 == 4
    got = gather.take_along_axis(torch.as_tensor(tab_np, device=cuda), idx, 0)
    np.testing.assert_array_equal(got.cpu().numpy(), np.take_along_axis(tab_np, idx_np, 0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cols", [128, 130])
@pytest.mark.parametrize("row0", [0, 1, 17])
@pytest.mark.parametrize("n_rows", [1, 100_000])
@pytest.mark.parametrize("offset", [0, 1])
def test_row_copy_words_and_elements_are_exact(cuda, dtype, cols, row0, n_rows, offset):
    """16-byte words (128 columns, aligned x) and single elements (130
    columns, or x one element past an aligned address), at one row and at
    100,000; scale -0.5 and 1."""
    rng = np.random.default_rng(9)
    x_np = rng.standard_normal((n_rows + 20, cols)).astype(dtype)
    buf = torch.as_tensor(np.r_[np.zeros(offset, dtype), x_np.ravel()], device=cuda)
    x = buf[offset:].view(n_rows + 20, cols)
    assert x.data_ptr() % 16 == (0 if offset == 0 else x.element_size())
    r0 = torch.tensor([row0], dtype=torch.int32, device=cuda)
    for scale in (-0.5, 1.0):
        got = gather.row_copy(x, r0, n_rows, scale)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      (scale * x_np[row0:row0 + n_rows]).astype(dtype))


def _graph_matches_eager(fn):
    """fn's result from a replay of a CUDA graph that captured it (after a
    warm-up on a side stream) against an eager call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(captured, fn(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_kernels_replay_in_a_cuda_graph(cuda, dtype):
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.standard_normal((64, 128)).astype(dtype), device=cuda)
    r0 = torch.tensor([5], dtype=torch.int32, device=cuda)
    idx = gather.index_tensor(rng.integers(0, 64, size=(300, 128)), 64, cuda)
    rows = gather.index_tensor(rng.integers(0, 64, size=(40, 7)), 64, cuda)
    tab3 = x[:, :3].contiguous()
    name = np.dtype(dtype).name
    before = {k: gather.LAUNCHES[f"{k}/{name}"] for k in ("row_copy", "take_along_axis",
                                                           "take_rows")}
    _graph_matches_eager(lambda: gather.row_copy(x, r0, 32, 2.0))
    _graph_matches_eager(lambda: gather.take_along_axis(x, idx, 0))
    _graph_matches_eager(lambda: gather.take_rows(tab3, rows))
    # warm-up, capture and eager call each launched once
    assert all(gather.LAUNCHES[f"{k}/{name}"] == v + 3 for k, v in before.items())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cell_kernel_replays_in_a_cuda_graph(cuda, dtype):
    """The flagship's plan (24 x 24 x 96 cells), whose launch sets the
    kernel's shared-memory attribute every time, captured and replayed."""
    op = _op((24, 24, 96), dtype, cuda)
    u = torch.as_tensor(np.random.default_rng(11).standard_normal(op.ndof).astype(dtype),
                        device=cuda)
    name = np.dtype(dtype).name
    before = cm.LAUNCHES[name]
    _graph_matches_eager(lambda: cm.structured_cell_matmul(u, op.Kcell, (24, 24, 96)))
    assert cm.LAUNCHES[name] == before + 3  # warm-up, capture and eager call


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 7, 4096, 100_003])
def test_slot_copies_read_their_addresses_on_the_card(cuda, dtype, offset, n):
    """slot_copy_in and slot_copy_out under a graph: each replay copies from
    and to the addresses slot_set wrote before it, aligned or not (offset
    1 element), exactly."""
    rng = np.random.default_rng(13)
    slots = torch.zeros(2, dtype=torch.int64, device=cuda)
    buf = torch.empty(n, dtype=torch.float32 if dtype == np.float32 else torch.float64,
                      device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        gather.slot_copy_in(slots, buf)
        buf.mul_(3.0)
        gather.slot_copy_out(slots, buf)
    outs = []
    for _ in range(3):  # queued back to back: each replay reads its own pair
        src = torch.as_tensor(rng.standard_normal(n + offset).astype(dtype), device=cuda)
        dst = torch.full((n + offset,), float("nan"), dtype=buf.dtype, device=cuda)
        gather.slot_set(slots, src[offset:].data_ptr(), dst[offset:].data_ptr())
        graph.replay()
        outs.append((src, dst))
    torch.cuda.synchronize()
    for src, dst in outs:
        assert torch.equal(dst[offset:], 3.0 * src[offset:])
        assert dst[:offset].isnan().all()


def _small_mg(cuda, smoother="jacobi", n=(8, 8, 16)):
    """A hierarchy of a box clamped at x = 0, on the card: three levels at
    the default lattice, four at (16, 16, 32)."""
    nd = 3 * int(np.prod([2 * c + 1 for c in n]))
    mask = np.ones(nd)
    mask[:3 * (2 * n[1] + 1) * (2 * n[2] + 1)] = 0
    mg = StructuredMultigrid((0.4, 0.4, 0.8), n, 2e11, 0.3, mask, device=cuda,
                             smoother=smoother)
    assert len(mg.levels) == {(8, 8, 16): 3, (16, 16, 32): 4}[tuple(n)]
    return mg


def _residuals(mg, k, seed=12):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(mg.fine_op.ndof).astype(np.float32),
                            device=mg.fine_op.device) for _ in range(k)]


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_replay_is_the_eager_vcycle_bitwise(cuda, smoother, monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    mg = _small_mg(cuda, smoother)
    rs = _residuals(mg, 5)
    got = [mg(r) for r in rs]  # eager; capture and replay; three replays
    want = [mg._vcycle(0, r) for r in rs]
    torch.cuda.synchronize()
    assert mg._graph.captured
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_vcycle_replay_with_the_conv_apply(cuda, monkeypatch):
    """cuDNN's convolutions (every level in conv form) under capture: the
    replay against the eager V-cycle."""
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    monkeypatch.setenv("FEMX_CONV_MIN_CELLS", "0")
    n, sp = (8, 8, 16), (0.05, 0.05, 0.05)
    fine = StructuredSolidOperator.from_lattice(n, sp, 2e11, 0.3, dtype=np.float32,
                                                device=cuda, apply_form="conv")
    mask = np.ones(fine.ndof)
    mask[:3 * (2 * n[1] + 1) * (2 * n[2] + 1)] = 0
    mg = StructuredMultigrid(None, n, 2e11, 0.3, mask, spacing=sp, fine_op=fine, device=cuda)
    before = dict(cm.LAUNCHES)
    rs = _residuals(mg, 3)
    got = [mg(r) for r in rs]
    want = [mg._vcycle(0, r) for r in rs]
    torch.cuda.synchronize()
    assert mg._graph.captured and dict(cm.LAUNCHES) == before  # no cell kernel
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-6 * w.abs().max().item()


def test_vcycle_replay_inside_the_lattice_preconditioner(cuda, monkeypatch):
    """The mesh-file route's lattice preconditioner (two V-cycles a call,
    both replayed) against the same preconditioner on the eager V-cycle."""
    import copy

    from femx_torch.solve.lattice_precond import LatticePreconditioner

    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    monkeypatch.setattr(femx_torch.SolidReactionAnalysis, "MG_DOF_THRESHOLD", 1000)
    monkeypatch.setattr(femx_torch.SolidReactionAnalysis, "DENSE_DOF_LIMIT", 1000)
    mesh = femx_torch.box_tet10(0.4, 0.2, 0.4, 0.05, force_points=[(0.2, 0.2, 0.2)],
                                fix_points=[(0, 0, 0), (0.4, 0, 0), (0, 0, 0.4), (0.4, 0, 0.4)])
    mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
    force = [{"force_x": 0, "force_y": -500.0, "force_z": 0, "force_x_pstn": 0.2,
              "force_y_pstn": 0.2, "force_z_pstn": 0.2}]
    fix = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x in (0, 0.4) for z in (0, 0.4)]
    fa = femx_torch.SolidReactionAnalysis(mesh, force, fix, E=2e11, v=0.3, dtype=np.float32,
                                          verbose=False, device=cuda)
    fa.run_simulation()
    pre = fa._precond
    assert isinstance(pre, LatticePreconditioner) and pre.n_cycles == 2

    class Eager:
        def __init__(self, mg):
            self.mg = mg

        def __call__(self, r):
            return self.mg._vcycle(0, r)

        def __getattr__(self, name):
            return getattr(self.mg, name)

    eager = copy.copy(pre)
    eager.mg = Eager(pre.mg)
    rng = np.random.default_rng(14)
    n = fa._op64.ndof
    rs = [torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=cuda)
          for _ in range(3)]
    got = [pre(r) for r in rs]
    want = [eager(r) for r in rs]
    torch.cuda.synchronize()
    assert pre.mg._graph.captured
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_vcycle_graph_keeps_no_vector_between_calls(cuda, monkeypatch):
    """Once captured, a hierarchy holds its 16-byte address table and
    nothing else allocated: a replayed call adds its result alone. The
    capture leaves cuBLAS's workspaces cleared; the eager V-cycle's matvec
    makes the current stream's again. torch keeps its random generator's
    state (two int64 tensors) while it holds any graph: one held through the
    test makes them before the base is read."""
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    held = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(held, stream=side):
        torch.ones(8, device=cuda).mul_(2.0)
    mg = _small_mg(cuda)
    r, = _residuals(mg, 1)
    mg._vcycle(0, r)  # the cell matrices packed, the stream's cuBLAS workspace made
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    mg(r)
    mg(r)  # eager; capture and first replay; both results dropped
    mg._vcycle(0, r)
    torch.cuda.synchronize()
    assert mg._graph.captured and mg._graph.slots.numel() * 8 == 16
    assert torch.cuda.memory_allocated() - base == 512  # the address table's block
    before = torch.cuda.memory_allocated()
    out = mg(r)
    torch.cuda.synchronize()
    block = -(-out.numel() * out.element_size() // 512) * 512
    assert torch.cuda.memory_allocated() - before == block
    del held


def _pool_bytes(pool) -> int:
    """What the allocator reserves for the memory pool of id `pool`."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def _eager_need(mg, r) -> int:
    """The bytes an eager V-cycle on a copy of r makes the allocator
    reserve on a new stream (whose requests no cached block serves, and
    which makes its own cuBLAS workspace, as the capture stream does): the
    capture's work, eagerly."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    with torch.cuda.stream(side):
        x = torch.empty_like(r)
        x.copy_(r)
        y = mg._vcycle(0, x).contiguous()
        del x, y
    torch.cuda.synchronize()
    need = torch.cuda.memory_reserved() - before
    multigrid._clear_cublas_workspaces()  # the side stream's
    torch.cuda.empty_cache()
    return need


@pytest.mark.parametrize("n", [(8, 8, 16), (16, 16, 32)])
def test_vcycle_graph_pool_reserves_what_an_eager_vcycle_needs(cuda, monkeypatch, n):
    """What the graphs' shared pool reserves once a hierarchy's V-cycle is
    captured into it is no more than an eager V-cycle of the same work
    reserves on a stream of its own: the transients, the input's copy and
    the second stream's cuBLAS workspace, and nothing kept beside them."""
    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    monkeypatch.setattr(multigrid, "_CAPTURE", {})  # a pool of this test's own
    mg = _small_mg(cuda, n=n)
    r, = _residuals(mg, 1)
    mg(r)  # eager: the caches filled
    need = _eager_need(mg, r)
    mg(r)  # captured and replayed
    torch.cuda.synchronize()
    got = _pool_bytes(multigrid._capture_place(cuda)[1])
    assert 0 < got <= need, (got, need)


def test_vcycle_graphs_go_with_their_hierarchies(cuda, monkeypatch):
    """Five rounds of build, solve, drop: the memory the card reserves
    stays flat (each capture takes the memory the dropped graphs used from
    the shared pool) with the allocator's cache never emptied."""
    import gc

    from femx_torch.solve.cg import pcg

    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    monkeypatch.setattr(multigrid, "_CAPTURE", {})
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: pytest.fail("cache emptied"))
    reserved = []
    for _ in range(5):
        mg = _small_mg(cuda)
        b, = _residuals(mg, 1)
        res = pcg(mg.fine_op.apply_constrained, b * mg.fine_op.free_mask, M_inv_diag=mg,
                  tol=1e-5, maxiter=50)
        assert res.converged and mg._graph.captured
        del mg, b, res
        gc.collect()
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[1:] == [reserved[1]] * 4, reserved


def test_vcycle_graph_counters(cuda, monkeypatch):
    from femx_torch import profiling

    monkeypatch.setenv("FEMX_MG_CACHE", "0")
    mg = _small_mg(cuda)
    r, = _residuals(mg, 1)
    profiling.enable(cuda)
    try:
        for _ in range(6):
            mg(r)
        rec = profiling.collect()
    finally:
        profiling.disable()
        profiling.collect()
    assert rec["counters"] == {"mg.vcycle_calls": 6, "mg.graph_captures": 1,
                               "mg.graph_replays": 5}
    names = [s["name"] for s in rec["spans"]]
    assert names.count("mg.replay") == 5 and names.count("mg.level") == len(mg.levels)
    assert all(s["device_ns"] is not None for s in rec["spans"] if s["name"] == "mg.replay")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_rows", [1, 127, 128, 129, 515, 4097])
def test_take_rows_by_rows_kernel_is_exact(cuda, dtype, n_rows):
    """The row-per-thread width-3 kernel (built for timing) at row counts
    around its chunk of 128 rows per warp and 512 per block."""
    rng = np.random.default_rng(4)
    tab = torch.as_tensor(rng.standard_normal((1000, 3)).astype(dtype), device=cuda)
    idx = gather.index_tensor(rng.integers(0, 1000, size=n_rows), 1000, cuda)
    out = torch.full((n_rows, 3), float("nan"), dtype=tab.dtype, device=cuda)
    fn = gather._kernel_fn("take_rows", tab.dtype)
    assert fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, 3, 1,
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, gather.take_rows_plain(tab, idx), rtol=0, atol=0)


def test_wrappers_refuse_int64_indices_on_the_card(cuda):
    tab = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        gather.take_rows(tab, torch.zeros(2, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("module", [mosaic_repros, gather_repros])
def test_repros_on_the_card(cuda, module):
    for name, fn in module.REPROS.items():
        np.testing.assert_array_equal(fn().cpu().numpy(), module.expected(name), err_msg=name)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_tg_apply_matches_cpu(cuda, dtype, rtol):
    """The transpose-gather apply on the card (take_rows kernel) against
    the same operator on the CPU (plain gathers)."""
    mesh = femx_torch.box_tet10(0.3, 0.2, 0.4, 0.05)
    mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
    ops = [SolidOperatorTG.from_mesh(mesh.points, mesh.cells["tetra10"], 2e11, 0.3,
                                     dtype=dtype, device=d)[0] for d in ("cpu", cuda)]
    mask = (np.random.default_rng(1).random(ops[0].ndof) > 0.1).astype(np.float64)
    ops = [op.with_free_mask(op.to_internal(mask)) for op in ops]
    u = np.random.default_rng(2).standard_normal(ops[0].ndof).astype(dtype)
    n = _counted(f"take_rows/{np.dtype(dtype).name}")
    got = ops[1].apply_constrained(torch.as_tensor(u, device=cuda)).cpu().numpy()
    assert n() == ops[1].gathers_per_apply
    want = ops[0].apply_constrained(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=np.abs(want).max() * rtol)


@pytest.mark.parametrize("kind,symmetric", [("groupell", False), ("groupell", True),
                                            ("cluster", False)])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_block_operator_apply_matches_cpu(cuda, kind, dtype, rtol, symmetric):
    """The group-ELL (full and symmetric storage) and cluster applies on the
    card (take_rows kernel at widths 48, 6 and 3) against the same operators
    built on the CPU; one take_rows launch per gather of the apply."""
    from femx_torch.assembly_cluster import SolidOperatorCluster
    from femx_torch.assembly_groupell import SolidOperatorGroupELL

    mesh = femx_torch.box_tet10(0.3, 0.2, 0.4, 0.05)
    mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
    kw = {"symmetric": symmetric} if kind == "groupell" else {}
    Op = SolidOperatorGroupELL if kind == "groupell" else SolidOperatorCluster
    ops = [Op.from_mesh(mesh.points, mesh.cells["tetra10"], 2e11, 0.3, dtype=dtype, device=d,
                        **kw)[0] for d in ("cpu", cuda)]
    mask = (np.random.default_rng(1).random(3 * mesh.num_nodes) > 0.1).astype(dtype)
    ops = [op.with_free_mask(op.to_internal(mask)) for op in ops]
    u = ops[0].to_internal(np.random.default_rng(2).standard_normal(3 * mesh.num_nodes)
                           .astype(dtype))
    n = _counted(f"take_rows/{np.dtype(dtype).name}")
    got = ops[1].apply_constrained(torch.as_tensor(u, device=cuda)).cpu().numpy()
    assert n() == ops[1].gathers_per_apply
    want = ops[0].apply_constrained(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=np.abs(want).max() * rtol)
    bj = [op.block_jacobi_tensors().cpu().numpy() for op in ops]
    np.testing.assert_allclose(bj[1], bj[0], rtol=rtol, atol=np.abs(bj[0]).max() * rtol)


@pytest.mark.parametrize("kind", ["groupell", "cluster"])
def test_block_operator_analysis_matches_cpu(cuda, kind, tmp_path):
    """The relabelled box of test_unstructured_solve_matches_cpu through
    unstructured_operator=kind with the lattice MG, float64 and float32, on
    the card and on the CPU."""
    corners = [(x, 0.0, z) for x in (0, 0.2) for z in (0, 0.6)]
    mesh = femx_torch.box_tet10(0.2, 0.2, 0.6, 0.05, force_points=[(0.1, 0.2, 0.3)],
                                fix_points=corners)
    mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
    path = tmp_path / "box.msh"
    write_msh(path, mesh)
    force = [{"force_x": 0, "force_y": 3000.0, "force_z": 0, "force_x_pstn": 0.1,
              "force_y_pstn": 0.2, "force_z_pstn": 0.3}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    for dtype, method in ((np.float64, "lattice_mg_pcg"), (np.float32, "lattice_mg_pcg_mixed")):
        runs = []
        for d in ("cpu", "cuda"):
            fa = femx_torch.SolidReactionAnalysis(str(path), force, fix, E=2e11, v=0.3,
                                                  cg_tol=1e-10, verbose=False, device=d,
                                                  dtype=dtype, unstructured_operator=kind)
            fa.MG_DOF_THRESHOLD = 6000
            runs.append(fa.run_simulation())
        assert [r.solve_info["method"] for r in runs] == [f"{kind}_{method}"] * 2
        R = [r.reaction_forces for r in runs]
        np.testing.assert_allclose(R[1], R[0], rtol=1e-7, atol=np.abs(R[0]).max() * 1e-8)
        np.testing.assert_allclose(runs[1].equilibrium_residual(), 0.0, atol=1e-6 * 3000.0)


def test_unstructured_solve_matches_cpu(cuda, tmp_path):
    """A relabelled box read from a .msh file through the TG + lattice-MG
    route (threshold lowered) on the card and on the CPU."""
    corners = [(x, 0.0, z) for x in (0, 0.2) for z in (0, 0.6)]
    mesh = femx_torch.box_tet10(0.2, 0.2, 0.6, 0.05, force_points=[(0.1, 0.2, 0.3)],
                                fix_points=corners)
    mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
    path = tmp_path / "box.msh"
    write_msh(path, mesh)
    force = [{"force_x": 0, "force_y": 3000.0, "force_z": 0, "force_x_pstn": 0.1,
              "force_y_pstn": 0.2, "force_z_pstn": 0.3}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    runs = []
    for d in ("cpu", "cuda"):
        fa = femx_torch.SolidReactionAnalysis(str(path), force, fix, E=2e11, v=0.3,
                                              cg_tol=1e-10, verbose=False, device=d)
        fa.MG_DOF_THRESHOLD = 6000
        runs.append(fa.run_simulation())
    assert [r.solve_info["method"] for r in runs] == ["tg_lattice_mg_pcg"] * 2
    R = [r.reaction_forces for r in runs]
    np.testing.assert_allclose(R[1], R[0], rtol=1e-7, atol=np.abs(R[0]).max() * 1e-8)
    np.testing.assert_allclose(runs[1].equilibrium_residual(), 0.0, atol=1e-6)


def _cantilever_mg(device, dtype):
    """A (4, 4, 8)-cell cantilever, its z=0 face clamped, with its V-cycle."""
    from femx_torch.solve.multigrid import StructuredMultigrid

    mesh = femx_torch.box_tet10(0.2, 0.2, 0.4, mesh_size=0.05)
    mask = np.ones(3 * mesh.num_nodes)
    mask[(3 * np.where(mesh.points[:, 2] < 1e-9)[0][:, None] + np.arange(3)).ravel()] = 0.0
    op = StructuredSolidOperator.from_mesh(mesh, 2e11, 0.3, dtype=dtype, device=device)
    op = op.with_free_mask(op.to_internal(mask))
    mg = StructuredMultigrid(None, (4, 4, 8), 2e11, 0.3, mask, dtype=dtype, fine_op=op,
                             spacing=mesh.structured.spacing, device=device)
    return op, mg


@pytest.mark.parametrize("dtype,inner_tol,rtol", [(np.float64, 1e-10, 1e-8),
                                                  (np.float32, 1e-6, 1e-4)])
def test_modal_shift_invert_matches_cpu(cuda, dtype, inner_tol, rtol):
    """Shift-invert Lanczos with MG-PCG inner solves (the cell kernel on
    every level) on the card against the same call on the CPU, from the
    same start vector."""
    from femx_torch.modal import solid_modal_structured

    v0 = np.random.default_rng(3).standard_normal(3 * 9 * 9 * 17)
    runs = []
    for d in ("cpu", cuda):
        op, mg = _cantilever_mg(d, dtype)
        before = cm.LAUNCHES[np.dtype(dtype).name]
        runs.append(solid_modal_structured(op, mg, 7850.0, n_modes=6, inner_tol=inner_tol,
                                           inner_maxiter=400, tol=1e-8, maxiter=60, v0=v0))
        assert (cm.LAUNCHES[np.dtype(dtype).name] > before) == (d != "cpu")
    assert runs[1].omega.device.type == "cuda"
    np.testing.assert_allclose(runs[1].omega.cpu().numpy(), runs[0].omega.numpy(), rtol=rtol)


def test_compute_stresses_matches_cpu(cuda):
    from femx_torch.analysis.solid import nodal_stresses
    from femx_torch.elements.tet10 import material_matrix

    mesh = femx_torch.box_tet10(0.3, 0.2, 0.4, 0.05)
    u = np.random.default_rng(4).standard_normal(3 * mesh.num_nodes) * 1e-4
    args = (mesh.points, mesh.cells["tetra10"], u, material_matrix(2e11, 0.3))
    for got, want in zip(nodal_stresses(*args, device=cuda, chunk=1000),
                         nodal_stresses(*args, device="cpu")):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=np.abs(want).max() * 1e-12)


def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    """checkpoint= on the card: a run cut at 200 iterations, then a second
    analysis that resumes from the file, to the CPU's uncheckpointed u."""
    corners = [(0, 0, 0), (0.15, 0, 0), (0, 0, 0.3), (0.15, 0, 0.3)]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    force = [{"force_x": 0, "force_y": -500.0, "force_z": 0, "force_x_pstn": 0.075,
              "force_y_pstn": 0.15, "force_z_pstn": 0.15}]
    path = str(tmp_path / "state")

    def run(device, maxiter=None, **kw):
        mesh = femx_torch.box_tet10(0.15, 0.15, 0.3, 0.05, fix_points=corners)
        fa = femx_torch.SolidReactionAnalysis(mesh, force, fix, E=2e11, v=0.3, cg_tol=1e-10,
                                              verbose=False, device=device, **kw)
        if maxiter is not None:
            fa.CHECKPOINT_MAXITER = maxiter
        return fa.run_simulation()

    want = run("cpu").u
    first = run(cuda, 200, checkpoint=path, checkpoint_chunk=100)
    assert not first.solve_info["converged"]
    fa = run(cuda, checkpoint=path, checkpoint_chunk=100)
    assert fa.solve_info["resumed_iterations"] == 200 and fa.solve_info["converged"]
    np.testing.assert_allclose(fa.u, want, atol=np.abs(want).max() * 1e-7)


# -- the beam, shaft, plane and pipe products ---------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_take_rows_tri6_gather_is_exact(cuda, dtype):
    """Rows of 2 by an (E, 6) connectivity: the 2D operators' gather."""
    from femx_torch.mesh.generators2d import rect_tri6_from_cells

    mesh = rect_tri6_from_cells((33, 7), (0.1, 0.1))
    tab = torch.as_tensor(np.random.default_rng(3).standard_normal((mesh.num_nodes, 2))
                          .astype(dtype), device=cuda)
    idx = gather.index_tensor(mesh.cells["triangle6"], mesh.num_nodes, cuda)
    n = _counted(f"take_rows/{np.dtype(dtype).name}")
    got = gather.take_rows(tab, idx)
    assert n() == 1 and got.shape == (len(idx), 6, 2)
    torch.testing.assert_close(got, gather.take_rows_plain(tab, idx), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["plane", "axisym"])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_2d_operator_apply_matches_cpu(cuda, kind, dtype, rtol):
    from femx_torch.assembly_plane import AxisymOperator, PlaneOperator
    from femx_torch.elements import tri6
    from femx_torch.mesh.generators2d import rect_tri6_from_cells

    mesh = rect_tri6_from_cells((20, 12), (0.01, 0.02), origin=(0.05, 0.0))
    args = (mesh.points, mesh.cells["triangle6"])
    if kind == "plane":
        ops = [PlaneOperator.from_mesh(*args, tri6.material_matrix_plane(2e11, 0.3),
                                       thickness=0.01, dtype=dtype, device=d)[0]
               for d in ("cpu", cuda)]
    else:
        ops = [AxisymOperator.from_mesh(*args, tri6.material_matrix_axisym(2e11, 0.3),
                                        dtype=dtype, device=d)[0] for d in ("cpu", cuda)]
    mask = (np.random.default_rng(1).random(ops[0].ndof) > 0.1).astype(np.float64)
    ops = [op.with_free_mask(mask) for op in ops]
    u = np.random.default_rng(2).standard_normal(ops[0].ndof).astype(dtype)
    n = _counted(f"take_rows/{np.dtype(dtype).name}")
    got = ops[1].apply_constrained(torch.as_tensor(u, device=cuda)).cpu().numpy()
    assert n() == 1
    want = ops[0].apply_constrained(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=np.abs(want).max() * rtol)
    want = ops[0].block_jacobi_inverse_blocks().numpy()
    np.testing.assert_allclose(ops[1].block_jacobi_inverse_blocks().cpu().numpy(), want,
                               rtol=rtol, atol=np.abs(want).max() * rtol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plane_analysis_matches_cpu(cuda, dtype):
    """PlaneAnalysis' MG route (f64 CG; with float32 the float32 V-cycle)
    on the card against the CPU: u to 1e-10, the same iterations, and
    take_rows launches as the solve implies."""
    from femx_torch.mesh.generators2d import rect_tri6_from_cells

    def run(device):
        mesh = rect_tri6_from_cells((64, 16), (1.0 / 64, 0.2 / 16))
        pa = femx_torch.PlaneAnalysis(mesh, [{"group": "right", "force_x": 0.0,
                                              "force_y": -1000.0}],
                                      [{"group": "left", "fix_x": 0, "fix_y": 0}], E=2e11,
                                      v=0.3, thickness=0.01, dtype=dtype, verbose=False,
                                      device=device)
        return pa.run_simulation()

    want = run("cpu")
    key = f"take_rows/{np.dtype(dtype).name}"
    n = _counted(key)
    got = run(cuda)
    info = got.solve_info
    assert info["method"].startswith("mg_pcg_2d") and info["converged"]
    assert abs(info["iterations"] - want.solve_info["iterations"]) <= 1
    it, cycles = info["iterations"], info["applies_per_cycle"] * (info["iterations"] + 1)
    # float64: every operator apply and V-cycle apply; float32: the V-cycles
    # on the float32 operator, the CG applies on the float64 one
    assert n() == (it + 2 + cycles if dtype == np.float64 else cycles)
    assert np.abs(got.u - want.u).max() <= 1e-10 * np.abs(want.u).max()
    assert np.abs(got.equilibrium_residual()).max() <= 1e-8 * 1000.0


def test_beam_shaft_and_pipe_match_cpu(cuda):
    """BeamAnalysis (warping-FEM sections on the card), ShaftModalAnalysis
    and PipeThermalAnalysis' MG route on the card against the CPU."""
    def frame(device):
        fb = femx_torch.FrameBuilder()
        a, b = fb.add_node((0.0, 0.0, 0.0)), fb.add_node((0.0, 0.0, 2.0))
        c = fb.add_node((1.5, 0.5, 2.0))
        fb.add_vertex_group("base", [a])
        fb.add_vertex_group("tip", [c])
        fb.add_member(a, b, "col", n_elems=4)
        fb.add_member(b, c, "arm", n_elems=4)
        secs = [{"group": "col", "type": "I section",
                 "params": {"d": 0.05, "b": 0.025, "t_w": 0.005, "t_f": 0.005, "r": 0.001}},
                {"group": "arm", "type": "hollow box section",
                 "params": {"d": 0.04, "b": 0.03, "t": 0.004}}]
        bcs = [{"group": "base", "type": "Fix", "fix_x": True, "fix_y": True, "fix_z": True,
                "fix_rx": True, "fix_ry": True, "fix_rz": True},
               {"group": "tip", "type": "Force", "force_x": 100.0, "force_y": -300.0,
                "force_z": 50.0},
               {"group": "arm", "type": "DistributedForce", "wz": -200.0}]
        return femx_torch.BeamAnalysis(fb.build(), secs, bcs, E=2e11, nu=0.3, rho=7850.0,
                                       mass="consistent", device=device).run(n_modes=8)

    got, want = frame(cuda), frame("cpu")
    for a, b in ((got.u, want.u), (got.smoothed_stresses, want.smoothed_stresses)):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()
    np.testing.assert_allclose(got.natural_frequencies, want.natural_frequencies, rtol=1e-9)

    def shaft(device):
        sm = femx_torch.ShaftModalAnalysis([{"length": 1.0, "d": 0.03}], [0.0, 1.0], E=2e11,
                                           nu=0.3, rho=7850.0, n_elems=30, verbose=False,
                                           device=device)
        sm.run(n_modes=6)
        return np.array([m.frequency_hz for m in sm.modes])

    np.testing.assert_allclose(shaft(cuda), shaft("cpu"), rtol=1e-9)

    def pipe(device):
        pt = femx_torch.PipeThermalAnalysis(0.05, 0.08, 0.1, E=2e11, v=0.3, alpha=1.2e-5,
                                            T_inner=200.0, T_outer=50.0, pressure_inner=5e6,
                                            n_r=16, n_z=128, verbose=False, device=device)
        return pt.run_simulation()

    got, want = pipe(cuda), pipe("cpu")
    assert got.solve_info["method"] == "mg_pcg_2d"
    assert np.abs(got.stress_nodes - want.stress_nodes).max() <= 1e-9 * np.abs(
        want.stress_nodes).max()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("n", [(8, 8, 16), (5, 3, 7), (1, 1, 1)])
def test_conv_apply_matches_slot_on_the_card(cuda, monkeypatch, dtype, tol, n):
    """The conv-form apply (cuDNN, TF32 off) against the slot apply with the
    cell kernel, and against the conv apply on the CPU; the conv form
    launches no cell kernel."""
    monkeypatch.setenv("FEMX_CONV_MIN_CELLS", "0")
    ops = {form: StructuredSolidOperator.from_lattice(
        n, (0.05, 0.07, 0.06), 2e11, 0.3, dtype=dtype, device=cuda, apply_form=form)
        for form in ("slot", "conv")}
    cpu = StructuredSolidOperator.from_lattice(n, (0.05, 0.07, 0.06), 2e11, 0.3, dtype=dtype,
                                               device="cpu", apply_form="conv")
    u_np = np.random.default_rng(3).standard_normal(cpu.ndof).astype(dtype)
    u = torch.as_tensor(u_np, device=cuda)
    slot = ops["slot"].apply(u)
    before = dict(cm.LAUNCHES)
    conv = ops["conv"].apply(u)
    torch.cuda.synchronize()
    assert dict(cm.LAUNCHES) == before
    scale = slot.abs().max().item()
    assert (conv - slot).abs().max().item() <= tol * scale
    ref = cpu.apply(torch.as_tensor(u_np)).numpy()
    assert np.abs(conv.cpu().numpy() - ref).max() <= tol * scale


def test_cli_runs_on_the_card_by_default(cuda, tmp_path, capsys):
    """The CLI's default platform is the card: the solid box (cell kernel
    launched) and the shaft's --json agree with --platform cpu."""
    from femx_torch import cli

    args = ["solid", "--box", "0.4", "0.2", "0.4", "--mesh-size", "0.1", "--E", "2e11",
            "--nu", "0.3", "--force", "400,3000,-700@0.3,0.2,0.1", "--fix", "0,0,0:xyz",
            "--fix", "0,0,0.4:xyz", "--fix", "0.4,0,0:xyz", "--fix", "0.4,0,0.4:xyz",
            "--stress", "--report", str(tmp_path / "r.md")]
    n0 = cm.LAUNCHES["float64"]
    assert cli.main(args) == 0
    card = capsys.readouterr().out
    assert cm.LAUNCHES["float64"] > n0
    assert cli.main(["--platform", "cpu"] + args) == 0
    host = capsys.readouterr().out

    def reactions(out):
        return np.array(re.findall(r"Rx=(\S+), Ry=(\S+), Rz=(\S+) N", out), dtype=float)

    assert reactions(card).shape == (4, 3)
    assert np.abs(reactions(card) - reactions(host)).max() <= 1e-9 * 3000.0
    shaft = ["shaft", "--segment", "2.0,0.04", "--bearing", "0", "--bearing", "2",
             "--E", "2e11", "--nu", "0.3", "--json"]
    import json

    assert cli.main(shaft) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(["--platform", "cpu"] + shaft) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(got["critical_speeds_rpm"], want["critical_speeds_rpm"],
                               rtol=1e-9)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_two_rank_halo_apply_on_the_card_matches_the_single_device_apply(cuda, dtype, tol):
    """Two ranks on the card (gloo on CUDA tensors when they share one
    card): the constrained halo apply and the all_reduce sharded apply
    against the single-device apply, with the cell kernel launched on both
    ranks."""
    from femx_torch.parallel import launch, rank_checks

    n = (8, 8, 16)
    op = StructuredSolidOperator.from_lattice(n, (0.05, 0.05, 0.05), 2e11, 0.3,
                                              dtype=np.dtype(dtype), device=cuda)
    m3 = np.ones(op.grid_shape + (3,))
    m3[:, :, 0] = 0.0
    mask = m3.reshape(-1)
    op = op.with_free_mask(op.to_internal(mask))
    u = np.random.default_rng(0).standard_normal(op.ndof)
    want = op.apply_constrained(torch.as_tensor(u, dtype=op.Kcell.dtype, device=cuda)).cpu().numpy()
    ranks = launch(rank_checks.structured_apply, 2, n, (0.05, 0.05, 0.05), mask, u, dtype,
                   "cuda", timeout=300, all_ranks=True)
    got = ranks[0].result
    scale = np.abs(want).max()
    assert np.abs(got["halo"] - want).max() <= tol * scale
    assert np.abs(got["sharded"] - want).max() <= tol * scale
    assert all(r.launches.get(f"structured_cell_matmul/{dtype}", 0) > 0 for r in ranks)


def test_two_rank_analysis_on_the_card_matches_the_cpu_ranks(cuda):
    """SolidReactionAnalysis(devices=2) on two card ranks against the same
    run on two CPU ranks: u and reactions to 1e-9 of their largest entry."""
    from femx_torch.parallel import launch, rank_checks

    cells = (4, 4, 8)
    mesh = femx_torch.box_tet10_from_cells(cells, (0.05, 0.05, 0.05))
    fixes = [{"pos_x": x, "pos_y": y, "pos_z": 0.0, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x, y in [(0, 0), (0, 0.2), (0.2, 0), (0.2, 0.2)]]
    forces = [{"force_x": 0, "force_y": -500.0, "force_z": 0, "force_x_pstn": 0.1,
               "force_y_pstn": 0.1, "force_z_pstn": 0.4}]
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = launch(rank_checks.solid_analysis, 2, mesh, forces, fixes,
                          dict(E=2e11, v=0.3, cg_tol=1e-10, devices=2, device=dev),
                          device=dev, timeout=300)
    assert out["cuda"]["solve_info"]["devices"] == 2
    assert abs(out["cuda"]["solve_info"]["iterations"]
               - out["cpu"]["solve_info"]["iterations"]) <= 1
    for k in ("u", "reactions"):
        want = out["cpu"][k]
        assert np.abs(out["cuda"][k] - want).max() <= 1e-9 * np.abs(want).max()


def test_two_nccl_ranks_replay_the_distributed_vcycle_bitwise(cuda):
    """Two ranks on two cards (NCCL): each rank's DistributedMultigrid (one
    distributed level, the hand-off to a replicated level that smooths, the
    dense coarse solve) runs eagerly, captures its all_gathers and hand-off
    at the second call and replays after; every output is the eager
    V-cycle's to the bit, pcg_halo takes the same iterations to the same x
    with the replayed and the eager V-cycle, and the counters show one
    capture, replays after it, and each call's bytes in comm.bytes."""
    from femx_torch.parallel import launch, rank_checks

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one rank a card")
    n, calls = (8, 8, 12), 6
    m3 = np.ones((2 * n[0] + 1, 2 * n[1] + 1, 2 * n[2] + 1, 3))
    m3[:, :, 0] = 0.0
    ranks = launch(rank_checks.dist_vcycle_graph, 2, n, (0.05, 0.05, 0.05), m3.reshape(-1),
                   calls, 1e-8, "cuda", device="cuda", timeout=300, all_ranks=True)
    for rk in ranks:
        out = rk.result
        assert out["backend"] == "nccl" and out["captured"]
        assert out["distributed_levels"] == 1 and out["levels"] == 3
        assert out["bitwise"] == [True] * calls
        assert out["counters"] == {"dmg.vcycle_calls": calls, "dmg.graph_captures": 1,
                                   "dmg.graph_replays": calls - 1,
                                   "comm.bytes": calls * out["eager_bytes"]}
        assert out["spans"]["dmg.replay"] == calls - 1 and out["spans"]["dmg.level"] == 1
        rep, eag = out["solves"]["replayed"], out["solves"]["eager"]
        assert rep["converged"] and rep["iterations"] == eag["iterations"]
        assert np.array_equal(rep["x"], eag["x"])


@pytest.mark.parametrize("route", ["structured", "unstructured"])
def test_two_nccl_ranks_replay_every_route_of_the_distributed_vcycle_bitwise(cuda, tmp_path,
                                                                            route):
    """Every route that calls a DistributedMultigrid, on two cards (NCCL):
    the float32 structured devices=2 solve checkpointed, its load cases
    and modal with refine (built and run again eagerly), and the
    unstructured devices=2 solve with a load case (the lattice coarse
    correction, two calls a preconditioner call; the case run again
    eagerly on the same solver). Run as the program runs it, each
    hierarchy captures at its second call and replays after; its answers
    (u, reactions, cases, frequencies and modes) are the bits, and its
    iterations the counts, of the eager run."""
    from femx_torch.parallel import launch, rank_checks
    from torch_parallel_counts import check_routes, routes_args

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one rank a card")
    out = launch(rank_checks.replayed_and_eager, 2, *routes_args(route, "cuda", str(tmp_path)),
                 device="cuda", timeout=600)
    assert out["backend"] == "nccl"
    assert check_routes(out, replayed=True) == {"structured": 2, "unstructured": 1}[route]
