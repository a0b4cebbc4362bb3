"""femx_torch on a CUDA card: the hand-written kernel against its plain
version, the structured apply and a small solve against the same run on
the CPU. Every test here carries the `cuda` marker and skips without a card.

This file imports neither jax nor femx, so it also runs on a GPU machine
without JAX; tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import femx_torch
from femx_torch.assembly_structured import StructuredSolidOperator
from femx_torch.elements import cell_matmul as cm

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


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("n", [(4, 4, 8), (5, 3, 7), (1, 1, 1), (24, 24, 96)])
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
