"""structured_cell_matmul: the plain version == femx's Pallas kernel (run in
interpret mode), and the wrapper's dispatch and checks. The CUDA kernel
itself is checked against its plain version in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femx.assembly_structured import StructuredSolidOperator as FxOp
from femx.elements.pallas_structured import structured_cell_matmul as fx_cell_matmul
from femx_torch.assembly_structured import StructuredSolidOperator as PtOp
from femx_torch.elements import cell_matmul as cm

torch.set_num_threads(2)


def _ops(n_cells, dtype=np.float64, device="cpu"):
    sp = (0.05, 0.07, 0.06)
    return (FxOp.from_lattice(n_cells, sp, 2e11, 0.3, dtype=dtype),
            PtOp.from_lattice(n_cells, sp, 2e11, 0.3, dtype=dtype, device=device))


@pytest.mark.parametrize("cx", [2, 4])
def test_plain_matches_pallas_interpret(cx):
    n = (4, 2, 3)
    fx, pt = _ops(n)
    u = np.random.default_rng(0).normal(size=fx.ndof)
    tpu = np.asarray(fx_cell_matmul(fx._split_phases(jnp.asarray(u)), fx.Kcell, n,
                                    cx=cx, interpret=True))
    # TPU layout (n_chunks, 81, cx, ny, nz) -> (81, nx*ny*nz), z minor
    want = np.moveaxis(tpu, 0, 1).reshape(81, -1)
    got = cm.structured_cell_matmul_plain(torch.from_numpy(u), pt.Kcell, n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=np.abs(want).max() * 1e-14)


def test_cpu_wrapper_is_plain_and_uncounted():
    n = (3, 2, 5)
    _, pt = _ops(n)
    u = torch.from_numpy(np.random.default_rng(1).normal(size=pt.ndof))
    before = dict(cm.LAUNCHES)
    got = cm.structured_cell_matmul(u, pt.Kcell, n)
    assert got.shape == (81, 30)
    torch.testing.assert_close(got, cm.structured_cell_matmul_plain(u, pt.Kcell, n),
                               rtol=0, atol=0)
    assert dict(cm.LAUNCHES) == before


def test_wrapper_checks_inputs():
    n = (2, 2, 2)
    _, pt = _ops(n)
    u = torch.zeros(pt.ndof, dtype=torch.float64)
    with pytest.raises(TypeError):
        cm.structured_cell_matmul(u.float(), pt.Kcell, n)
    with pytest.raises(TypeError):
        cm.structured_cell_matmul(u.long(), pt.Kcell.long(), n)
    with pytest.raises(ValueError, match="expected"):
        cm.structured_cell_matmul(u[:-3], pt.Kcell, n)
    with pytest.raises(ValueError, match="expected"):
        cm.structured_cell_matmul(u, pt.Kcell[:80], n)
    with pytest.raises(RuntimeError, match="device"):
        cm.structured_cell_matmul(u.to("meta"), pt.Kcell.to("meta"), n)


def test_phase_layout_helpers():
    n = (4, 3, 5)
    fx, _ = _ops(n)
    assert cm.phase_shapes(n) == fx._phase_shapes()
    assert cm.phase_offsets(n) == fx._phase_offsets()
    u = torch.arange(fx.ndof, dtype=torch.float64)
    for got, want in zip(cm.split_phases(u, n), fx._split_phases(jnp.arange(fx.ndof))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
