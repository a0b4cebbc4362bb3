"""femx_torch's counterparts of two small public entries of femx, held to
femx's on the CPU: set_default_dtype (exported from the package; the dtype
an analysis without dtype= takes, restored after) and
SolidOperator.constrained_diagonal (1e-13 relative on a relabelled box with
a random mask)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import femx
import femx_torch
from femx.assembly import SolidOperator as FxOp
from femx_torch.assembly import SolidOperator as PtOp
from femx_torch.elements.tet10 import material_matrix

torch.set_num_threads(2)


@pytest.fixture
def restore_default_dtype():
    fx, pt = femx.default_dtype(), femx_torch.default_dtype()
    yield
    femx.set_default_dtype(fx)
    femx_torch.set_default_dtype(pt)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, torch.float32])
def test_set_default_dtype_matches_femx(restore_default_dtype, dtype):
    femx_torch.set_default_dtype(dtype)
    name = str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else \
        np.dtype(dtype).name
    femx.set_default_dtype(name)
    assert str(femx_torch.default_dtype()) == f"torch.{np.dtype(femx.default_dtype()).name}"
    # an analysis given no dtype solves in the default one
    mesh = femx_torch.box_tet10(0.2, 0.1, 0.1, 0.05)
    fa = femx_torch.SolidReactionAnalysis(
        mesh, [{"force_x": 0, "force_y": -100.0, "force_z": 0, "force_x_pstn": 0.2,
                "force_y_pstn": 0.05, "force_z_pstn": 0.05}],
        [{"pos_x": 0, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
         for y, z in [(0, 0), (0.1, 0), (0, 0.1), (0.1, 0.1)]],
        E=2e11, v=0.3, verbose=False, device="cpu")
    fa.assemble_stiffness_matrix()
    assert fa.operator.dtype == np.dtype(name)
    with pytest.raises(TypeError):
        femx_torch.set_default_dtype(np.int32)


def test_constrained_diagonal_matches_femx():
    mesh = femx.box_tet10(0.2, 0.2, 0.3, 0.1)
    conn = np.asarray(mesh.cells["tetra10"])
    pts = np.asarray(mesh.points)
    relabel = np.random.default_rng(0).permutation(len(pts))
    pts_s = np.empty_like(pts)
    pts_s[relabel] = pts
    conn = relabel[conn]
    mask = (np.random.default_rng(1).random(3 * len(pts)) > 0.2).astype(np.float64)
    C = material_matrix(2e11, 0.3)
    fx = FxOp.from_mesh(pts_s, conn, C)[0].with_free_mask(jnp.asarray(mask))
    pt = PtOp.from_mesh(pts_s, conn, C, device="cpu")[0].with_free_mask(mask)
    got, want = pt.constrained_diagonal().numpy(), np.asarray(fx.constrained_diagonal())
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
    assert np.all(got[mask == 0] == 1.0)
