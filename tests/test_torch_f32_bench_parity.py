"""bench.py's float32 flow on the CPU, femx against femx_torch.bench: the f32
MG-PCG solve to 1e-5 (iteration counts equal, residuals within 1e-2 of each
other) and the 10-mode shift-invert Lanczos with the port given femx's start
vector (inner solve counts within 1; f1 within 1e-3 relative: with inner
solves to 1e-5 the float32 Lanczos f1 carries ~1e-4 of noise, measured
1.5e-4 apart at 8 x 8 x 32, where the TPU's landed 6.1e-3 from the refined
f1 at the flagship). Both run in
true float32 arithmetic on the CPU, so a difference between the port on the
card and femx on the TPU that does not show here belongs to the devices'
float32 arithmetic. The 8 x 8 x 32-cell grid runs in the fast lane; the
flagship 24 x 24 x 96 (1,390,179 DOF, several minutes on the CPU) is marked
slow. Each case prints its numbers as one JSON line (pytest -s)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from femx.modal import solid_modal_structured as fx_modal
from femx.solve.cg import pcg as fx_pcg
from femx.solve.multigrid import StructuredMultigrid as FxMG
from femx_torch import bench

torch.set_num_threads(4)


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


@pytest.mark.parametrize("grid", [(8, 8, 32), pytest.param((24, 24, 96),
                                                         marks=pytest.mark.slow)])
def test_f32_bench_flow_matches_femx_on_the_cpu(grid):
    problem = bench.flagship_problem(grid)
    sb = bench.setup_structured(problem, np.float32, "cpu")
    got = bench.f32_solve(sb)

    mg = FxMG(problem.dims, grid, bench.E_MOD, bench.NU, problem.mask, dtype=np.float32)
    op = mg.fine_op
    fj = jnp.asarray(op.to_internal(problem.f * problem.mask), dtype=jnp.float32)
    want = jax.jit(lambda fv, mg_: fx_pcg(mg_.fine_op.apply_constrained, fv, M_inv_diag=mg_,
                                          tol=1e-5, maxiter=200))(fj, mg)
    fx_m = fx_modal(op, mg, rho=bench.RHO, n_modes=10, inner_tol=1e-5, inner_maxiter=200,
                    tol=1e-4, maxiter=60)
    # femx's start vector (modal_shift_invert: PRNGKey(0), split, normal)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    v0 = np.asarray(jax.random.normal(sub, (op.ndof,), dtype=jnp.float32))
    pt_m = bench.solid_modal_structured(sb.op, sb.mg, rho=bench.RHO, n_modes=10,
                                        inner_tol=1e-5, inner_maxiter=200, tol=1e-4,
                                        maxiter=60, v0=v0)
    f_fx = np.asarray(fx_m.omega) / (2 * np.pi)
    f_pt = pt_m.omega.numpy() / (2 * np.pi)
    print(json.dumps({"grid": list(grid), "femx_f32_iters": int(want.iterations),
                      "port_f32_iters": got.iterations,
                      "femx_residual": float(want.residual_norm),
                      "port_residual": got.residual_norm,
                      "femx_inner_solves": int(fx_m.iterations),
                      "port_inner_solves": pt_m.iterations,
                      "femx_lanczos_f1_hz": float(f_fx[0]), "port_lanczos_f1_hz": float(f_pt[0])}))
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.residual_norm, float(want.residual_norm), rtol=1e-2)
    assert abs(pt_m.iterations - int(fx_m.iterations)) <= 1
    np.testing.assert_allclose(f_pt[0], f_fx[0], rtol=1e-3)
