"""femx_torch.parallel on CPU ranks against femx.parallel on the test
process's virtual CPU devices: the collectives, the z-slab halo and
all_reduce structured applies, pcg_halo with block-Jacobi and with the
distributed V-cycle, the element- and DOF-sharded applies, batched load
cases, distributed modal, pad_z_raster, and the launcher's failure and
deadline handling.

The port's ranks are `gloo` processes started by femx_torch.parallel.launch
(their functions live in femx_torch.parallel.rank_checks, so the children
never import jax); femx runs shard_map over the same number of devices.
Tolerances: float64 applies 1e-12 of the largest entry; CG solutions
1e-10 of the largest entry, the V-cycle's iteration counts equal and
block-Jacobi's within 1 (726 against femx's 727 at 8x8x16: rounding over
700 iterations); modal frequencies 1e-6 with femx's start vector injected
and the Lanczos step count equal.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import femx
from femx.assembly import SolidOperator as FxSolidOperator
from femx.assembly_structured import StructuredSolidOperator as FxStructured
from femx.assembly_structured import pad_z_raster as fx_pad, unpad_z_raster as fx_unpad
from femx.elements import tet10 as fx_tet10
from femx.parallel import (DistributedMultigrid, HaloStructuredOperator, ShardedSolidOperator,
                           ShardedStructuredOperator, batched_solve_cg, device_mesh, pcg_halo)
from femx.parallel.modal import modal_shift_invert_halo
from femx.solve.multigrid import StructuredMultigrid

import femx_torch
from femx_torch.assembly_structured import pad_z_raster, unpad_z_raster
from femx_torch.parallel import launch, rank_checks

H = 0.05
SPACING = (H, H, H)
TIMEOUT = 240


def _cantilever(n_cells):
    """femx's halo test problem: z=0 face clamped, tip load in -y."""
    mesh = femx.box_tet10_from_cells(n_cells, SPACING)
    st = FxStructured.from_mesh(mesh, 2e11, 0.3, dtype=np.float64)
    mask = np.ones(st.ndof)
    for node in np.where(mesh.points[:, 2] < 1e-9)[0]:
        mask[3 * node:3 * node + 3] = 0.0
    f = np.zeros(st.ndof)
    tip = np.where(mesh.points[:, 2] > mesh.points[:, 2].max() - 1e-9)[0]
    f[3 * tip + 1] = -100.0 / len(tip)
    st = st.with_free_mask(st.to_internal(mask))
    return st, mask, st.to_internal(f * mask)


def _zmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("z",))


def test_pad_z_raster_matches_femx():
    grid_old, grid_new = (5, 3, 7), (5, 3, 11)
    v = np.random.default_rng(0).standard_normal(3 * 5 * 3 * 7)
    p = pad_z_raster(v, grid_old, grid_new)
    np.testing.assert_array_equal(p, np.asarray(fx_pad(v, grid_old, grid_new)))
    np.testing.assert_array_equal(unpad_z_raster(p, grid_old, grid_new), v)
    np.testing.assert_array_equal(unpad_z_raster(p, grid_old, grid_new),
                                  np.asarray(fx_unpad(p, grid_old, grid_new)))


@pytest.mark.parametrize("n", [2, 3])
def test_collectives_on_cpu_ranks(n):
    """all_reduce, all_gather, reduce_scatter and the neighbour exchange
    against numpy (float64 exact to 4 ulp of the sum, float32 to 1e-6)."""
    out = launch(rank_checks.collectives, n, 257, 1, "cpu", device="cpu", timeout=TIMEOUT)
    assert out["backend"] == "gloo" and out["world"] == n
    for k, v in out.items():
        if k.endswith("/float64"):
            assert v <= 1e-14 * n, (k, v)
        elif k.endswith("/float32"):
            assert v <= 1e-6 * n, (k, v)
    for k in ("all_gather/float32", "all_gather/float64", "exchange/float32",
              "exchange/float64"):
        assert out[k] == 0.0, (k, out[k])


@pytest.mark.parametrize("n,cells", [(2, (4, 4, 8)), (4, (2, 2, 8))])
def test_halo_and_sharded_apply_match_femx(n, cells):
    st, mask, _f = _cantilever(cells)
    u = np.random.default_rng(3).standard_normal(st.ndof)
    got = launch(rank_checks.structured_apply, n, cells, SPACING, mask, u, "float64", "cpu",
                 device="cpu", timeout=TIMEOUT)
    dmesh = _zmesh(n)
    halo = HaloStructuredOperator(st, dmesh)
    fn = jax.shard_map(lambda ub, mb: halo.apply_constrained_local(ub[0], mb[0])[None],
                       mesh=dmesh, in_specs=(P("z"), P("z")), out_specs=P("z"))
    want = halo.gather(np.asarray(jax.jit(fn)(jnp.asarray(halo.scatter(u)),
                                              jnp.asarray(halo.mask_stacked()))))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got["halo"], want, rtol=0, atol=scale * 1e-12)
    sharded = np.asarray(jax.jit(ShardedStructuredOperator(op=st, mesh=dmesh).apply_constrained)(
        jnp.asarray(u)))
    np.testing.assert_allclose(got["sharded"], sharded, rtol=0, atol=scale * 1e-12)


def test_pcg_halo_and_distributed_multigrid_match_femx():
    """Two distributed levels and the replicated handoff (8x8x16 on 2
    ranks): block-Jacobi and V-cycle PCG to 1e-10; the V-cycle's iterations
    equal femx's, block-Jacobi's within 1."""
    cells = (8, 8, 16)
    st, mask, f_int = _cantilever(cells)
    got = launch(rank_checks.structured_solve, 2, cells, SPACING, mask, f_int, "float64",
                 1e-10, "cpu", device="cpu", timeout=TIMEOUT)
    dmesh = _zmesh(2)
    x_bj, it_bj, _res, ok = pcg_halo(HaloStructuredOperator(st, dmesh), f_int, tol=1e-10)
    mg = StructuredMultigrid(None, cells, 2e11, 0.3, mask, spacing=SPACING,
                             dtype=np.float64, fine_op=st)
    dmg = DistributedMultigrid(mg, dmesh)
    x_mg, it_mg, _res2, ok2 = pcg_halo(dmg.halo, f_int, tol=1e-10,
                                       preconditioner=dmg.preconditioner())
    assert ok and ok2 and got["bj"][3] and got["mg"][3]
    assert got["distributed_levels"] == dmg.n_dist == 2
    assert abs(got["bj"][1] - it_bj) <= 1 and got["mg"][1] == it_mg, (
        got["bj"][1:], it_bj, got["mg"][1:], it_mg)
    for (x, *_), want in ((got["bj"], x_bj), (got["mg"], x_mg)):
        np.testing.assert_allclose(x, want, rtol=0, atol=np.abs(want).max() * 1e-10)


def test_element_and_dof_sharded_applies_and_batched_cases_match_femx():
    mesh = femx.box_tet10(0.4, 0.1, 0.1, 0.05)
    conn = np.asarray(mesh.cells["tetra10"])
    C = fx_tet10.material_matrix(2e11, 0.3, dtype=jnp.float64)
    op, _ = FxSolidOperator.from_mesh(np.asarray(mesh.points), conn, C)
    mask = np.ones(op.ndof)
    for n in np.where(mesh.points[:, 0] < 1e-9)[0]:
        mask[3 * n:3 * n + 3] = 0.0
    op = op.with_free_mask(jnp.asarray(mask))
    rng = np.random.default_rng(1)
    u = rng.standard_normal(op.ndof)
    f = np.zeros(op.ndof)
    f[3 * int(np.argmax(mesh.points[:, 0])) + 1] = -1000.0
    cases = np.stack([f, 2.0 * f, rng.standard_normal(op.ndof)])
    got = launch(rank_checks.element_ops, 2, np.asarray(mesh.points), conn, mask, u, cases,
                 "cpu", device="cpu", timeout=TIMEOUT)
    dmesh = device_mesh(2)
    sop = ShardedSolidOperator.create(op, dmesh)
    want = np.asarray(sop.apply(jnp.asarray(u)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got["apply"], want, rtol=0, atol=scale * 1e-12)
    np.testing.assert_allclose(got["apply_constrained"],
                               np.asarray(sop.apply_constrained(jnp.asarray(u))),
                               rtol=0, atol=scale * 1e-12)
    pad = (-op.ndof) % 2
    u_sh = jax.device_put(jnp.asarray(np.concatenate([u, np.zeros(pad)])),
                          NamedSharding(dmesh, P("elem")))
    np.testing.assert_allclose(got["dof_sharded"],
                               np.asarray(sop.apply_dof_sharded(u_sh))[:op.ndof],
                               rtol=0, atol=scale * 1e-12)
    X = np.asarray(batched_solve_cg(op, jnp.asarray(cases) * op.free_mask,
                                    op.block_jacobi_preconditioner(), tol=1e-10))
    np.testing.assert_allclose(got["cases"], X, rtol=0, atol=np.abs(X).max() * 1e-10)


def test_modal_shift_invert_halo_matches_femx_with_its_start_vector():
    cells = (4, 4, 8)
    st, mask, _f = _cantilever(cells)
    m_int = st.lumped_mass_diagonal(7850.0)
    s = st.free_mask_host
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    v0 = jax.random.normal(sub, (st.ndof,), dtype=jnp.float64) * jnp.asarray(s)
    v0 = np.asarray(v0 / jnp.linalg.norm(v0))
    got = launch(rank_checks.modal_halo, 2, cells, SPACING, mask, 7850.0, v0, 3, "float64",
                 1e-8, 1e-10, "cpu", device="cpu", timeout=TIMEOUT)
    mg = StructuredMultigrid(None, cells, 2e11, 0.3, mask, spacing=SPACING, dtype=np.float64,
                             fine_op=st)
    want = modal_shift_invert_halo(DistributedMultigrid(mg, _zmesh(2)), m_int, s, n_modes=3,
                                   tol=1e-8, inner_tol=1e-10)
    np.testing.assert_allclose(got["omega"], np.asarray(want.omega), rtol=1e-6)
    assert got["iterations"] == int(want.iterations)
    assert len(got["inner_iterations"]) == got["iterations"]


def test_launch_raises_on_a_failing_rank_and_past_its_deadline():
    """A rank that raises fails the launch; a rank past the deadline is
    killed and the launch raises, well before the rank would return."""
    with pytest.raises(Exception, match="femx_torch.parallel.launch"):
        launch(femx_torch.parallel.comm.require_world, 2, 3, device="cpu", timeout=60)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deadline"):
        launch(time.sleep, 2, 120, device="cpu", timeout=8)
    assert time.monotonic() - t0 < 60


def test_devices_without_a_group_raises_naming_the_launcher():
    mesh = femx_torch.box_tet10_from_cells((2, 2, 4), SPACING)
    fix = [{"pos_x": 0, "pos_y": 0, "pos_z": 0, "fix_x": 0, "fix_y": 0, "fix_z": 0}]
    force = [{"force_x": 0, "force_y": -1.0, "force_z": 0, "force_x_pstn": 0.1,
              "force_y_pstn": 0.1, "force_z_pstn": 0.2}]
    with pytest.raises(ValueError, match="femx_torch.parallel.launch"):
        femx_torch.SolidReactionAnalysis(mesh, force, fix, E=2e11, v=0.3, devices=2,
                                         device="cpu", verbose=False)
    assert femx_torch.parallel.device_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="femx_torch.parallel.launch"):
        femx_torch.parallel.device_mesh(2, device="cpu")
