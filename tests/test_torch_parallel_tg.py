"""The port's sharded unstructured operator and distributed lattice-MG
solve on CPU ranks against femx's on the test process's virtual CPU
devices: ShardedTGOperator's constrained apply, pcg_tg_sharded,
DistributedUnstructuredSolver, and SolidReactionAnalysis(devices=2) on a
relabelled (unstructured) box in float64 (u, reactions, iterations,
solve_cases, modal) and in float32.

Ranks are `gloo` processes of femx_torch.parallel.launch running
femx_torch.parallel.rank_checks. Tolerances: applies 1e-12 of the largest
entry; block-Jacobi and lattice-MG solutions (CG to 1e-8) 1e-6 of the
largest entry with iteration counts within 1 (equal on these inputs);
analysis u and reactions 1e-8 of their largest entry, frequencies 1e-6.
The float32 route (float64 CG with the float32 preconditioner) is held to
femx's float64 answer at 1e-8 and to equilibrium at 1e-6 |F|, where femx's
float32 refinement is held to 1e-5 (tests/test_distributed_pipeline.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import femx
from femx.mesh.core import Mesh as FxMesh
from femx.parallel.tg_lattice import DistributedUnstructuredSolver
from femx.parallel.tg_sharded import ShardedTGOperator, pcg_tg_sharded

import femx_torch
from femx_torch.mesh.core import Mesh as PtMesh
from femx_torch.parallel import launch, rank_checks

TIMEOUT = 240
H = 0.1
CELLS = (4, 4, 16)


@pytest.fixture(scope="module")
def problem():
    """femx's tests/test_tg_lattice.py problem: a relabelled 4x4x16 box,
    z=0 face clamped, tip load."""
    mesh = femx.box_tet10(0.4, 0.4, 1.6, H)
    conn = np.asarray(mesh.cells["tetra10"])
    pts = np.asarray(mesh.points)
    relabel = np.random.default_rng(5).permutation(len(pts))
    pts_s = np.empty_like(pts)
    pts_s[relabel] = pts
    conn_s = relabel[conn]
    mask = np.ones(3 * len(pts_s))
    for n in np.where(pts_s[:, 2] < 1e-9)[0]:
        mask[3 * n:3 * n + 3] = 0
    f = np.zeros(3 * len(pts_s))
    tip = np.where(pts_s[:, 2] > 1.6 - 1e-9)[0]
    f[3 * tip + 1] = -100.0 / len(tip)
    return pts_s, conn_s, mask, f


def test_sharded_tg_and_lattice_solve_match_femx(problem):
    pts, conn, mask, f = problem
    u = np.random.default_rng(0).standard_normal(3 * len(pts))
    got = launch(rank_checks.tg_ops, 2, pts, conn, mask, u, f, "float64", 1e-8, "cpu",
                 device="cpu", timeout=TIMEOUT)
    dmesh = Mesh(np.array(jax.devices()[:2]), ("z",))
    sop = ShardedTGOperator.from_mesh(pts, conn, 2e11, 0.3, dmesh, dtype=np.float64,
                                      free_mask_global=mask)
    fn = jax.jit(jax.shard_map(
        lambda ub, mb, a, b, c, d, e, g: sop._apply_constrained_local(
            ub[0], mb[0], a[0], b[0], c[0], d[0], e[0], g[0])[None],
        mesh=dmesh, in_specs=(P("z"),) * 8, out_specs=P("z")))
    want = sop.gather(np.asarray(fn(jnp.asarray(sop.scatter(u)), sop.mask_st, sop.dNg_st,
                                    sop.wdet_st, sop.conn_loc_st, sop.ell_idx_st,
                                    sop.send_up_st, sop.send_dn_st)))
    np.testing.assert_allclose(got["apply_constrained"], want, rtol=0,
                               atol=np.abs(want).max() * 1e-12)

    x, it, _res, ok = pcg_tg_sharded(sop, f * mask, tol=1e-8, maxiter=5000)
    xg, itg, _resg, okg = got["bj"]
    assert ok and okg and abs(itg - it) <= 1, (itg, it)
    np.testing.assert_allclose(xg, x, rtol=0, atol=np.abs(x).max() * 1e-6)

    solver = DistributedUnstructuredSolver.build(pts, conn, 2e11, 0.3, mask, dmesh,
                                                 dtype=np.float64)
    x, it, _res, ok = solver.solve(f * mask, tol=1e-8, maxiter=2000)
    xg, itg, _resg, okg = got["lattice"]
    assert tuple(got["lattice_cells"]) == tuple(solver.n_cells)
    assert ok and okg and abs(itg - it) <= 1, (itg, it)
    np.testing.assert_allclose(xg, x, rtol=0, atol=np.abs(x).max() * 1e-6)


def _relabelled(pkg_mesh_cls, box_fn, seed=7):
    mesh = box_fn(CELLS, (H, H, H))
    relabel = np.random.default_rng(seed).permutation(mesh.num_nodes)
    pts = np.empty_like(np.asarray(mesh.points))
    pts[relabel] = mesh.points
    conn = relabel[np.asarray(mesh.cells["tetra10"])]
    return pkg_mesh_cls(points=pts, cells={"tetra10": conn},
                        cell_physical={"tetra10": np.ones(len(conn), np.int32)},
                        field_data={"box": (1, 3)})


def _loads(pts):
    zmax = float(np.asarray(pts)[:, 2].max())
    fixes = [{"pos_x": x, "pos_y": y, "pos_z": 0.0, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x, y in [(0, 0), (0, CELLS[1] * H), (CELLS[0] * H, 0),
                          (CELLS[0] * H, CELLS[1] * H)]]
    forces = [{"force_x": 0, "force_y": -500.0, "force_z": 0, "force_x_pstn": CELLS[0] * H / 2,
               "force_y_pstn": CELLS[1] * H / 2, "force_z_pstn": zmax}]
    return forces, fixes


def test_unstructured_devices_pipeline_matches_femx():
    """devices=2 on the relabelled box: the sharded TG operator with the
    distributed lattice MG in both packages, then solve_cases and modal
    (3 modes, no refine: femx's distributed unstructured branch)."""
    fmesh = _relabelled(FxMesh, femx.box_tet10_from_cells)
    pmesh = _relabelled(PtMesh, femx_torch.box_tet10_from_cells)
    forces, fixes = _loads(fmesh.points)
    case2 = [dict(forces[0], force_x=200.0, force_y=0.0)]
    got = launch(rank_checks.solid_analysis, 2, pmesh, forces, fixes,
                 dict(E=2e11, v=0.3, cg_tol=1e-10, devices=2, device="cpu"),
                 [forces, case2], dict(n_modes=3, tol=1e-8, inner_tol=1e-10),
                 device="cpu", timeout=TIMEOUT)
    fa = femx.SolidReactionAnalysis(fmesh, forces, fixes, E=2e11, v=0.3, verbose=False,
                                    cg_tol=1e-10, devices=2).run_simulation()
    info = got["solve_info"]
    assert info["method"] == fa.solve_info["method"] == "tg_distributed_lattice_mg_pcg"
    assert info["devices"] == 2 and info["backend"] == "gloo" and info["converged"]
    assert tuple(info["lattice_cells"]) == tuple(fa.solve_info["lattice_cells"])
    assert abs(info["iterations"] - fa.solve_info["iterations"]) <= 1
    np.testing.assert_allclose(got["u"], fa.u, rtol=0, atol=np.abs(fa.u).max() * 1e-8)
    r = np.asarray(fa.reaction_forces)
    np.testing.assert_allclose(got["reactions"], r, rtol=0, atol=np.abs(r).max() * 1e-8)
    assert np.abs(got["equilibrium"]).max() <= 1e-6 * 500.0

    U = fa.solve_cases([forces, case2])
    np.testing.assert_allclose(got["cases"], U, rtol=0, atol=np.abs(U).max() * 1e-8)
    assert all(abs(a["iterations"] - b["iterations"]) <= 1
               for a, b in zip(got["case_solve_info"], fa.case_solve_info))
    m = fa.modal(n_modes=3, tol=1e-8, inner_tol=1e-10)
    np.testing.assert_allclose(got["omega"], np.asarray(m.omega), rtol=1e-6)


def test_unstructured_devices_float32_route_holds_femx_float64_answer():
    fmesh = _relabelled(FxMesh, femx.box_tet10_from_cells, seed=9)
    pmesh = _relabelled(PtMesh, femx_torch.box_tet10_from_cells, seed=9)
    forces, fixes = _loads(fmesh.points)
    got = launch(rank_checks.solid_analysis, 2, pmesh, forces, fixes,
                 dict(E=2e11, v=0.3, cg_tol=1e-8, devices=2, device="cpu",
                      dtype=np.float32), device="cpu", timeout=TIMEOUT)
    ref = femx.SolidReactionAnalysis(fmesh, forces, fixes, E=2e11, v=0.3, verbose=False,
                                     cg_tol=1e-10, dtype=np.float64).run_simulation()
    info = got["solve_info"]
    assert info["method"] == "tg_distributed_lattice_mg_pcg_mixed" and info["converged"]
    assert info["residual"] <= 1e-8 and info["devices"] == 2
    np.testing.assert_allclose(got["u"], ref.u, rtol=0, atol=np.abs(ref.u).max() * 1e-8)
    assert np.abs(got["equilibrium"]).max() <= 1e-6 * 500.0
