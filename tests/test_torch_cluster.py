"""femx_torch.assembly_cluster == femx.assembly_cluster on the CPU, the five
cases of tests/test_assembly_cluster.py held against femx on the same
relabelled box: K@u in global order against femx's einsum operator and its
cluster operator at three cluster sizes (1e-13 relative in float64, also
with femx's arrays carried across) with the same classes and buckets;
block-Jacobi PCG (femx's iteration count, x 1e-9) and the float32 build
against femx's float64 one (1e-6); the gather-row count (equal to femx's);
the analysis route from a .msh file (u and the reactions 1e-8 of femx's
cluster route, modal omega 1e-8 of femx's, solve_cases 1e-8, the float32
route against femx's float64 answer); and the operator-name validation."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import femx
import femx_torch
from femx.assembly import SolidOperator as FxOp
from femx.assembly_cluster import SolidOperatorCluster as FxCl
from femx.elements.tet10 import material_matrix
from femx.solve.cg import pcg as fx_pcg
from femx_torch import convert
from femx_torch.assembly_cluster import ClusterBJPrecond, SolidOperatorCluster as PtCl
from femx_torch.mesh import write_msh
from femx_torch.solve.cg import pcg as pt_pcg

torch.set_num_threads(2)

E, NU = 2e11, 0.3


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def meshdata():
    """tests/test_assembly_cluster.py's relabelled box."""
    mesh = femx.box_tet10(0.4, 0.3, 0.6, 0.1)
    conn = np.asarray(mesh.cells["tetra10"])
    pts = np.asarray(mesh.points)
    relabel = np.random.default_rng(7).permutation(len(pts))
    pts_s = np.empty_like(pts)
    pts_s[relabel] = pts
    return pts_s, relabel[conn]


def _kglobal(op, u):
    x = op.to_internal(u)
    if isinstance(op, PtCl):
        return op.to_global(op.apply(torch.as_tensor(x, dtype=op.dtype)).numpy())
    return op.to_global(np.asarray(op.apply(jnp.asarray(x))))


@pytest.mark.parametrize("k", [4, 8, 13])
def test_cluster_apply_matches_reference(meshdata, k):
    pts, conn = meshdata
    ref, _ = FxOp.from_mesh(pts, conn, material_matrix(E, NU))
    fx, dj_fx = FxCl.from_mesh(pts, conn, E, NU, dtype=np.float64, cluster_size=k)
    op, dj = PtCl.from_mesh(pts, conn, E, NU, dtype=np.float64, cluster_size=k, device="cpu")
    _close(dj, dj_fx, 1e-13)
    assert op.class_M == fx.class_M and op.bucket_degrees == fx.bucket_degrees
    np.testing.assert_array_equal(op.new_of_old, fx.new_of_old)
    for a, b in zip(op.cl_nodes + op.bucket_idx, fx.cl_nodes + fx.bucket_idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    carried = convert.cluster_operator_from_arrays(
        [np.asarray(K) for K in fx.Kcl], [np.asarray(n) for n in fx.cl_nodes], fx.class_M,
        [np.asarray(b) for b in fx.bucket_idx], fx.bucket_degrees, fx.new_of_old, fx.weight,
        device="cpu")
    u = np.random.default_rng(0).standard_normal(3 * len(pts))
    want = np.asarray(ref.apply(jnp.asarray(u)))
    for o in (op, carried):
        _close(_kglobal(o, u), want, 1e-13)
    _close(_kglobal(op, u), _kglobal(fx, u), 1e-13)
    assert op.gathers_per_apply == len(op.class_M) + sum(1 for d in op.bucket_degrees if d)


def test_cluster_constrained_solve_matches(meshdata):
    pts, conn = meshdata
    ndof = 3 * len(pts)
    mask = np.ones(ndof)
    for n in np.where(pts[:, 2] < 1e-9)[0]:
        mask[3 * n:3 * n + 3] = 0
    f = np.zeros(ndof)
    tip = np.where(pts[:, 2] > pts[:, 2].max() - 1e-9)[0]
    f[3 * tip + 1] = -100.0 / len(tip)
    fx, _ = FxCl.from_mesh(pts, conn, E, NU, dtype=np.float64)
    fx = fx.with_free_mask(fx.to_internal(mask))
    op, _ = PtCl.from_mesh(pts, conn, E, NU, dtype=np.float64, device="cpu")
    op = op.with_free_mask(op.to_internal(mask))
    bf, bp = fx.block_jacobi_tensors(), op.block_jacobi_tensors()
    _close(bp, bf, 1e-12)
    rf = fx_pcg(fx.apply_constrained, jnp.asarray(fx.to_internal(f * mask)),
                M_inv_diag=lambda r: fx.apply_block_jacobi(bf, r), tol=1e-10, maxiter=4000)
    rp = pt_pcg(op.apply_constrained, torch.as_tensor(op.to_internal(f * mask)),
                M_inv_diag=ClusterBJPrecond(bp), tol=1e-10, maxiter=4000)
    assert rp.converged and abs(rp.iterations - int(rf.iterations)) <= 1
    _close(op.to_global(rp.x.numpy()), fx.to_global(np.asarray(rf.x)), 1e-9)
    # the float32 build (summed in float64, rounded once) against femx's
    # float64 operator
    op32 = PtCl.from_mesh(pts, conn, E, NU, dtype=np.float32, device="cpu")[0]
    op32 = op32.with_free_mask(op32.to_internal(mask).astype(np.float32))
    assert op32.dtype == torch.float32 and op32.astype(np.float32) is op32
    u = np.random.default_rng(1).standard_normal(ndof)
    _close(_kglobal(op32, u), _kglobal(fx, u), 1e-6)
    for a, b in zip(op.astype(np.float32).Kcl, op32.Kcl):
        assert torch.equal(a, b)


def test_cluster_row_count_advantage(meshdata):
    pts, conn = meshdata
    op, _ = PtCl.from_mesh(pts, conn, E, NU, dtype=np.float32, cluster_size=16, device="cpu")
    fx, _ = FxCl.from_mesh(pts, conn, E, NU, dtype=np.float32, cluster_size=16)
    assert op.gather_rows() == fx.gather_rows() < 0.75 * 20 * len(conn)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """tests/test_assembly_cluster.py's pipeline case: the box from a .msh
    file through femx's cluster route and the port's cluster route."""
    dims = (0.2, 0.2, 0.6)
    mesh = femx_torch.box_tet10(*dims, mesh_size=0.04, force_points=[(0.1, 0.2, 0.3)],
                                fix_points=[(0, 0, 0), (0.2, 0, 0), (0, 0, 0.6), (0.2, 0, 0.6)])
    forces = [{"force_x": 0, "force_y": 3000.0, "force_z": 0, "force_x_pstn": 0.1,
               "force_y_pstn": 0.2, "force_z_pstn": 0.3}]
    fixes = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x, z in [(0, 0), (0.2, 0), (0, 0.6), (0.2, 0.6)]]
    path = str(tmp_path_factory.mktemp("msh") / "box.msh")
    write_msh(path, mesh)
    kw = dict(E=E, v=NU, verbose=False, unstructured_operator="cluster")
    fx = femx.SolidReactionAnalysis(path, forces, fixes, **kw).run_simulation()
    pt = femx_torch.SolidReactionAnalysis(path, forces, fixes, device="cpu",
                                          **kw).run_simulation()
    return fx, pt, (path, forces, fixes, kw)


def test_pipeline_cluster_operator_route(pipeline):
    fx, pt, (path, forces, fixes, kw) = pipeline
    assert 3 * pt.num_nodes > pt.DENSE_DOF_LIMIT and isinstance(pt.operator, PtCl)
    assert pt.solve_info["method"] == fx.solve_info["method"] == "cluster_block_jacobi_pcg"
    assert pt.solve_info["converged"]
    assert abs(pt.solve_info["iterations"] - fx.solve_info["iterations"]) <= 1
    _close(pt.u, fx.u, 1e-8)
    _close(pt.reaction_forces, fx.reaction_forces, 1e-8)
    np.testing.assert_allclose(pt.equilibrium_residual(), 0, atol=1e-6)
    # modal and solve_cases compose with the cluster operator, as in femx
    m_f = fx.modal(n_modes=3, rho=7850.0, tol=1e-8, inner_tol=1e-10)
    m_p = pt.modal(n_modes=3, rho=7850.0, tol=1e-8, inner_tol=1e-10)
    _close(m_p.omega.numpy(), np.asarray(m_f.omega), 1e-8)
    modes = m_p.modes.numpy()
    mass = pt.operator.to_global(pt._lumped_mass(7850.0))
    np.testing.assert_allclose(modes.T @ (mass[:, None] * modes), np.eye(3), atol=1e-6)
    cases = [forces, [{**forces[0], "force_y": -1500.0}]]
    _close(pt.solve_cases(cases), fx.solve_cases(cases), 1e-8)
    # float32: f64 CG on the float64 build, the float32 block-Jacobi
    f32 = femx_torch.SolidReactionAnalysis(path, forces, fixes, dtype=np.float32, device="cpu",
                                           **kw).run_simulation()
    assert f32.solve_info["method"] == "cluster_block_jacobi_pcg_mixed"
    assert f32.operator.dtype == torch.float32 and f32._op64.dtype == torch.float64
    _close(f32.u, fx.u, 1e-8)
    np.testing.assert_allclose(f32.equilibrium_residual(), 0, atol=1e-6 * 3000.0)


def test_unstructured_operator_validation():
    mesh = femx_torch.box_tet10(0.2, 0.2, 0.2, 0.1)
    with pytest.raises(ValueError, match="unstructured_operator"):
        femx_torch.SolidReactionAnalysis(mesh, [], [], E=E, v=NU, verbose=False, device="cpu",
                                         unstructured_operator="nope")
