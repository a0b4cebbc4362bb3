"""femx_torch.assembly_groupell == femx.assembly_groupell on the CPU, the
nine cases of tests/test_assembly_groupell.py held against femx on the same
relabelled boxes: K@u in global order against femx's einsum operator and
its group-ELL (1e-13 relative in float64, also with femx's arrays carried
across); the layout, its dummy slots and the whole block structure
(exact); constrained apply, diagonal and block-Jacobi (1e-12); the float64
shadow of a float32 operator (1e-12) and the float32 build against femx's
float64 build (1e-6); bfloat16 block storage (2e-2 of femx's float32 apply,
1e-2 of its bfloat16 one); the device build against the host builds of
both packages (blocks 1e-13); symmetric storage (its structure equal to
femx's, apply 1e-12 of the full storage); block-Jacobi PCG (femx's
iteration count, x 1e-9); and the analysis route (displacements 1e-8 of the
port's TG route and of femx's group-ELL route, float32 to femx's float64,
solve_cases, checkpoint=, the TG fallback above the block cap, and modal's
error beside femx's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import femx
import femx_torch
from femx.assembly import SolidOperator as FxOp
from femx.assembly_groupell import SolidOperatorGroupELL as FxGE
from femx.elements.tet10 import material_matrix
from femx.mesh.core import Mesh as FxMesh
from femx.solve.cg import pcg as fx_pcg
from femx_torch import convert
from femx_torch.assembly_groupell import GROUP, GroupELLShadow, SolidOperatorGroupELL as PtGE
from femx_torch.mesh.core import Mesh as PtMesh
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


def _scrambled_box(mesh_size=0.1):
    """tests/test_assembly_groupell.py's relabelled box."""
    mesh = femx.box_tet10(0.3, 0.2, 0.4, mesh_size=mesh_size)
    conn = np.asarray(mesh.cells["tetra10"])
    pts = np.asarray(mesh.points)
    relabel = np.random.default_rng(0).permutation(len(pts))
    pts_s = np.empty_like(pts)
    pts_s[relabel] = pts
    return pts_s, relabel[conn]


@pytest.fixture(scope="module")
def box():
    return _scrambled_box()


def _kglobal(op, u):
    """op's K @ u in global order (numpy in, numpy out), either package."""
    x = op.to_internal(u)
    if isinstance(op, (PtGE, GroupELLShadow)):
        return op.to_global(op.apply(torch.as_tensor(x, dtype=op.dtype)).numpy())
    return op.to_global(np.asarray(op.apply(jnp.asarray(x))))


def _carried(fx, io_dtype=None):
    """femx's group-ELL operator carried across as arrays."""
    sym = {}
    if fx.symmetric:
        sym = dict(tidx=[np.asarray(t) for t in fx.tidx], tdeg=fx.tdeg,
                   out_take=np.asarray(fx.out_take), ord_rb=np.asarray(fx.ord_rb),
                   bd_dev=np.asarray(fx.bd_dev))
    return convert.groupell_operator_from_arrays(
        [np.asarray(i) for i in fx.idx], [np.asarray(k) for k in fx.Kb], fx.bucket_g,
        np.asarray(fx.pairperm), fx.new_of_old, fx.n_nodes, fx.n_pad, fx.weight, fx._bd_host,
        fx._points, fx._conn, fx._E_mod, fx._nu, io_dtype=io_dtype, device="cpu", **sym)


@pytest.mark.parametrize("source", ["built", "carried"])
def test_apply_matches_einsum_operator(source):
    pts, conn = _scrambled_box(mesh_size=0.05)
    ref, _ = FxOp.from_mesh(pts, conn, material_matrix(E, NU))
    fx, dj_fx = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float64)
    if source == "built":
        op, dj = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, device="cpu")
        _close(dj, dj_fx, 1e-13)
        assert np.all(dj > 0) and op.n_pad % GROUP == 0 and op.n_pad >= len(pts)
    else:
        op = _carried(fx)
    u = np.random.default_rng(1).standard_normal(3 * len(pts))
    got = _kglobal(op, u)
    _close(got, np.asarray(ref.apply(jnp.asarray(u))), 1e-13)
    _close(got, _kglobal(fx, u), 1e-13)


def test_roundtrip_layout_and_dummy_slots(box):
    pts, conn = box
    op, _ = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, device="cpu")
    fx, _ = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float64)
    assert (op.n_pad, op.bucket_g) == (fx.n_pad, fx.bucket_g)
    np.testing.assert_array_equal(op.new_of_old, fx.new_of_old)
    np.testing.assert_array_equal(op.pairperm.numpy(), np.asarray(fx.pairperm))
    for a, b in zip(op.idx, fx.idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert op.gather_rows() == fx.gather_rows()
    assert op.gathers_per_apply == 1 + sum(1 for g in op.bucket_g if g)
    x = np.arange(3 * len(pts), dtype=np.float64)
    xi = op.to_internal(x)
    assert xi.shape == (3 * op.n_pad,)
    np.testing.assert_array_equal(xi, fx.to_internal(x))
    np.testing.assert_array_equal(op.to_global(xi), x)
    filled = np.zeros(op.n_pad, dtype=bool)
    filled[op.new_of_old] = True
    assert np.all(xi.reshape(-1, 3)[~filled] == 0)


def test_constrained_apply_diagonal_block_jacobi(box):
    pts, conn = box
    rng = np.random.default_rng(2)
    mask = (rng.random(3 * len(pts)) > 0.1).astype(np.float64)
    fx, _ = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float64)
    op, _ = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, device="cpu")
    fx = fx.with_free_mask(fx.to_internal(mask))
    op = op.with_free_mask(op.to_internal(mask))
    u = op.to_internal(rng.standard_normal(3 * len(pts)))
    _close(op.apply_constrained(torch.as_tensor(u)), fx.apply_constrained(jnp.asarray(u)), 1e-12)
    _close(op.diagonal(), fx.diagonal(), 1e-12)
    binv, binv_fx = op.block_jacobi_tensors(), fx.block_jacobi_tensors()
    _close(binv, binv_fx, 1e-12)
    r = u * op.to_internal(mask)
    _close(op.apply_block_jacobi(binv, torch.as_tensor(r)),
           fx.apply_block_jacobi(binv_fx, jnp.asarray(r)), 1e-12)
    # a mask given as a tensor reaches the same block-Jacobi tensors
    op_t = op.with_free_mask(torch.as_tensor(op.to_internal(mask)))
    assert op_t.free_mask_host is None
    _close(op_t.block_jacobi_tensors(), binv_fx, 1e-12)


def test_f64_shadow_and_f32_build(box):
    """astype(float64) of a float32 operator is the SoA shadow on the same
    internal layout (femx's residual operator); the float32 build (summed
    in float64, rounded once) is femx's float64 build to float32
    rounding."""
    pts, conn = box
    mask = np.ones(3 * len(pts))
    mask[:30] = 0.0
    op32, _ = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float32, device="cpu")
    assert op32.dtype == torch.float32 and op32.Kb[-1].dtype == torch.float32
    op32 = op32.with_free_mask(op32.to_internal(mask).astype(np.float32))
    sh = op32.astype(np.float64)
    assert isinstance(sh, GroupELLShadow) and sh.dtype == torch.float64
    assert op32.astype(np.float32) is op32 and sh.astype(np.float64) is sh
    fx64, _ = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float64)
    fx64 = fx64.with_free_mask(fx64.to_internal(mask))
    fx_sh = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float32)[0].with_free_mask(
        fx64.to_internal(mask).astype(np.float32)).astype(np.float64)
    u = np.random.default_rng(4).standard_normal(3 * len(pts))
    ui = sh.to_internal(u)
    want = np.asarray(fx64.apply_constrained(jnp.asarray(ui)))
    _close(sh.apply_constrained(torch.as_tensor(ui)), want, 1e-12)
    _close(sh.apply(torch.as_tensor(ui)), fx_sh.apply(jnp.asarray(ui)), 1e-12)
    _close(op32.apply_constrained(torch.as_tensor(ui, dtype=torch.float32)), want, 1e-6)
    # the float32 cast of a float64 build is the float32 build
    op64, _ = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, device="cpu")
    c32 = op64.cast(np.float32)
    for a, b in zip(c32.Kb, op32.Kb):
        assert torch.equal(a, b)


def test_kb_bfloat16_storage(box):
    pts, conn = box
    fx32, _ = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float32)
    fxbf, _ = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float32, kb_dtype="bfloat16")
    opbf, _ = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float32, kb_dtype="bfloat16",
                             device="cpu")
    assert opbf.dtype == torch.float32 and opbf.Kb[-1].dtype == torch.bfloat16
    u = np.random.default_rng(5).standard_normal(3 * len(pts)).astype(np.float32)
    want = _kglobal(fx32, u)
    got = _kglobal(opbf, u)
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-2 * scale)
    assert np.abs(got - want).max() / scale > 1e-7, "bfloat16 storage not exercised"
    np.testing.assert_allclose(got, _kglobal(fxbf, u), atol=1e-2 * scale)
    # femx's bfloat16 blocks carried across apply as the port's own
    np.testing.assert_allclose(_kglobal(_carried(fxbf, io_dtype=np.float32), u), got,
                               atol=1e-2 * scale)


def test_device_build_matches_host_build(box):
    pts, conn = box
    op_h, dj_h = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, build="host", device="cpu")
    op_d, dj_d = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, build="device",
                                device="cpu")
    fx_h, _ = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float64, build="host")
    for op in (op_d, fx_h):
        assert op.bucket_g == op_h.bucket_g
        np.testing.assert_array_equal(op.new_of_old, op_h.new_of_old)
        np.testing.assert_array_equal(np.asarray(op.pairperm), op_h.pairperm.numpy())
        for a, b in zip(op_h.idx, op.idx):
            np.testing.assert_array_equal(np.asarray(b), a.numpy())
    _close(dj_d, dj_h, 1e-12)
    for a, b, c in zip(op_h.Kb, op_d.Kb, fx_h.Kb):
        if a.numel():
            scale = float(a.abs().max())
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-13 * scale)
            np.testing.assert_allclose(np.asarray(c), a.numpy(), atol=1e-13 * scale)
    for bd in (op_d.bd_host, fx_h._bd_host):
        np.testing.assert_allclose(bd, op_h.bd_host, atol=1e-13 * np.abs(op_h.bd_host).max())
    u = np.random.default_rng(7).standard_normal(3 * len(pts))
    _close(_kglobal(op_d, u), _kglobal(op_h, u), 1e-12)
    with pytest.raises(ValueError, match="device-build only"):
        PtGE.from_mesh(pts, conn, E, NU, build="host", symmetric=True, device="cpu")


def test_symmetric_storage_matches_full(box):
    pts, conn = box
    op_f, _ = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, symmetric=False, device="cpu")
    op_s, dj = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, symmetric=True, device="cpu")
    fx_s, _ = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float64, symmetric=True)
    assert np.all(dj > 0) and op_s.symmetric
    assert op_s.gather_rows() < 0.62 * op_f.gather_rows()
    assert op_s.tdeg == fx_s.tdeg and op_s.bucket_g == fx_s.bucket_g
    for a, b in zip(op_s.tidx, fx_s.tidx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(op_s.out_take.numpy(), np.asarray(fx_s.out_take))
    np.testing.assert_array_equal(op_s.ord_rb.numpy(), np.asarray(fx_s.ord_rb))
    _close(op_s.bd_dev, fx_s.bd_dev, 1e-13)
    assert op_s.gathers_per_apply == (1 + sum(1 for g in op_s.bucket_g if g)
                                      + len(op_s.tidx) + 2)
    rng = np.random.default_rng(11)
    u = rng.standard_normal(3 * len(pts))
    yf = _kglobal(op_f, u)
    _close(_kglobal(op_s, u), yf, 1e-12)
    _close(_kglobal(fx_s, u), yf, 1e-12)
    _close(_kglobal(_carried(fx_s), u), yf, 1e-12)
    mask = (rng.random(3 * len(pts)) > 0.1).astype(np.float64)
    op_fm = op_f.with_free_mask(op_f.to_internal(mask))
    op_sm = op_s.with_free_mask(op_s.to_internal(mask))
    yf = op_fm.to_global(op_fm.apply_constrained(torch.as_tensor(op_fm.to_internal(u))).numpy())
    ys = op_sm.to_global(op_sm.apply_constrained(torch.as_tensor(op_sm.to_internal(u))).numpy())
    _close(ys, yf, 1e-12)
    bf = op_fm.block_jacobi_tensors().numpy()[op_f.new_of_old]
    bs = op_sm.block_jacobi_tensors().numpy()[op_s.new_of_old]
    np.testing.assert_allclose(bs, bf, rtol=1e-9, atol=1e-9)


def test_pcg_solve_matches(box):
    pts, conn = box
    n = 3 * len(pts)
    mask = np.ones(n)
    for nd in np.where(pts[:, 1] < 1e-9)[0]:
        mask[3 * nd:3 * nd + 3] = 0.0
    f = np.random.default_rng(3).standard_normal(n) * mask * 1e3
    fx, _ = FxGE.from_mesh(pts, conn, E, NU, dtype=np.float64)
    op, _ = PtGE.from_mesh(pts, conn, E, NU, dtype=np.float64, device="cpu")
    fx = fx.with_free_mask(fx.to_internal(mask))
    op = op.with_free_mask(op.to_internal(mask))
    bf, bp = fx.block_jacobi_tensors(), op.block_jacobi_tensors()
    rf = fx_pcg(fx.apply_constrained, jnp.asarray(fx.to_internal(f)),
                M_inv_diag=lambda r: fx.apply_block_jacobi(bf, r), tol=1e-12, maxiter=4000)
    rp = pt_pcg(op.apply_constrained, torch.as_tensor(op.to_internal(f)),
                M_inv_diag=lambda r: op.apply_block_jacobi(bp, r), tol=1e-12, maxiter=4000)
    assert rp.converged and abs(rp.iterations - int(rf.iterations)) <= 1
    _close(op.to_global(rp.x.numpy()), fx.to_global(np.asarray(rf.x)), 1e-9)


def _pipeline_case():
    pts, conn = _scrambled_box(mesh_size=0.04)  # > DENSE_DOF_LIMIT
    mesh_args = dict(points=pts, cells={"tetra10": conn},
                     cell_physical={"tetra10": np.ones(len(conn), np.int32)},
                     field_data={"box": (1, 3)})
    X, Y, Z = (float(pts[:, a].max()) for a in range(3))
    fixes = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x, z in [(0, 0), (X, 0), (0, Z), (X, Z)]]
    forces = [{"force_x": 0, "force_y": -3000.0, "force_z": 0, "force_x_pstn": X / 2,
               "force_y_pstn": Y, "force_z_pstn": Z / 2}]
    return mesh_args, forces, fixes


@pytest.fixture(scope="module")
def pipeline():
    """femx's and the port's group-ELL analyses (float64), and the port's
    TG one, on tests/test_assembly_groupell.py's pipeline case."""
    mesh_args, forces, fixes = _pipeline_case()
    kw = dict(E=E, v=NU, verbose=False, cg_tol=1e-8)
    fx = femx.SolidReactionAnalysis(FxMesh(**mesh_args), forces, fixes,
                                    unstructured_operator="groupell", **kw).run_simulation()
    out = {"femx": fx, "case": (mesh_args, forces, fixes, kw)}
    for uop in ("groupell", "tg"):
        out[uop] = femx_torch.SolidReactionAnalysis(
            PtMesh(**mesh_args), forces, fixes, unstructured_operator=uop, device="cpu",
            **kw).run_simulation()
    return out


def test_pipeline_route_groupell(pipeline):
    fx, ge, tg = pipeline["femx"], pipeline["groupell"], pipeline["tg"]
    assert ge.solve_info["method"] == fx.solve_info["method"] == "groupell_block_jacobi_pcg"
    assert isinstance(ge.operator, PtGE) and ge.solve_info["converged"]
    assert abs(ge.solve_info["iterations"] - fx.solve_info["iterations"]) <= 1
    _close(ge.u, tg.u, 1e-8)
    _close(ge.u, fx.u, 1e-8)
    _close(ge.reaction_forces, fx.reaction_forces, 1e-8)
    np.testing.assert_allclose(ge.equilibrium_residual(), 0, atol=1e-6)
    # modal: femx has no group-ELL branch (it reads op.dN); the port says so
    with pytest.raises(AttributeError, match="dN"):
        fx.modal(n_modes=2)
    with pytest.raises(NotImplementedError, match="group-ELL"):
        ge.modal(n_modes=2)


def test_pipeline_groupell_cases_checkpoint_and_f32(pipeline, tmp_path):
    """solve_cases against femx's (1e-8), checkpoint= resumed to the
    uncut solve, and the float32 route (f64 CG on the float64 build,
    float32 block-Jacobi) against femx's float64 answer (1e-8)."""
    fx, ge = pipeline["femx"], pipeline["groupell"]
    mesh_args, forces, fixes, kw = pipeline["case"]
    cases = [forces, [{**forces[0], "force_x": 800.0, "force_y": 0.0}]]
    _close(ge.solve_cases(cases), fx.solve_cases(cases), 1e-8)
    path = str(tmp_path / "state")
    cut = femx_torch.SolidReactionAnalysis(PtMesh(**mesh_args), forces, fixes,
                                           unstructured_operator="groupell", checkpoint=path,
                                           checkpoint_chunk=20, device="cpu", **kw)
    cut.CHECKPOINT_MAXITER = 40
    cut.run_simulation()
    assert cut.solve_info["iterations"] == 40 and not cut.solve_info["converged"]
    res = femx_torch.SolidReactionAnalysis(PtMesh(**mesh_args), forces, fixes,
                                           unstructured_operator="groupell", checkpoint=path,
                                           checkpoint_chunk=20, device="cpu",
                                           **kw).run_simulation()
    assert res.solve_info["method"] == "groupell_block_jacobi_pcg_checkpointed"
    assert res.solve_info["resumed_iterations"] == 40
    assert res.solve_info["iterations"] == ge.solve_info["iterations"]
    _close(res.u, ge.u, 1e-12)
    f32 = femx_torch.SolidReactionAnalysis(PtMesh(**mesh_args), forces, fixes,
                                           unstructured_operator="groupell", dtype=np.float32,
                                           device="cpu", **kw).run_simulation()
    assert f32.solve_info["method"] == "groupell_block_jacobi_pcg_mixed"
    assert f32.operator.dtype == torch.float32 and f32._op64.dtype == torch.float64
    _close(f32.u, fx.u, 1e-8)
    np.testing.assert_allclose(f32.equilibrium_residual(), 0, atol=1e-6 * 3000.0)  # 1e-6 |F|


def test_pipeline_groupell_lattice_mg_and_block_cap(pipeline, monkeypatch, capsys):
    """Above MG_DOF_THRESHOLD: the lattice MG on the padded internal layout
    (femx's method and iterations, u 1e-8); above FEMX_GROUPELL_MAX_BLOCKS
    the TG operator, with femx's log line."""
    fx_ge = pipeline["femx"]
    mesh_args, forces, fixes, kw = pipeline["case"]
    out = {}
    for pkg, Mesh in ((femx, FxMesh), (femx_torch, PtMesh)):
        fa = pkg.SolidReactionAnalysis(Mesh(**mesh_args), forces, fixes,
                                       unstructured_operator="groupell",
                                       **({"device": "cpu"} if pkg is femx_torch else {}), **kw)
        fa.MG_DOF_THRESHOLD = 2000
        out[pkg.__name__] = fa.run_simulation()
    fx, pt = out["femx"], out["femx_torch"]
    assert pt.solve_info["method"] == fx.solve_info["method"] == "groupell_lattice_mg_pcg"
    assert abs(pt.solve_info["iterations"] - fx.solve_info["iterations"]) <= 1
    _close(pt.u, fx.u, 1e-8)
    _close(pt.u, fx_ge.u, 1e-7)
    monkeypatch.setenv("FEMX_GROUPELL_MAX_BLOCKS", "10")
    fa = femx_torch.SolidReactionAnalysis(PtMesh(**mesh_args), forces, fixes,
                                          unstructured_operator="groupell", device="cpu",
                                          **{**kw, "verbose": True})
    fa.assemble_stiffness_matrix()
    assert type(fa.operator).__name__ == "SolidOperatorTG"
    assert "using the TG operator" in capsys.readouterr().out
