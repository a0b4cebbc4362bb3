"""femx_torch's solid extras == femx's on the CPU: the Tet10 stress terms
(rtol 1e-13), compute_stresses on femx's displacements (1e-12),
solve_cases on every single-device route (structured block-Jacobi and
multigrid, transpose-gather block-Jacobi and lattice MG, the generic
block-Jacobi and the dense small-mesh routes; displacements 1e-8,
iterations per case within 1; float32 analyses to
femx's float64 answers, 1e-6), checkpoint/resume
(save/load, chunked CG, resume after a kill, and a checkpoint written by
each package resumed by the other), and the profiling helpers."""

import collections
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import femx
import femx.checkpoint as fx_ckpt
import femx_torch
import femx_torch.checkpoint as pt_ckpt
from femx.elements import tet10 as fx_tet10
from femx_torch.elements import tet10 as pt_tet10
from femx_torch.mesh import relabel_nodes, write_msh
from femx_torch.profiling import profile_trace, reset_stages, stage, stage_report, timeit
from femx_torch.solve.cg import pcg

torch.set_num_threads(2)

E, NU = 2e11, 0.3


@pytest.fixture(autouse=True)
def _no_femx_disk_cache(monkeypatch):
    monkeypatch.setenv("FEMX_MG_CACHE", "0")


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def _case(cells, h=0.05):
    """A box of `cells` lattice cells, its y=0 face held at 4 corners, a
    load on its top face: (dims, corners, fix, force factory)."""
    X, Y, Z = (c * h for c in cells)
    corners = [(0, 0, 0), (X, 0, 0), (0, 0, Z), (X, 0, Z)]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]

    def force(fy, fx=0.0, at=0.5):
        return [{"force_x": fx, "force_y": fy, "force_z": 0.0, "force_x_pstn": X * at,
                 "force_y_pstn": Y, "force_z_pstn": Z / 2}]

    return (X, Y, Z), corners, fix, force


# -- stress terms and compute_stresses -------------------------------------------
def test_strain_stress_and_von_mises_match_femx():
    rng = np.random.default_rng(4)
    dN = rng.standard_normal((7, 4, 3, 10))
    ue = rng.standard_normal((7, 10, 3))
    C = fx_tet10.material_matrix(E, NU)
    fs, fsig = fx_tet10.element_strain_stress(jnp.asarray(dN), jnp.asarray(C), jnp.asarray(ue))
    ps, psig = pt_tet10.element_strain_stress(torch.as_tensor(dN), C, torch.as_tensor(ue))
    _close(ps.numpy(), fs, 1e-13)
    _close(psig.numpy(), fsig, 1e-13)
    _close(pt_tet10.von_mises(psig).numpy(), fx_tet10.von_mises(fsig), 1e-13)


def test_compute_stresses_matches_femx_on_its_displacements():
    dims, corners, fix, force = _case((4, 3, 6))
    fx = femx.SolidReactionAnalysis(femx.box_tet10(*dims, 0.05, fix_points=corners),
                                    force(-500.0), fix, E=E, v=NU, verbose=False)
    fx.run_simulation()
    want = fx.compute_stresses()
    pt = femx_torch.SolidReactionAnalysis(
        femx_torch.box_tet10(*dims, 0.05, fix_points=corners), force(-500.0), fix, E=E,
        v=NU, verbose=False, device="cpu")
    pt.u = fx.u
    got = pt.compute_stresses()
    for g, w in zip(got, want):
        _close(g, w, 1e-12)
    # chunking over elements changes nothing but the summation order
    from femx_torch.analysis.solid import nodal_stresses

    for g, w in zip(nodal_stresses(pt.points, pt.tetra10_conn, pt.u, pt.C, device="cpu",
                                   chunk=37), got):
        _close(g, w, 1e-12)


# -- solve_cases -----------------------------------------------------------------
SMALL = _case((4, 2, 4))  # 1,215 DOF


@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    dims, corners, _, _ = SMALL
    mesh = femx_torch.box_tet10(*dims, 0.05, fix_points=corners)
    mesh = relabel_nodes(mesh, np.random.default_rng(1).permutation(mesh.num_nodes))
    path = str(tmp_path_factory.mktemp("msh") / "small.msh")
    write_msh(path, mesh)
    return path


ROUTES = {  # method: (source, instance thresholds, constructor keywords)
    "structured_block_jacobi_pcg": ("box", {}, {}),
    "structured_multigrid_pcg": ("box", {"MG_DOF_THRESHOLD": 600}, {}),
    "tg_block_jacobi_pcg": ("file", {"DENSE_DOF_LIMIT": 600}, {}),
    "tg_lattice_mg_pcg": ("file", {"DENSE_DOF_LIMIT": 600, "MG_DOF_THRESHOLD": 600}, {}),
    "block_jacobi_pcg": ("file", {}, {"solver": "cg"}),
    "dense_cholesky": ("file", {}, {}),
}


@pytest.mark.parametrize("method", sorted(ROUTES))
def test_solve_cases_matches_femx(method, small_file):
    """Three cases (the analysis' own load, one at another node, one mixed)
    through the stored preconditioner: the port's displacements at rtol
    1e-8 of femx's, iterations per case within 1, the same info keys."""
    dims, corners, fix, force = SMALL
    src, limits, ctor = ROUTES[method]
    cases = [force(-500.0), force(300.0, fx=200.0, at=0.25), force(-100.0, at=0.75)]
    out = {}
    for pkg in (femx, femx_torch):
        mesh = pkg.box_tet10(*dims, 0.05, fix_points=corners) if src == "box" else small_file
        kw = {"device": "cpu"} if pkg is femx_torch else {}
        fa = pkg.SolidReactionAnalysis(mesh, force(-500.0), fix, E=E, v=NU, verbose=False,
                                       cg_tol=1e-10, **ctor, **kw)
        for k, v in limits.items():
            setattr(fa, k, v)
        fa.run_simulation()
        assert fa.solve_info["method"] == method
        out[pkg.__name__] = (fa.solve_cases(cases), fa.case_solve_info, fa.u)
    (Uf, info_f, _), (Up, info_p, u) = out["femx"], out["femx_torch"]
    assert Up.shape == Uf.shape == (3, u.shape[0])
    _close(Up, Uf, 1e-8)
    _close(Up[0], u, 1e-8)
    for a, b in zip(info_p, info_f):
        assert set(a) == set(b) and a["converged"]
        assert abs(a["iterations"] - b["iterations"]) <= 1


def test_solve_cases_f32_reaches_the_f64_answer_where_femx_misses():
    """A float32 analysis (f32 block-Jacobi) solves its cases as its solve()
    does, f64 CG on the f64-assembled operator, and lands on femx's float64
    answers (1e-6); femx's float32 cases (f32 CG on the f32 operator,
    floored at 1e-5) miss them on this small corner-fixed box by more than
    ten times that (the same scheme missed by 2.7e-2 on the 8 x 8 x 32-cell
    box of the flagship's shape)."""
    dims, corners, fix, force = _case((4, 4, 8))
    cases = [force(-500.0), force(250.0, fx=100.0, at=0.25)]

    def run(pkg, dtype):
        kw = {"device": "cpu"} if pkg is femx_torch else {}
        fa = pkg.SolidReactionAnalysis(pkg.box_tet10(*dims, 0.05, fix_points=corners),
                                       force(-500.0), fix, E=E, v=NU, verbose=False,
                                       dtype=dtype, cg_tol=1e-8, **kw)
        fa.run_simulation()
        return fa, fa.solve_cases(cases)

    _, want = run(femx, np.float64)
    _, femx32 = run(femx, np.float32)
    fa, got = run(femx_torch, np.float32)
    assert got.dtype == np.float64
    assert all(i["converged"] and i["residual"] <= 1e-8 for i in fa.case_solve_info)
    _close(got, want, 1e-6)
    _close(got[0], fa.u, 1e-6)
    miss = np.abs(femx32 - want).max() / np.abs(want).max()
    assert miss > 1e-5, miss


def test_solve_cases_requires_solve():
    dims, corners, fix, force = SMALL
    fa = femx_torch.SolidReactionAnalysis(
        femx_torch.box_tet10(*dims, 0.05, fix_points=corners), force(-1.0), fix, E=E, v=NU,
        verbose=False, device="cpu")
    with pytest.raises(RuntimeError, match="solve"):
        fa.solve_cases([force(-1.0)])


# -- checkpoint ------------------------------------------------------------------
def test_save_load_state(tmp_path):
    p = str(tmp_path / "ckpt")
    pt_ckpt.save_state(p, {"x": torch.arange(5.0, dtype=torch.float64)}, {"iterations": 7})
    arrays, meta = pt_ckpt.load_state(p)
    np.testing.assert_array_equal(arrays["x"], np.arange(5.0))
    assert meta["iterations"] == 7
    assert pt_ckpt.load_state(str(tmp_path / "missing")) == (None, None)


def _spd(seed=0, n=200):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    A = Q @ np.diag(np.linspace(1.0, 500.0, n)) @ Q.T
    return A, rng.normal(size=n)


def test_pcg_checkpointed_resume(tmp_path):
    """Chunked CG converges, writes checkpoints, and resumes mid-solve."""
    A_mat, b_np = _spd()
    A_t, b = torch.as_tensor(A_mat), torch.as_tensor(b_np)

    def A(v):
        return A_t @ v

    p = str(tmp_path / "cg")
    res = pt_ckpt.pcg_checkpointed(A, b, tol=1e-10, maxiter=2000, chunk=25, checkpoint_path=p)
    assert res.converged
    x_direct = np.linalg.solve(A_mat, b_np)
    np.testing.assert_allclose(res.x.numpy(), x_direct, rtol=1e-6)
    _, meta = pt_ckpt.load_state(p)
    assert meta["iterations"] == res.iterations

    partial = pt_ckpt.pcg_checkpointed(A, b, tol=1e-10, maxiter=30, chunk=25,
                                       checkpoint_path=p + "2")
    assert not partial.converged
    resumed = pt_ckpt.pcg_checkpointed(A, b, tol=1e-10, maxiter=2000, chunk=25,
                                       checkpoint_path=p + "2")
    assert resumed.converged
    np.testing.assert_allclose(resumed.x.numpy(), x_direct, rtol=1e-6)
    # the chunks and the resume continue CG's recurrences: the uninterrupted
    # run's iterations and iterate
    plain = pcg(A, b, tol=1e-10, maxiter=2000)
    assert resumed.iterations == res.iterations == plain.iterations
    torch.testing.assert_close(resumed.x, plain.x, rtol=0, atol=0)


def test_pcg_checkpoint_of_another_system_restarts_from_x(tmp_path):
    """A file whose residual is not b - A x (another right-hand side) gives
    only its x as a starting guess."""
    A_mat, b_np = _spd()
    A_t = torch.as_tensor(A_mat)
    p = str(tmp_path / "cg")
    pt_ckpt.pcg_checkpointed(lambda v: A_t @ v, torch.as_tensor(b_np), tol=1e-10,
                             maxiter=30, chunk=25, checkpoint_path=p)
    b2 = torch.as_tensor(np.random.default_rng(9).normal(size=b_np.shape))
    res = pt_ckpt.pcg_checkpointed(lambda v: A_t @ v, b2, tol=1e-10, maxiter=2000,
                                   chunk=25, checkpoint_path=p)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A_mat, b2.numpy()), rtol=1e-6)


@pytest.mark.parametrize("writer", ["femx", "femx_torch"])
def test_pcg_checkpoint_resumes_across_packages(tmp_path, writer):
    """A partial solve persisted by one package is finished by the other."""
    A_mat, b_np = _spd(1)
    p = str(tmp_path / "cg")
    fx_args = (lambda v: jnp.asarray(A_mat) @ v, jnp.asarray(b_np))
    pt_args = (lambda v: torch.as_tensor(A_mat) @ v, torch.as_tensor(b_np))
    first, second = ((fx_ckpt, fx_args), (pt_ckpt, pt_args))[::1 if writer == "femx" else -1]
    partial = first[0].pcg_checkpointed(*first[1], tol=1e-10, maxiter=30, chunk=25,
                                        checkpoint_path=p)
    assert not bool(partial.converged)
    done = int(first[0].load_state(p)[1]["iterations"])
    assert done == int(partial.iterations) > 0
    resumed = second[0].pcg_checkpointed(*second[1], tol=1e-10, maxiter=2000, chunk=25,
                                         checkpoint_path=p)
    assert bool(resumed.converged) and int(resumed.iterations) > done
    np.testing.assert_allclose(np.asarray(resumed.x), np.linalg.solve(A_mat, b_np), rtol=1e-6)


CK = _case((3, 3, 6))  # 1,911 DOF: the case of femx's tests/test_aux.py:139


def _ck_analysis(pkg, path=None, **kw):
    dims, corners, fix, force = CK
    if pkg is femx_torch:
        kw["device"] = "cpu"
    if path is not None:
        kw.update(checkpoint=path, checkpoint_chunk=250)
    return pkg.SolidReactionAnalysis(pkg.box_tet10(*dims, 0.05, fix_points=corners),
                                     force(-500.0), fix, E=E, v=NU, verbose=False,
                                     cg_tol=1e-10, **kw)


def _killed_solve(pkg, ckpt_mod, path, monkeypatch):
    """Run pkg's checkpointed solve, 'preempted' after two persisted
    segments; returns the saved metadata."""
    real_save = ckpt_mod.save_state
    calls = {"n": 0}

    def killing_save(path_, arrays, meta=None):
        real_save(path_, arrays, meta)
        calls["n"] += 1
        if calls["n"] >= 2:
            raise KeyboardInterrupt("simulated preemption")

    fa = _ck_analysis(pkg, path)
    fa.assemble_stiffness_matrix()
    fa.apply_boundary_conditions()
    with monkeypatch.context() as m:
        m.setattr(ckpt_mod, "save_state", killing_save)
        with pytest.raises(KeyboardInterrupt):
            fa.solve()
    arrays, meta = ckpt_mod.load_state(path)
    assert arrays is not None and meta["iterations"] > 0
    return meta


@pytest.fixture(scope="module")
def ck_reference():
    return _ck_analysis(femx).run_simulation()


@pytest.mark.parametrize("writer,resumer", [("femx_torch", "femx_torch"),
                                            ("femx", "femx_torch"),
                                            ("femx_torch", "femx")])
def test_analysis_checkpoint_resume_after_kill(tmp_path, monkeypatch, ck_reference,
                                               writer, resumer):
    """checkpoint=PATH end to end (femx's tests/test_aux.py:139): a solve
    preempted after one persisted segment leaves a resumable file; a fresh
    analysis on the same path, of the same or the other package, resumes
    from it (resumed_iterations) and converges to the uncheckpointed
    answer; the port resuming its own file continues CG (the plain solve's
    iteration count), one resuming the other's restarts from x."""
    pkgs = {"femx": (femx, fx_ckpt), "femx_torch": (femx_torch, pt_ckpt)}
    path = str(tmp_path / "solve_state")
    meta = _killed_solve(*pkgs[writer], path, monkeypatch)
    fa = _ck_analysis(pkgs[resumer][0], path).run_simulation()
    info = fa.solve_info
    assert info["method"] == "structured_block_jacobi_pcg_checkpointed"
    assert info["resumed_iterations"] == meta["iterations"]
    assert info["checkpoint"] == path and info["converged"]
    np.testing.assert_allclose(fa.u, ck_reference.u, atol=np.abs(ck_reference.u).max() * 1e-7)
    if writer == resumer == "femx_torch":  # CG continued: the plain solve's count
        assert info["iterations"] == ck_reference.solve_info["iterations"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_checkpointed_solve_is_the_solve(tmp_path, ck_reference, dtype):
    """A run cut by CHECKPOINT_MAXITER resumes and continues CG: the plain
    solve's method (+ "_checkpointed"), iteration count and answer; float32
    runs f64 CG with the f32 preconditioner in chunks."""
    path = str(tmp_path / "state")
    fa = _ck_analysis(femx_torch, path, dtype=dtype)
    fa.CHECKPOINT_MAXITER = 250
    fa.run_simulation()
    assert not fa.solve_info["converged"] and fa.solve_info["iterations"] == 250
    assert fa.solve_info["resumed_iterations"] == 0
    fa = _ck_analysis(femx_torch, path, dtype=dtype).run_simulation()
    info = fa.solve_info
    plain = _ck_analysis(femx_torch, dtype=dtype).run_simulation().solve_info
    assert info["method"] == plain["method"] + "_checkpointed"
    assert info["resumed_iterations"] == 250 and info["converged"]
    assert info["iterations"] == plain["iterations"]
    ref = ck_reference.u
    np.testing.assert_allclose(fa.u, ref, atol=np.abs(ref).max() * 1e-7)


def test_tg_route_checkpoints(tmp_path, small_file):
    """The transpose-gather route chunks and resumes too."""
    dims, corners, fix, force = SMALL
    path = str(tmp_path / "tg_state")

    def run(maxiter):
        fa = femx_torch.SolidReactionAnalysis(small_file, force(-500.0), fix, E=E, v=NU,
                                              verbose=False, cg_tol=1e-10, device="cpu",
                                              checkpoint=path, checkpoint_chunk=50)
        fa.DENSE_DOF_LIMIT = 600
        fa.CHECKPOINT_MAXITER = maxiter
        return fa.run_simulation()

    first = run(100)
    assert first.solve_info["method"] == "tg_block_jacobi_pcg_checkpointed"
    assert not first.solve_info["converged"]
    fa = run(50_000)
    assert fa.solve_info["resumed_iterations"] == 100 and fa.solve_info["converged"]
    assert np.abs(fa.equilibrium_residual()).max() <= 1e-6 * 500.0


# -- profiling ---------------------------------------------------------------------
def test_stage_timers():
    reg = collections.defaultdict(list)
    for _ in range(2):
        with stage("work", registry=reg):
            sum(range(1000))
    rep = stage_report(reg)
    assert rep["work"]["calls"] == 2
    assert rep["work"]["total_s"] > 0
    reset_stages(reg)
    assert stage_report(reg) == {}


def test_timeit_waits_for_the_output():
    out = timeit(lambda x: x * 2 + 1, torch.ones(16), reps=2)
    assert out["first_s"] >= out["steady_s"] > 0
    np.testing.assert_allclose(out["output"].numpy(), 3.0)


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as d:
        torch.ones(64) @ torch.ones(64)
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
