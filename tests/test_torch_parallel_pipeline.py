"""SolidReactionAnalysis(devices=2) on a structured box, the CLI's
--devices, the dry run and entry(), on CPU ranks, against femx's devices=2
pipeline on the test process's virtual CPU devices.

Held: u and reactions (1e-9 of their largest entry), padded_nz,
distributed_levels and iterations (equal), solve_cases (1e-9), modal with
refine (frequencies 1e-6); ghost padding (nz=6 on 2 ranks -> 8); the
conv-form apply on the slabs; femx's logged fallback on an odd lattice
(solve_info["devices"] then 1); the float32 route, unpadded and padded,
against femx's float64 u and reactions (1e-8), equilibrium (1e-6 |F|) and
refined frequencies (1e-6); a checkpointed run cut and
resumed (the iterations of one uncut run), and femx's x-only checkpoint
resumed; the CLI's printed reactions (to their printed digits); the dry
run's summary line in femx's format.
"""

import re

import jax
import numpy as np
import pytest

import femx
from femx.parallel.driver import DistributedStructuredSolver as FxDriver

import femx_torch
from femx_torch.parallel import launch, rank_checks

TIMEOUT = 240
H = 0.05


def _case(cells):
    zmax = cells[2] * H
    fixes = [{"pos_x": x, "pos_y": y, "pos_z": 0.0, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x, y in [(0, 0), (0, cells[1] * H), (cells[0] * H, 0),
                          (cells[0] * H, cells[1] * H)]]
    forces = [{"force_x": 0, "force_y": -500.0, "force_z": 0, "force_x_pstn": cells[0] * H / 2,
               "force_y_pstn": cells[1] * H / 2, "force_z_pstn": zmax}]
    return forces, fixes


def _femx(cells, **kw):
    forces, fixes = _case(cells)
    mesh = femx.box_tet10_from_cells(cells, (H, H, H))
    return femx.SolidReactionAnalysis(mesh, forces, fixes, E=2e11, v=0.3, verbose=False,
                                      cg_tol=1e-10, **kw)


def _port(cells, n=2, kwargs=None, attrs=None):
    forces, fixes = _case(cells)
    mesh = femx_torch.box_tet10_from_cells(cells, (H, H, H))
    kw = dict(E=2e11, v=0.3, cg_tol=1e-10, devices=n, device="cpu", **(kwargs or {}))
    return launch(rank_checks.solid_analysis, n, mesh, forces, fixes, kw, None, None, attrs,
                  device="cpu", timeout=TIMEOUT)


def _close(a, b, tol):
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=np.abs(b).max() * tol)


def test_structured_devices_pipeline_matches_femx():
    cells = (4, 4, 8)
    forces, fixes = _case(cells)
    case2 = [dict(forces[0], force_x=300.0)]
    mesh = femx_torch.box_tet10_from_cells(cells, (H, H, H))
    got = launch(rank_checks.solid_analysis, 2, mesh, forces, fixes,
                 dict(E=2e11, v=0.3, cg_tol=1e-10, devices=2, device="cpu"), [forces, case2],
                 dict(n_modes=3, tol=1e-8, refine=True), device="cpu", timeout=TIMEOUT)
    fa = _femx(cells, devices=2).run_simulation()
    info, want = got["solve_info"], fa.solve_info
    assert info["method"] == want["method"] == "distributed_halo_mg_pcg[2xz]"
    for k in ("devices", "distributed_levels", "padded_nz", "iterations", "converged"):
        assert info[k] == want[k], (k, info[k], want[k])
    assert info["backend"] == "gloo"
    _close(got["u"], fa.u, 1e-9)
    _close(got["reactions"], fa.reaction_forces, 1e-9)
    assert np.abs(got["equilibrium"]).max() <= 1e-6 * 500.0
    U = fa.solve_cases([forces, case2])
    _close(got["cases"], U, 1e-9)
    assert [c["iterations"] for c in got["case_solve_info"]] == [
        c["iterations"] for c in fa.case_solve_info]
    m = fa.modal(n_modes=3, tol=1e-8, refine=True)
    np.testing.assert_allclose(got["omega"], np.asarray(m.omega), rtol=1e-6)
    assert np.all(np.asarray(got["modal_error_bounds"]) < 1e-6)
    assert len(got["modal_info"]["refine_iterations"]) == 6


def test_structured_devices_padding_matches_femx():
    cells = (4, 4, 6)
    got = _port(cells)
    fa = _femx(cells, devices=2).run_simulation()
    assert got["solve_info"]["padded_nz"] == fa.solve_info["padded_nz"] == 8
    assert got["solve_info"]["iterations"] == fa.solve_info["iterations"]
    _close(got["u"], fa.u, 1e-9)
    _close(got["reactions"], fa.reaction_forces, 1e-9)


def test_structured_devices_conv_apply_reaches_the_slabs(monkeypatch):
    """structured_apply="conv" with FEMX_CONV_MIN_CELLS=1: the slabs run the
    conv-form apply, and u matches femx's slot-form devices=2 answer."""
    monkeypatch.setenv("FEMX_CONV_MIN_CELLS", "1")  # inherited by the ranks
    cells = (4, 4, 8)
    got = _port(cells, kwargs=dict(structured_apply="conv"))
    assert got["solve_info"]["structured_apply"] == "conv"
    monkeypatch.delenv("FEMX_CONV_MIN_CELLS")
    fa = _femx(cells, devices=2).run_simulation()
    _close(got["u"], fa.u, 1e-9)


def test_structured_devices_fallback_on_odd_lattice(capfd):
    """nx odd: no uniform first coarsening, so femx's logged fallback to one
    device, and solve_info says so."""
    cells = (3, 4, 8)
    got = _port(cells)
    out = capfd.readouterr().out
    assert "Distributed solve unavailable" in out and "single-device path" in out
    assert got["solve_info"]["devices"] == 1
    assert "distributed" not in got["solve_info"]["method"]
    fa = _femx(cells, devices=2).run_simulation()
    assert "distributed" not in fa.solve_info["method"]
    _close(got["u"], fa.u, 1e-9)


def _float32_against_femx_float64(cells, padded_nz):
    """The float32 devices=2 route, then modal(refine=True), against
    femx's float64 answer: u and reactions 1e-8, equilibrium 1e-6 |F|,
    refined frequencies 1e-6."""
    forces, fixes = _case(cells)
    mesh = femx_torch.box_tet10_from_cells(cells, (H, H, H))
    got = launch(rank_checks.solid_analysis, 2, mesh, forces, fixes,
                 dict(E=2e11, v=0.3, cg_tol=1e-10, devices=2, device="cpu", dtype=np.float32),
                 None, dict(n_modes=3, tol=1e-8, refine=True), device="cpu", timeout=TIMEOUT)
    ref = _femx(cells, dtype=np.float64).run_simulation()
    info = got["solve_info"]
    assert info["method"] == "distributed_halo_mg_pcg[2xz]_mixed" and info["converged"]
    assert info["padded_nz"] == padded_nz
    _close(got["u"], ref.u, 1e-8)
    _close(got["reactions"], ref.reaction_forces, 1e-8)
    assert np.abs(got["equilibrium"]).max() <= 1e-6 * 500.0
    m = ref.modal(n_modes=3, tol=1e-8, refine=True)
    np.testing.assert_allclose(got["omega"], np.asarray(m.omega), rtol=1e-6)


def test_structured_devices_float32_holds_femx_float64_answer():
    _float32_against_femx_float64((4, 4, 8), 8)


def test_structured_devices_float32_padded_holds_femx_float64_answer():
    """nz=6 on 2 ranks: the reactions through the solver's padded float64
    operator; modal's inner solves on one device (no unpadded slabs), its
    refinement on the float64 operator assembled at first need."""
    _float32_against_femx_float64((4, 4, 6), 8)


def test_structured_devices_checkpoint_cut_and_resumed(tmp_path):
    """A run cut at 20 iterations (chunks of 10) and resumed ends at the
    uncut run's iteration count and answer; a checkpoint femx's driver wrote
    (x only) resumes too."""
    cells = (4, 4, 8)
    path = str(tmp_path / "ck")
    cut = _port(cells, kwargs=dict(checkpoint=path, checkpoint_chunk=10),
                attrs={"CHECKPOINT_MAXITER": 20})
    assert cut["solve_info"]["iterations"] == 20 and not cut["solve_info"]["converged"]
    resumed = _port(cells, kwargs=dict(checkpoint=path, checkpoint_chunk=10))
    fa = _femx(cells, devices=2).run_simulation()
    info = resumed["solve_info"]
    assert info["resumed_iterations"] == 20 and info["converged"]
    assert info["iterations"] == fa.solve_info["iterations"]
    _close(resumed["u"], fa.u, 1e-9)

    fx_path = str(tmp_path / "fx")
    mask = np.asarray(fa.constraints.free_mask(), dtype=np.float64)
    fx = FxDriver(cells, (H, H, H), 2e11, 0.3, mask, dtype=np.float64, devices=2)
    u_fx, fx_info = fx.solve(np.asarray(fa.f, dtype=np.float64), tol=1e-10,
                             checkpoint_path=fx_path, checkpoint_chunk=10)
    from_fx = _port(cells, kwargs=dict(checkpoint=fx_path, checkpoint_chunk=10))
    assert from_fx["solve_info"]["resumed_iterations"] == fx_info["iterations"]
    _close(from_fx["u"], u_fx, 1e-9)


def test_cli_devices_matches_femx_cli(capfd):
    args = ["solid", "--box", "0.2", "0.2", "0.4", "--mesh-size", "0.05", "--E", "2e11",
            "--nu", "0.3", "--force", "0,-500,0@0.1,0.1,0.4", "--fix", "0,0,0:xyz",
            "--fix", "0.2,0,0:xyz", "--fix", "0,0.2,0:xyz", "--fix", "0.2,0.2,0:xyz",
            "--devices", "2"]
    import femx.cli
    import femx_torch.cli

    assert femx_torch.cli.main(["--platform", "cpu"] + args) == 0
    out_port = capfd.readouterr().out
    assert femx.cli.main(["--platform", "cpu"] + args) == 0
    out_femx = capfd.readouterr().out
    assert "System solved on 2 devices" in out_port

    def reactions(text):
        return re.findall(r"Node \d+ \(Fix Point \d\): Rx=\S+, Ry=\S+, Rz=\S+ N", text)

    assert len(reactions(out_port)) == 4 and reactions(out_port) == reactions(out_femx)


def test_dry_run_and_entry():
    """dryrun_multichip(2) passes every stage and prints femx's summary
    line; entry()'s float32 forward step agrees with femx's: u within 1e-3
    of its largest entry, the true residuals within 10 % of each other."""
    from femx_torch import graft_entry

    line = graft_entry.dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    assert re.fullmatch(
        r"dryrun_multichip OK: mesh=\(batch=1, elem=2\), ndof=1275, "
        r"dp_solve\+dof_sharded_apply\+batched\(2 cases\) \+ structured z-slab CG over 2 "
        r"devices \+ PUBLIC pipeline devices=2 \(halo distributed-MG, padded nz=8, \d+ iters, "
        r"equilibrium \S+\) \+ UNSTRUCTURED pipeline devices=2 \(distributed lattice-MG, "
        r"\d+ iters, equilibrium \S+\)", line), line

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    u_fx, r_fx = jax.jit(fn)(*args)
    fn_pt, args_pt = graft_entry.entry(device="cpu")
    u_pt, r_pt = fn_pt(*args_pt)
    _close(u_pt.numpy(), np.asarray(u_fx), 1e-3)
    # the step's CG stops at its 200-iteration budget (true residual ~0.046
    # in both packages): hold the true residuals to each other
    import torch

    op, _pts, _conn, mask, f = graft_entry._build_model(0.05, np.float64, "cpu")
    b = torch.as_tensor(f * mask)

    def rel_residual(u):
        u = torch.as_tensor(np.array(u, dtype=np.float64))
        return float((op.apply_constrained(u) - b).norm() / b.norm())

    res_pt, res_fx = rel_residual(u_pt.numpy()), rel_residual(u_fx)
    assert abs(res_pt - res_fx) <= 0.1 * res_fx, (res_pt, res_fx)
    assert r_pt.shape == np.asarray(r_fx).shape
