"""femx_torch.cli against femx.cli: every subcommand on the same arguments
with --platform cpu. The --json payloads agree to 1e-9 relative (a list to
1e-9 of its largest magnitude; the plane's equilibrium residual, roundoff in
both, under 1e-9 of the load; each package's own solve_info left out but for
its method); the printed solid reactions and von Mises maximum agree to
1e-9 of the load and of the maximum. `python -m femx_torch` runs with jax
and femx blocked and loads no matplotlib on a solve without plots."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import femx.cli
import femx_torch
import femx_torch.cli

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU = ["--platform", "cpu"]
SOLID_BOX = ["--E", "2e11", "--nu", "0.3", "--force", "400,3000,-700@0.3,0.2,0.1",
             "--fix", "0,0,0:xyz", "--fix", "0,0,0.4:xyz", "--fix", "0.4,0,0:xyz",
             "--fix", "0.4,0,0.4:xy"]
_REACTION = re.compile(r"Node (\d+) \(Fix Point (\d+)\): Rx=(\S+), Ry=(\S+), Rz=(\S+) N")
_VM = re.compile(r"Max von Mises stress: (\S+) MPa at node (\d+)")


def _run_both(capsys, args):
    """(femx stdout, port stdout) of the same arguments."""
    out = []
    for main in (femx.cli.main, femx_torch.cli.main):
        assert main(CPU + args) == 0
        out.append(capsys.readouterr().out)
    return out


def _assert_close_json(got, ref, path="", skip=("solve_info",)):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            if k not in skip:
                _assert_close_json(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list) and ref and all(isinstance(v, (int, float)) for v in ref):
        a, b = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), path
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_close_json(g, r, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert got == pytest.approx(ref, rel=1e-9), path
    else:
        assert got == ref, path


def _json_last(out):
    return json.loads(out.strip().splitlines()[-1])


def test_mesh_box_then_solid_msh(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["mesh-box", "--dims", "0.4", "0.2", "0.4", "--mesh-size", "0.2",
              "--force", "0,3000,0@0.2,0.2,0.2", "--fix", "0,0,0", "--fix", "0.4,0,0.4:xz",
              "--fix", "0.4,0,0"]
    outs = []
    for main, name in ((femx.cli.main, "fx"), (femx_torch.cli.main, "pt")):
        assert main(CPU + common + ["-o", f"{name}.msh", "--html", f"{name}.html"]) == 0
        outs.append(capsys.readouterr().out)
    fx_out, pt_out = outs
    assert pt_out.replace("pt.", "fx.") == fx_out
    assert (tmp_path / "pt.msh").read_bytes() == (tmp_path / "fx.msh").read_bytes()
    assert (tmp_path / "pt.html").stat().st_size > 0
    args = ["solid", "--msh", "pt.msh", "--E", "2e11", "--nu", "0.3",
            "--force", "0,3000,0@0.2,0.2,0.2", "--fix", "0,0,0:xyz", "--fix", "0.4,0,0.4:xyz",
            "--fix", "0.4,0,0:xyz"]
    fx_out, pt_out = _run_both(capsys, args)
    _assert_same_reactions(pt_out, fx_out, 3000.0)


def _assert_same_reactions(pt_out, fx_out, load):
    r_pt, r_fx = _REACTION.findall(pt_out), _REACTION.findall(fx_out)
    assert len(r_pt) == len(r_fx) >= 2
    for a, b in zip(r_pt, r_fx):
        assert a[:2] == b[:2]  # node and fix point
        np.testing.assert_allclose(np.array(a[2:], float), np.array(b[2:], float),
                                   rtol=0, atol=1e-9 * load)


def test_solid_box_stress_report_plot_html_modal(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["solid", "--box", "0.4", "0.2", "0.4", "--mesh-size", "0.1", *SOLID_BOX,
            "--stress", "--modal", "3"]
    fx_out, pt_out = _run_both(capsys, args)
    _assert_same_reactions(pt_out, fx_out, 3000.0)
    (vm_pt, n_pt), (vm_fx, n_fx) = _VM.findall(pt_out)[0], _VM.findall(fx_out)[0]
    assert n_pt == n_fx and float(vm_pt) == pytest.approx(float(vm_fx), rel=1e-9)
    hz = [np.array(o.split("Natural frequencies [Hz]: ")[1].splitlines()[0].split(", "),
                   dtype=float) for o in (pt_out, fx_out)]
    # shift-invert Lanczos from each package's own random start, tol 1e-6
    np.testing.assert_allclose(hz[0], hz[1], rtol=1e-5)
    # the outputs: report (with the stress section), plot, viewer
    assert femx_torch.cli.main(CPU + args[:-2] + [
        "--report", "r.docx", "--plot", "vm.png", "--plot-color", "von_mises",
        "--html", "v.html", "--structured-apply", "conv"]) == 0
    out = capsys.readouterr().out
    assert "Saved result view to vm.png" in out and "Saved interactive viewer to" in out
    import zipfile

    with zipfile.ZipFile(tmp_path / "r.docx") as z:
        doc = z.read("word/document.xml").decode()
    assert "Total Reaction" in doc and "Stress Results (von Mises, nodal-averaged)" in doc
    assert (tmp_path / "vm.png").stat().st_size > 0 and (tmp_path / "v.html").stat().st_size > 0


def test_beam_json_and_text(tmp_path, capsys):
    path = str(tmp_path / "frame.msh")
    femx_torch.write_msh(path, femx_torch.cantilever_line_mesh(2.0, 4))
    args = ["beam", "--msh", path, "--E", "2e11", "--nu", "0.3", "--rho", "7800",
            "--section", "beam=rectangular section:d=0.1,b=0.05",
            "--fix-group", "fix:xyzXYZ", "--force-group", "load_y=150,-3000,400",
            "--distributed-group", "beam=0,-500,0"]
    fx_out, pt_out = _run_both(capsys, args + ["--json"])
    _assert_close_json(_json_last(pt_out), _json_last(fx_out))
    fx_out, pt_out = _run_both(capsys, args + ["--report", str(tmp_path / "b.md")])
    num = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")
    lines = [(a, b) for a, b in zip(pt_out.splitlines(), fx_out.splitlines())
             if a.startswith(("Max", "Natural"))]
    assert len(lines) == 3
    for a, b in lines:
        np.testing.assert_allclose(np.array(num.findall(a), float),
                                   np.array(num.findall(b), float), rtol=1e-9)


def test_section_json(capsys):
    for extra in (["--type", "rectangular section", "--params", "d=0.1,b=0.05"],
                  ["--type", "hollow box section", "--params", "d=0.2,b=0.1,t=0.01",
                   "--method", "closed_form", "--rotate"]):
        fx_out, pt_out = _run_both(capsys, ["section", *extra])
        _assert_close_json(_json_last(pt_out), _json_last(fx_out))


def test_shaft_json_report_plot(tmp_path, capsys):
    args = ["shaft", "--segment", "0.6,0.05", "--segment", "0.4,0.04,0.02",
            "--bearing", "0", "--bearing", "1.0", "--E", "2e11", "--nu", "0.3",
            "--modes", "8", "--json"]
    fx_out, pt_out = _run_both(capsys, args)
    _assert_close_json(_json_last(pt_out), _json_last(fx_out))
    assert femx_torch.cli.main(CPU + args + [
        "--report", str(tmp_path / "s.md"), "--plot-mode", "1",
        "--plot", str(tmp_path / "m.png")]) == 0
    assert (tmp_path / "m.png").stat().st_size > 0 and (tmp_path / "s.md").exists()


def test_plane_json(tmp_path, capsys):
    args = ["plane", "--plate", "0.4", "0.1", "--mesh-size", "0.05", "--E", "2e11",
            "--nu", "0.3", "--thickness", "0.01", "--force-edge", "right=200,-1000",
            "--fix-edge", "left", "--force", "50,0@0.2,0.1", "--modal", "3", "--json"]
    fx_out, pt_out = _run_both(capsys, args)
    got, ref = _json_last(pt_out), _json_last(fx_out)
    assert got["solve_info"]["method"] == ref["solve_info"]["method"] == "dense_cholesky"
    for payload in (got, ref):
        assert np.abs(payload.pop("equilibrium_residual")).max() <= 1e-9 * 1250.0
    _assert_close_json(got, ref)
    assert femx_torch.cli.main(CPU + args[:-1] + [
        "--report", str(tmp_path / "p.md"), "--plot", str(tmp_path / "p.png"),
        "--plot-field", "sxy"]) == 0
    assert (tmp_path / "p.png").stat().st_size > 0
    assert femx_torch.cli.main(CPU + ["plane", "--E", "2e11", "--nu", "0.3"]) == 2


def test_pipe_json(capsys):
    args = ["pipe", "--ri", "0.1", "--ro", "0.16", "--E", "2e11", "--nu", "0.3",
            "--pi", "50e6", "--Ti", "120", "--To", "20", "--nr", "16", "--nz", "4", "--json"]
    fx_out, pt_out = _run_both(capsys, args)
    got, ref = _json_last(pt_out), _json_last(fx_out)
    assert got["solve_info"]["method"] == ref["solve_info"]["method"]
    _assert_close_json(got, ref)


def test_devices_and_platform_raise(capfd):
    """--devices 2 starts two ranks (femx_torch.parallel.launch) and solves
    on both; the platforms without a card raise."""
    args = ["solid", "--box", "0.2", "0.1", "0.1", "--mesh-size", "0.05", "--E", "2e11",
            "--nu", "0.3"]
    box = ["solid", "--box", "0.2", "0.2", "0.4", "--mesh-size", "0.05", "--E", "2e11",
           "--nu", "0.3", "--force", "0,-100,0@0.1,0.1,0.4", "--fix", "0,0,0:xyz",
           "--fix", "0.2,0,0:xyz", "--fix", "0,0.2,0:xyz", "--fix", "0.2,0.2,0:xyz"]
    assert femx_torch.cli.main(CPU + box + ["--devices", "2"]) == 0
    assert "System solved on 2 devices" in capfd.readouterr().out
    if not torch.cuda.is_available():
        for platform in ([], ["--platform", "gpu"], ["--platform", "auto"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                femx_torch.cli.main(platform + args)
    with pytest.raises(SystemExit):
        femx_torch.cli.main(["--platform", "tpu"] + args)
    capfd.readouterr()


def test_module_entry_runs_with_jax_and_femx_blocked():
    code = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["femx"] = None
sys.argv = ["femx_torch", "--platform", "cpu", "shaft", "--segment", "2.0,0.04",
            "--bearing", "0", "--bearing", "2", "--E", "2e11", "--nu", "0.3", "--json"]
try:
    runpy.run_module("femx_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and (m.split(".")[0] in ("jax", "femx", "matplotlib"))]
print("EXIT", code, loaded)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[-1] == "EXIT 0 []", p.stdout + p.stderr
    payload = json.loads(lines[-2])
    assert payload["critical_speeds_rpm"][0] == pytest.approx(1187.8, rel=1e-3)


def test_cli_module_as_script_solid():
    """`python -m femx_torch.cli solid`, on one device and on two ranks,
    prints the reactions of the in-process run to 1e-9 of the load."""
    box = ["solid", "--box", "0.2", "0.2", "0.4", "--mesh-size", "0.05", "--E", "2e11",
           "--nu", "0.3", "--force", "0,-100,0@0.1,0.1,0.4", "--fix", "0,0,0:xyz",
           "--fix", "0.2,0,0:xyz", "--fix", "0,0.2,0:xyz", "--fix", "0.2,0.2,0:xyz"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    outs = []
    for extra in ([], ["--devices", "2"]):
        p = subprocess.run([sys.executable, "-m", "femx_torch.cli", *CPU, *box, *extra],
                           cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stdout + p.stderr
        outs.append(p.stdout)
    assert "System solved on 2 devices" in outs[1]
    _assert_same_reactions(outs[0], outs[1], 100.0)
