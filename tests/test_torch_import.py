"""femx_torch package boundary: imports without jax or femx, never falls
back to the CPU on its own, and chip_smoke.py refuses to run without a card."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|femx)(\s|\.|$)", re.M)


def _run(code_or_args, cwd=REPO, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = ([sys.executable, "-c", code_or_args] if isinstance(code_or_args, str)
            else [sys.executable, *code_or_args])
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


_TINY_SOLVE = """
import femx_torch
mesh = femx_torch.box_tet10(0.2, 0.1, 0.1, 0.05, force_points=[(0.2, 0.05, 0.05)],
                            fix_points=[(0, 0, 0), (0, 0.1, 0), (0, 0, 0.1), (0, 0.1, 0.1)])
fa = femx_torch.SolidReactionAnalysis(
    mesh, [{"force_x": 0, "force_y": -100.0, "force_z": 0, "force_x_pstn": 0.2,
            "force_y_pstn": 0.05, "force_z_pstn": 0.05}],
    [{"pos_x": 0, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
     for y, z in [(0, 0), (0.1, 0), (0, 0.1), (0.1, 0.1)]],
    E=2e11, v=0.3, verbose=False, device="cpu")
fa.run_simulation()
assert fa.solve_info["converged"], fa.solve_info
"""


def test_import_and_solve_with_jax_and_femx_blocked():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["femx"] = None
""" + _TINY_SOLVE + """
assert abs(fa.equilibrium_residual()).max() < 1e-6
assert not any(m == "jax" or m.startswith(("jax.", "femx.")) or m == "femx"
               for m in sys.modules if sys.modules[m] is not None)
print("OK", fa.solve_info["iterations"])
"""
    p = _run(code)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.startswith("OK")


def test_every_module_imports_with_jax_and_femx_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["femx"] = None
import femx_torch
names = [m.name for m in pkgutil.walk_packages(femx_torch.__path__, "femx_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), " ".join(sorted(names)))
"""
    p = _run(code)
    assert p.returncode == 0, p.stdout + p.stderr
    count, *names = p.stdout.split()
    expected = {str(f.relative_to(REPO).with_suffix("")).replace("/", ".")
                for f in (REPO / "femx_torch").rglob("*.py") if f.name != "__init__.py"}
    assert expected <= set(names) and int(count) == len(names)


def test_no_cuda_means_raise_not_fallback():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    import femx_torch
    from femx_torch.config import resolve_device

    mesh = femx_torch.box_tet10(0.2, 0.1, 0.1, 0.05)
    with pytest.raises(RuntimeError, match="CUDA"):
        femx_torch.SolidReactionAnalysis(mesh, [], [], E=2e11, v=0.3, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "femx_torch").rglob("*.py"),
                                       *(REPO / "scripts").glob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_sources_import_neither_jax_nor_femx(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.findall(text), f"{path} imports jax or femx"


def test_tf32_off_after_import():
    import femx_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: chip_smoke.py would run for real")
    p = _run(["chip_smoke.py"])
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    # alone in a directory (no package beside it) it fails as well
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    q = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert q.returncode != 0
    assert '"ok": true' not in q.stdout


def test_default_dtype_is_float64():
    from femx_torch.config import default_dtype, numpy_dtype, torch_dtype

    if os.environ.get("FEMX_DTYPE", "float64") == "float64":
        assert default_dtype() == torch.float64
    assert torch_dtype(np.float32) == torch.float32
    assert numpy_dtype(torch.float64) == np.float64
    with pytest.raises(TypeError):
        torch_dtype(np.int32)


@pytest.mark.parametrize("env_dtype,method", [
    ("float64", "structured_block_jacobi_pcg"),
    ("float32", "structured_block_jacobi_pcg_mixed"),
])
def test_entry_point_dtype_follows_femx_dtype(monkeypatch, env_dtype, method):
    """SolidReactionAnalysis with no dtype solves in FEMX_DTYPE's type."""
    monkeypatch.setenv("FEMX_DTYPE", env_dtype)
    code = _TINY_SOLVE + """
from femx_torch.config import default_dtype
print(default_dtype(), fa.operator.dtype, fa.solve_info["method"])
"""
    p = _run(code)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.split() == [f"torch.{env_dtype}", env_dtype, method]


def _entry_points():
    """Each new entry point called with its device left to the default."""
    import femx_torch
    from femx_torch.assembly_plane import AxisymOperator, PlaneOperator
    from femx_torch.mesh.generators2d import rect_tri6
    from femx_torch.sections import compute_properties
    from femx_torch.sections.geometry import rectangular
    from femx_torch.sections.warping import warping_constants
    from femx_torch.solve.multigrid2d import Multigrid2D

    line = femx_torch.cantilever_line_mesh(1.0, 2)
    plane = rect_tri6(1.0, 0.5, 0.25)
    conn, pts = plane.cells["triangle6"], plane.points
    C3, C4 = np.eye(3), np.eye(4)
    return {
        "BeamAnalysis": lambda: femx_torch.BeamAnalysis(line, [], [], E=2e11, nu=0.3),
        "ShaftModalAnalysis": lambda: femx_torch.ShaftModalAnalysis(
            [{"length": 1.0, "d": 0.02}], [0.0, 1.0], E=2e11, nu=0.3, rho=7850.0),
        "PlaneAnalysis": lambda: femx_torch.PlaneAnalysis(plane, [], [], E=2e11, v=0.3),
        "PipeThermalAnalysis": lambda: femx_torch.PipeThermalAnalysis(
            0.05, 0.08, 0.1, E=2e11, v=0.3, alpha=1e-5),
        "compute_properties": lambda: compute_properties("I section", {
            "d": 0.05, "b": 0.025, "t_f": 0.005, "t_w": 0.005}),
        "calculate_section_properties": lambda: femx_torch.calculate_section_properties(
            "circular section", {"d": 0.04}),
        "warping_constants": lambda: warping_constants(rectangular(0.02, 0.01)),
        "PlaneOperator": lambda: PlaneOperator.from_mesh(pts, conn, C3),
        "AxisymOperator": lambda: AxisymOperator.from_mesh(pts, conn, C4),
        "Multigrid2D": lambda: Multigrid2D("plane", (4, 2), (0.25, 0.25), (0.0, 0.0), C3,
                                           np.ones(2 * len(pts))),
    }


@pytest.mark.parametrize("name", sorted(["BeamAnalysis", "ShaftModalAnalysis", "PlaneAnalysis",
                                         "PipeThermalAnalysis", "compute_properties",
                                         "calculate_section_properties", "warping_constants",
                                         "PlaneOperator", "AxisymOperator", "Multigrid2D"]))
def test_new_entry_points_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_host_surface_imports_no_matplotlib():
    """The package, the CLI, the reports, the viewers and the UI import
    without matplotlib; only a figure loads it (femx_torch.viz._pyplot)."""
    code = """
import sys
import femx_torch, femx_torch.cli, femx_torch.report, femx_torch.viz, femx_torch.viz_html
import femx_torch.viz_sections, femx_torch.ui, femx_torch.ui.qt, femx_torch.assembly_conv
assert not any(m == "matplotlib" or m.startswith("matplotlib.") for m in sys.modules)
print("OK")
"""
    p = _run(code)
    assert p.returncode == 0 and p.stdout.startswith("OK"), p.stdout + p.stderr


def test_parallel_imports_without_jax_and_covers_femx_parallel():
    """femx_torch.parallel imports with jax and femx blocked, and its
    __all__ holds every name of femx.parallel's (read from the source, so
    this test imports no jax)."""
    import ast

    tree = ast.parse((REPO / "femx" / "parallel" / "__init__.py").read_text())
    femx_all = next(ast.literal_eval(node.value) for node in tree.body
                    if isinstance(node, ast.Assign)
                    and any(getattr(t, "id", None) == "__all__" for t in node.targets))
    code = """
import sys
sys.modules["jax"] = None
sys.modules["femx"] = None
import femx_torch.parallel as p, femx_torch.parallel.rank_checks, femx_torch.graft_entry
print(" ".join(p.__all__))
"""
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr
    assert set(femx_all) <= set(out.stdout.split())
