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
