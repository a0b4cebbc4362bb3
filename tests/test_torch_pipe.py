"""femx_torch.PipeThermalAnalysis against femx's on the same inputs (CPU):
nodal stresses, von Mises and displacements to 1e-8 through the dense route
(thermal + pressure + spin, plane-strain and free ends) and the
axisymmetric MG route (the float32 scheme of the shared solve_2d is
tests/test_torch_plane.py's)."""

import numpy as np
import pytest
import torch

from femx.analysis.pipe import PipeThermalAnalysis as FxPipe
from femx.analysis.pipe import log_temperature_profile as fx_log_profile
from femx_torch.analysis.pipe import PipeThermalAnalysis as PtPipe
from femx_torch.analysis.pipe import log_temperature_profile

torch.set_num_threads(2)

BASE = dict(r_inner=0.05, r_outer=0.08, length=0.1, E=2e11, v=0.3, alpha=1.2e-5,
            verbose=False)
CASES = {
    "dense_thermal_pressure_spin": (dict(T_inner=200.0, T_outer=50.0, pressure_inner=5e6,
                                         pressure_outer=1e6, rho=7850.0, spin_rpm=3000.0,
                                         n_r=8, n_z=4), None, 1e-8),
    "dense_free_end": (dict(T_inner=120.0, end_condition="free", n_r=8, n_z=6), None, 1e-8),
    "mg_route": (dict(T_inner=200.0, T_outer=50.0, pressure_inner=5e6, n_r=16, n_z=32), 100,
                 1e-8),
}


def _run(cls, kw, dense_limit, **extra):
    pa = cls(**BASE, **kw, **extra)
    if dense_limit is not None:
        pa.DENSE_DOF_LIMIT = dense_limit
    return pa.run_simulation()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipe_matches_femx(case):
    kw, limit, rel = CASES[case]
    got = _run(PtPipe, kw, limit, device="cpu")
    want = _run(FxPipe, kw, limit)
    assert got.solve_info["method"].startswith(want.solve_info["method"])
    if limit is not None:
        assert got.solve_info["converged"]
        assert abs(got.solve_info["iterations"] - want.solve_info["iterations"]) <= 1
    np.testing.assert_array_equal(got.fixed_dofs, want.fixed_dofs)
    np.testing.assert_allclose(got.f, want.f, rtol=0, atol=1e-12 * np.abs(want.f).max())
    for a, b in ((got.u, want.u), (got.stress_nodes, want.stress_nodes),
                 (got.von_mises, want.von_mises)):
        assert np.abs(a - b).max() <= rel * np.abs(b).max()
    r1, v1 = got.radial_profile(got.stress_nodes[:, 2])
    r2, v2 = want.radial_profile(want.stress_nodes[:, 2])
    np.testing.assert_array_equal(r1, r2)
    assert np.abs(v1 - v2).max() <= rel * np.abs(v2).max()


def test_log_profile_and_inputs():
    r = np.linspace(0.05, 0.08, 7)
    np.testing.assert_allclose(log_temperature_profile(r, 0.05, 0.08, 200.0, 50.0),
                               fx_log_profile(r, 0.05, 0.08, 200.0, 50.0), rtol=1e-15)
    with pytest.raises(ValueError, match="r_inner"):
        PtPipe(0.08, 0.05, 0.1, 2e11, 0.3, 1e-5, device="cpu")
    with pytest.raises(ValueError, match="end_condition"):
        PtPipe(0.05, 0.08, 0.1, 2e11, 0.3, 1e-5, end_condition="open", device="cpu")
    with pytest.raises(ValueError, match="rho"):
        PtPipe(0.05, 0.08, 0.1, 2e11, 0.3, 1e-5, spin_rpm=100.0, device="cpu")
    pa = PtPipe(0.05, 0.08, 0.1, 2e11, 0.3, 1e-5, n_r=2, n_z=2, verbose=False, device="cpu")
    for call in (pa.plot, pa.generate_report):
        with pytest.raises(NotImplementedError, match="A16"):
            call()
