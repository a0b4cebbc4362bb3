"""femx_torch.ShaftModalAnalysis against femx's on 20-element fixtures
(CPU, f64: frequencies and families to 1e-8, lambda_max/lambda_1 is small
there), and the pinned-pinned checks of tests/test_shaft_modal.py with the
whirl pair held to the tolerance the dense eigensolve supports.

femx's own test_pinned_pinned_matches_euler_bernoulli asserts the whirl
pair equal to rel=1e-9 on its 60-element fixture. On the CPU femx gives
19.795914563154717 Hz and 19.795914587567786 Hz: a 1.2e-9 relative split,
so it fails on the eigensolver's rounding of a pair that is degenerate in
exact arithmetic, and the Euler-Bernoulli assertions after it never run.
A dense symmetric eigensolve perturbs an eigenvalue by about
eps * lambda_max, so a pair splits by up to ~eps * lambda_max / lambda
relative; at 60 elements lambda_max / lambda_1 is ~1.8e7, i.e. ~4e-9.
"""

import numpy as np
import pytest
import torch

from femx.analysis.shaft import ShaftModalAnalysis as FxShaft
from femx_torch.analysis.shaft import ShaftModalAnalysis as PtShaft
from femx_torch.modal import modal_dense

torch.set_num_threads(2)

E, NU, RHO = 2.0e11, 0.3, 7850.0
EPS = np.finfo(np.float64).eps
CASES = {
    "pinned": dict(segments=[{"length": 2.0, "d": 0.04}], bearings=[0.0, 2.0]),
    "stepped_hollow_lumped": dict(
        segments=[{"length": 0.4, "d": 0.05}, {"length": 0.8, "d": 0.07, "d_inner": 0.03},
                  {"length": 0.4, "d": 0.05}],
        bearings=[0.2, 1.0, 1.6], mass="lumped"),
    "free_torsion": dict(segments=[{"length": 1.5, "d": 0.03}], bearings=[0.0, 1.5],
                         free_torsion=True),
}


def _eb_lateral_hz(n, L, d):
    I, A = np.pi * d**4 / 64.0, np.pi * d**2 / 4.0
    return (n * np.pi / L) ** 2 * np.sqrt(E * I / (RHO * A)) / (2 * np.pi)


@pytest.mark.parametrize("case", sorted(CASES))
def test_modes_and_families_match_femx(case):
    kw = dict(E=E, nu=NU, rho=RHO, n_elems=20, verbose=False, **CASES[case])
    want = FxShaft(**kw)
    want.run(n_modes=10)
    got = PtShaft(device="cpu", **kw)
    got.run(n_modes=10)
    np.testing.assert_array_equal(got.mesh.points, want.mesh.points)
    assert [m.family for m in got.modes] == [m.family for m in want.modes]
    np.testing.assert_allclose([m.frequency_hz for m in got.modes],
                               [m.frequency_hz for m in want.modes], rtol=1e-8)
    np.testing.assert_allclose(got.critical_speeds_rpm, want.critical_speeds_rpm, rtol=1e-8)


@pytest.fixture(scope="module")
def pinned_pinned():
    """tests/test_shaft_modal.py:29-35's fixture, through the port."""
    sm = PtShaft(segments=[{"length": 2.0, "d": 0.04}], bearings=[0.0, 2.0], E=E, nu=NU,
                 rho=RHO, n_elems=60, verbose=False, device="cpu")
    sm.run(n_modes=12)
    return sm


def test_pinned_pinned_matches_euler_bernoulli(pinned_pinned):
    lat = pinned_pinned.lateral_frequencies_hz()
    res = pinned_pinned.analysis.results
    lam_max = float(modal_dense(res.K, res.M, res.fixed_dofs, device="cpu").omega.max()) ** 2
    lam = (2 * np.pi * lat) ** 2
    # each whirl pair within the eigensolve's rounding scale
    for i in (0, 2):
        assert abs(lam[i + 1] - lam[i]) / lam[i] <= 1e3 * EPS * lam_max / lam[i]
    assert lat[0] == pytest.approx(_eb_lateral_hz(1, 2.0, 0.04), rel=0.01)
    assert lat[2] == pytest.approx(_eb_lateral_hz(2, 2.0, 0.04), rel=0.01)
    assert pinned_pinned.critical_speeds_rpm == pytest.approx(60.0 * lat)


def test_torsional_and_axial_fundamentals(pinned_pinned):
    G = E / (2 * (1 + NU))
    tor = [m.frequency_hz for m in pinned_pinned.modes if m.family == "torsional"]
    ax = [m.frequency_hz for m in pinned_pinned.modes if m.family == "axial"]
    assert tor and tor[0] == pytest.approx(np.sqrt(G / RHO) / (4 * 2.0), rel=0.005)
    assert ax and ax[0] == pytest.approx(np.sqrt(E / RHO) / (4 * 2.0), rel=0.005)
    assert all(m.critical_speed_rpm is None for m in pinned_pinned.modes
               if m.family != "lateral")


def test_inputs_and_unported_outputs():
    with pytest.raises(ValueError, match="segment"):
        PtShaft([], [0.0], E=E, nu=NU, rho=RHO, device="cpu")
    with pytest.raises(ValueError, match="d_inner"):
        PtShaft([{"length": 1.0, "d": 0.02, "d_inner": 0.03}], [0.0], E=E, nu=NU, rho=RHO,
                device="cpu")
    with pytest.raises(ValueError, match="outside"):
        PtShaft([{"length": 1.0, "d": 0.02}], [0.0, 2.0], E=E, nu=NU, rho=RHO, device="cpu")
    sm = PtShaft([{"length": 1.0, "d": 0.02}], [0.0, 1.0], E=E, nu=NU, rho=RHO, n_elems=4,
                 verbose=False, device="cpu")
    for call in (sm.plot_mode, sm.generate_report):
        with pytest.raises(NotImplementedError, match="A16"):
            call()
