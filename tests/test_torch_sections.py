"""femx_torch.sections against femx.sections on the same inputs (CPU, f64):
the parametric geometry of the seven section types, polygon moments and
extreme fibres (1e-13), the closed-form J/kappa, the 8-tuple contract
(rotate, zeros on failure), and the warping FEM's J/kappa for the I, C, L
and hollow-box sections (1e-8), whose Laplacian runs through the port's
take_rows and pcg."""

import numpy as np
import pytest
import torch

import femx.sections as fx
import femx.sections.geometry as fx_geom
import femx.sections.warping as fx_warp
import femx_torch.sections as pt
import femx_torch.sections.geometry as pt_geom
import femx_torch.sections.properties as pt_props
import femx_torch.sections.warping as pt_warp

torch.set_num_threads(2)

TYPES = [
    ("I section", {"d": 0.05, "b": 0.025, "t_w": 0.005, "t_f": 0.005, "r": 0.001}),
    ("C section", {"d": 0.05, "b": 0.025, "t_f": 0.005, "t_w": 0.005, "r": 0.001}),
    ("L section", {"d": 0.06, "b": 0.04, "t": 0.006, "r_r": 0.004, "r_t": 0.002}),
    ("hollow box section", {"d": 0.08, "b": 0.05, "t": 0.005, "r_out": 0.006}),
    ("rectangular section", {"d": 0.06, "b": 0.02}),
    ("circular section", {"d": 0.04}),
    ("hollow circular section", {"d": 0.05, "t": 0.004}),
]
IDS = [t for t, _ in TYPES]


@pytest.mark.parametrize("st,params", TYPES, ids=IDS)
def test_geometry_moments_and_fibres_match_femx(st, params):
    gt, gf = pt_geom.build_geometry(st, params), fx_geom.build_geometry(st, params)
    np.testing.assert_array_equal(gt.outer, gf.outer)
    assert len(gt.holes) == len(gf.holes)
    for a, b in zip(gt.holes, gf.holes):
        np.testing.assert_array_equal(a, b)
    mt, mf = pt.polygon_moments(gt), fx.polygon_moments(gf)
    np.testing.assert_allclose(mt, mf, rtol=1e-13, atol=1e-13 * max(map(abs, mf)))
    np.testing.assert_allclose(pt_props.extreme_fibers(gt, *mt[1:3]),
                               fx.properties.extreme_fibers(gf, *mf[1:3]), rtol=1e-13)


@pytest.mark.parametrize("st,params", TYPES, ids=IDS)
@pytest.mark.parametrize("rotate", [False, True])
def test_closed_form_properties_match_femx(st, params, rotate):
    got = pt.compute_properties(st, params, rotate=rotate, method="closed_form", device="cpu")
    want = fx.compute_properties(st, params, rotate=rotate, method="closed_form")
    np.testing.assert_allclose(got.as_tuple(), want.as_tuple(), rtol=1e-13)
    assert type(got).__name__ == "SectionProperties" and got._fields == want._fields


def test_contract_helpers_match_femx():
    assert pt.torsion_rectangle(0.06, 0.02) == pytest.approx(
        fx.torsion_rectangle(0.06, 0.02), rel=1e-14)
    # the reference's forgiving contract: zeros (and a message) on failure
    assert pt.calculate_section_properties("Z section", {"d": 1.0}, device="cpu") == (0.0,) * 8
    got = pt.calculate_section_properties("circular section", {"d": 0.04, "rotate": True},
                                          device="cpu")
    np.testing.assert_allclose(got, fx.calculate_section_properties(
        "circular section", {"d": 0.04, "rotate": True}), rtol=1e-13)
    with pytest.raises(ValueError, match="Unknown section type"):
        pt_geom.build_geometry("Z section", {})


WARPING = [TYPES[0], TYPES[1], TYPES[2], TYPES[3]]


@pytest.mark.parametrize("st,params", WARPING, ids=IDS[:4])
def test_warping_constants_match_femx(st, params):
    """J and the two kappa of the warping FEM with Richardson extrapolation,
    at a coarse mesh (the reference's t/10 rule costs minutes on a CPU)."""
    h = min(v for k, v in params.items() if k.startswith("t")) / 2.5
    geom = pt_geom.build_geometry(st, params)
    got = pt_warp.warping_constants(geom, nu=0.3, mesh_size=h, device="cpu")
    want = fx_warp.warping_constants(fx_geom.build_geometry(st, params), nu=0.3, mesh_size=h)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    nodes, cells = pt_warp.triangulate(geom, h)
    want_nodes, want_cells = fx_warp.triangulate(fx_geom.build_geometry(st, params), h)
    np.testing.assert_array_equal(nodes, want_nodes)
    np.testing.assert_array_equal(cells, want_cells)


def test_fem_cache_keys_on_device_and_dtype(monkeypatch):
    """compute_properties(method='fem') caches per (type, params, nu,
    device, dtype): a float32 request is solved anew, a repeat is not."""
    calls = []

    def fake(geom, nu, mesh_size, device, dtype):
        calls.append((device, dtype))
        return 1e-9, 0.5, 0.4

    monkeypatch.setattr(pt_warp, "warping_constants", fake)
    pt_props._fem_jk_cached.cache_clear()
    st, params = TYPES[0]
    for dtype in (torch.float64, torch.float64, torch.float32):
        p = pt.compute_properties(st, params, method="fem", device="cpu", dtype=dtype)
        assert (p.J, p.kappa_y, p.kappa_z) == (1e-9, 0.5, 0.4)
    pt_props._fem_jk_cached.cache_clear()
    assert calls == [(torch.device("cpu"), torch.float64), (torch.device("cpu"), torch.float32)]
