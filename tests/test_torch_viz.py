"""femx_torch.viz, viz_sections and viz_html against femx's: the mesh
helpers exactly, every plot method writes a PNG, and the data the HTML
viewers embed matches femx's to 1e-12 of each array's largest magnitude
(the solid case solves by dense Cholesky in both packages, whose answers
agree to roundoff)."""

import json
import re

import numpy as np
import pytest
import torch

import femx
import femx_torch
from femx.mesh.generators2d import rect_tri6 as fx_rect_tri6
from femx.viz import _surface_triangles as fx_surface
from femx.viz import _tri6_subtriangles as fx_sub6
from femx.viz_html import export_mesh_html as fx_mesh_html
from femx_torch.mesh.generators2d import rect_tri6 as pt_rect_tri6
from femx_torch.viz import _surface_triangles, _tri6_subtriangles
from femx_torch.viz_html import export_mesh_html

torch.set_num_threads(2)

_PNG = b"\x89PNG\r\n\x1a\n"
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
CORNERS = [(0, 0), (0, 0.4), (0.4, 0), (0.4, 0.4)]


def _kw(pkg):
    return {} if pkg is femx else {"device": "cpu"}


def _solid(pkg, **kw):
    mesh = pkg.box_tet10(0.4, 0.2, 0.4, 0.1, force_points=[(0.3, 0.2, 0.1)],
                         fix_points=[(x, 0, z) for x, z in CORNERS])
    fa = pkg.SolidReactionAnalysis(
        mesh, [{"force_x": 400.0, "force_y": 3000.0, "force_z": -700.0,
                "force_x_pstn": 0.3, "force_y_pstn": 0.2, "force_z_pstn": 0.1}],
        [{"pos_x": x, "pos_y": 0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
         for x, z in CORNERS], E=2e11, v=0.3, verbose=False, **kw, **_kw(pkg))
    return fa.run_simulation()


@pytest.fixture(scope="module")
def solids():
    return {pkg: _solid(pkg, solver="dense") for pkg in (femx, femx_torch)}


def test_mesh_helpers_equal_femx_exactly():
    rng = np.random.default_rng(5)
    mesh = femx_torch.box_tet10(0.3, 0.2, 0.5, 0.1)
    conn = np.asarray(mesh.cells["tetra10"])
    for c in (conn, conn[rng.permutation(len(conn))]):
        np.testing.assert_array_equal(_surface_triangles(c), fx_surface(c))
    tri = np.asarray(pt_rect_tri6(0.5, 0.2, 0.05).cells["triangle6"])
    np.testing.assert_array_equal(_tri6_subtriangles(tri), fx_sub6(tri))
    np.testing.assert_array_equal(tri, np.asarray(fx_rect_tri6(0.5, 0.2, 0.05).cells["triangle6"]))


def _png(path):
    with open(path, "rb") as f:
        head = f.read(8)
    assert head == _PNG, path
    return path


def test_every_plot_method_writes_a_png(tmp_path, solids):
    fa = solids[femx_torch]
    assert fa.plot(show_window=False, filename=_png_path(tmp_path, "solid")) is not None
    _png(tmp_path / "solid.png")
    fa.plot(show_window=False, filename=str(tmp_path / "solid_vm.png"), color="von_mises")
    _png(tmp_path / "solid_vm.png")

    pa = femx_torch.PlaneAnalysis(pt_rect_tri6(0.4, 0.1, 0.05),
                                  [{"group": "right", "force_x": 0.0, "force_y": -1000.0}],
                                  [{"group": "left", "fix_x": 0, "fix_y": 0}], E=2e11, v=0.3,
                                  thickness=0.01, verbose=False, device="cpu").run_simulation()
    for field in ("von_mises", "disp", "sxx", "syy", "sxy"):
        _png(pa.plot(str(tmp_path / f"plane_{field}.png"), field=field))

    pipe = femx_torch.PipeThermalAnalysis(0.05, 0.08, length=0.1, E=2e11, v=0.3, alpha=1.2e-5,
                                          T_inner=100.0, n_r=6, n_z=3, verbose=False,
                                          device="cpu").run_simulation()
    _png(pipe.plot(str(tmp_path / "pipe.png")))

    sm = femx_torch.ShaftModalAnalysis([{"length": 1.0, "d": 0.04}], [0.0, 1.0], E=2e11,
                                       nu=0.3, rho=7850.0, verbose=False, device="cpu")
    sm.run(n_modes=3)
    _png(sm.plot_mode(2, str(tmp_path / "shaft.png")))

    from femx_torch.viz import save_beam_modal_plot, save_beam_static_plot
    from femx_torch.viz_sections import plot_extruded_sections

    mesh = femx_torch.cantilever_line_mesh(2.0, 4)
    sections = [{"group": "beam", "type": "I section",
                 "params": {"d": 0.2, "b": 0.1, "t_w": 0.01, "t_f": 0.015, "r": 0.005},
                 "rotate": True}]
    ba = femx_torch.BeamAnalysis(
        mesh, [{"group": "beam", "type": "rectangular section", "params": {"d": 0.1, "b": 0.05}}],
        [{"group": "fix", "type": "Fix", "fix_x": True, "fix_y": True, "fix_z": True,
          "fix_rx": True, "fix_ry": True, "fix_rz": True},
         {"group": "load_y", "type": "Force", "force_x": 0.0, "force_y": -1000.0,
          "force_z": 0.0}], E=2e11, nu=0.3, rho=7850.0, device="cpu")
    res = ba.run()
    _png(save_beam_static_plot(ba, res, str(tmp_path / "beam_static.png")))
    _png(save_beam_modal_plot(ba, res, 1, str(tmp_path / "beam_mode1.png")))
    _png(plot_extruded_sections(mesh, sections, filename=str(tmp_path / "sections.png")))


def _png_path(tmp_path, name):
    return str(tmp_path / f"{name}.png")


def _payload(path):
    m = re.search(r"const D = (\{.*?\});\n", open(path).read(), re.S)
    assert m, "embedded data block not found"
    return json.loads(m.group(1))


def _assert_same_label(got, ref):
    assert _NUM.sub("#", got) == _NUM.sub("#", ref), (got, ref)
    a = np.array([float(v) for v in _NUM.findall(got)])
    b = np.array([float(v) for v in _NUM.findall(ref)])
    assert np.abs(a - b).max(initial=0.0) <= 1e-12 * max(np.abs(b).max(initial=0.0), 1.0)


def _assert_same_payload(got, ref):
    """Numbers to 1e-12 of each array's largest magnitude, the rest equal."""
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key]
        if key == "markers":
            assert len(g) == len(r)
            for mg, mr in zip(g, r):
                _assert_same_label(mg.pop("label"), mr.pop("label"))
                _assert_same_payload(mg, mr)
        elif key == "fields":
            _assert_same_payload(g, r)
        elif isinstance(r, str) or key in ("indices", "lineIndices", "legend"):
            assert g == r, key
        else:
            a, b = np.asarray(g, dtype=np.float64), np.asarray(r, dtype=np.float64)
            assert a.shape == b.shape, key
            assert np.abs(a - b).max(initial=0.0) <= 1e-12 * np.abs(b).max(initial=1.0), key


def test_export_solid_html_payload_matches_femx(tmp_path, solids):
    paths = {}
    for pkg, fa in solids.items():
        paths[pkg] = fa.export_html(str(tmp_path / f"{pkg.__name__}.html"), factor=2.5)
    got, ref = _payload(paths[femx_torch]), _payload(paths[femx])
    assert len(got["markers"]) == 5 and "von Mises (Pa)" in got["fields"]
    _assert_same_payload(got, ref)


def test_export_mesh_html_payload_matches_femx(tmp_path):
    tet = {pkg: pkg.box_tet10(0.4, 0.2, 0.4, 0.1, force_points=[(0.3, 0.2, 0.1)],
                              fix_points=[(x, 0, z) for x, z in CORNERS])
           for pkg in (femx, femx_torch)}
    frame = {pkg: pkg.cantilever_line_mesh(2.0, 5) for pkg in (femx, femx_torch)}
    for meshes in (tet, frame):
        got = _payload(export_mesh_html(meshes[femx_torch], str(tmp_path / "pt.html")))
        ref = _payload(fx_mesh_html(meshes[femx], str(tmp_path / "fx.html")))
        assert got["markers"] and got["legend"]
        _assert_same_payload(got, ref)
