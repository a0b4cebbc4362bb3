"""femx_torch.report against femx.report: the five products' reports on one
small seeded case each, in Markdown and .docx.

The two packages solve the same inputs; their reports must have the same
headings, the same table rows, and the same numbers: every number of a line
within 1e-6 of the largest magnitude on that line (the reports print 4-6
significant digits, and a reaction of roundoff size sits on a row beside
the others). The plane report's equilibrium line holds roundoff only, so its
numbers are held under 1e-9 of the load instead. Left out: the solver
section (each package's own solve_info and timings) and the beam report's
date. The .docx files (the vendored OOXML writer: python-docx is not
installed) are valid zips whose word/document.xml hold the same tables.
"""

import re
import zipfile
from xml.etree import ElementTree

import numpy as np
import pytest
import torch

import femx
import femx.report
import femx_torch
import femx_torch.report
from femx.mesh.generators2d import rect_tri6 as fx_rect_tri6
from femx_torch.mesh.generators2d import rect_tri6 as pt_rect_tri6

torch.set_num_threads(2)

_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
_EQUILIBRIUM = "Sum of applied + reaction forces"


def _report_lines(text):
    """The report's lines without the solver section and the date line."""
    out, skip = [], False
    for line in text.splitlines():
        if line.startswith("#"):
            skip = line.strip() == "## Solver"
        if skip or line.startswith("_Report generated on"):
            continue
        out.append(line)
    return out


def _assert_same_line(got, ref, load):
    """Same text between the numbers; numbers within 1e-6 of the line's
    largest magnitude (the equilibrium line: both under 1e-9 of the load)."""
    assert _NUM.sub("#", got) == _NUM.sub("#", ref), (got, ref)
    a = np.array([float(v) for v in _NUM.findall(got)])
    b = np.array([float(v) for v in _NUM.findall(ref)])
    if not len(b):
        return
    if _EQUILIBRIUM in ref:
        assert np.abs(a).max() <= 1e-9 * load and np.abs(b).max() <= 1e-9 * load, (got, ref)
        return
    tol = 1e-6 * max(np.abs(a).max(), np.abs(b).max())
    assert np.abs(a - b).max() <= tol, (got, ref)


def _assert_same_markdown(got_text, ref_text, load):
    got, ref = _report_lines(got_text), _report_lines(ref_text)
    assert [g for g in got if g.startswith("#")] == [r for r in ref if r.startswith("#")]
    assert sum(g.startswith("|") for g in got) == sum(r.startswith("|") for r in ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _assert_same_line(g, r, load)


def _docx_tables(path):
    """The tables of a .docx as lists of rows of cell texts."""
    W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        root = ElementTree.fromstring(z.read("word/document.xml"))
    return [[["".join(t.text or "" for t in tc.iter(W + "t")) for tc in tr.iter(W + "tc")]
             for tr in tbl.iter(W + "tr")] for tbl in root.iter(W + "tbl")]


def _assert_same_docx(got_path, ref_path, load):
    got, ref = _docx_tables(got_path), _docx_tables(ref_path)
    assert len(ref) >= 1 and [len(t) for t in got] == [len(t) for t in ref]
    for tg, tr in zip(got, ref):
        for rg, rr in zip(tg, tr):
            assert len(rg) == len(rr)
            _assert_same_line(" | ".join(rg), " | ".join(rr), load)


def _both(tmp_path, write, load):
    """write(pkg, path) for each package, in .md and .docx; compare."""
    paths = {}
    for name, pkg in (("fx", femx), ("pt", femx_torch)):
        d = tmp_path / name
        d.mkdir()
        for ext in ("md", "docx"):
            paths[name, ext] = str(d / f"report.{ext}")
            assert write(pkg, paths[name, ext]) in (None, paths[name, ext])
    _assert_same_markdown(open(paths["pt", "md"]).read(), open(paths["fx", "md"]).read(), load)
    _assert_same_docx(paths["pt", "docx"], paths["fx", "docx"], load)
    return open(paths["pt", "md"]).read()


def _kw(pkg):
    return {} if pkg is femx else {"device": "cpu"}


def test_solid_report_matches_femx(tmp_path):
    rng = np.random.default_rng(8)
    f = rng.uniform(-800.0, 800.0, 3)
    forces = [{"force_x": f[0], "force_y": f[1], "force_z": f[2],
               "force_x_pstn": 0.2, "force_y_pstn": 0.05, "force_z_pstn": 0.1}]
    fixes = [{"pos_x": 0.0, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for y, z in [(0, 0), (0.1, 0), (0, 0.1), (0.1, 0.1)]]
    solved = {}

    def write(pkg, path):
        if pkg not in solved:
            mesh = pkg.box_tet10(0.2, 0.1, 0.1, 0.05, force_points=[(0.2, 0.05, 0.1)],
                                 fix_points=[(0, y, z) for y, z in [(0, 0), (0.1, 0),
                                                                    (0, 0.1), (0.1, 0.1)]])
            fa = pkg.SolidReactionAnalysis(mesh, forces, fixes, E=2e11, v=0.3,
                                           verbose=False, **_kw(pkg)).run_simulation()
            fa.compute_stresses()
            solved[pkg] = fa
        solved[pkg].generate_report(path)
        return path

    text = _both(tmp_path, write, float(np.abs(f).sum()))
    assert "## Stress Results (von Mises, nodal-averaged)" in text
    assert "![results](report_iso_view.png)" in text


def test_beam_report_matches_femx(tmp_path):
    sections = [{"group": "beam", "type": "rectangular section",
                 "params": {"d": 0.1, "b": 0.05}, "rotate": False}]
    bcs = [{"group": "fix", "type": "Fix", "fix_x": True, "fix_y": True, "fix_z": True,
            "fix_rx": True, "fix_ry": True, "fix_rz": True},
           {"group": "load_y", "type": "Force", "force_x": 120.0, "force_y": -1000.0,
            "force_z": 350.0}]
    solved = {}

    def write(pkg, path):
        if pkg not in solved:
            ba = pkg.BeamAnalysis(pkg.cantilever_line_mesh(2.0, 6), sections, bcs, E=2e11,
                                  nu=0.3, rho=7850.0, **_kw(pkg))
            solved[pkg] = (ba, ba.run())
        return pkg.report.beam_report(*solved[pkg], filename=path)

    text = _both(tmp_path, write, 1000.0)
    assert "![mode5](report_mode5.png)" in text


def test_plane_report_matches_femx(tmp_path):
    forces = [{"group": "right", "force_x": 0.0, "force_y": -1000.0}]
    fixes = [{"group": "left", "fix_x": 0, "fix_y": 0}]
    solved = {}

    def write(pkg, path):
        if pkg not in solved:
            mesh = (fx_rect_tri6 if pkg is femx else pt_rect_tri6)(0.4, 0.1, 0.05)
            pa = pkg.PlaneAnalysis(mesh, forces, fixes, E=2e11, v=0.3, thickness=0.01,
                                   verbose=False, **_kw(pkg))
            pa.run_simulation()
            pa.modal(n_modes=3, rho=7850.0)
            solved[pkg] = pa
        return solved[pkg].generate_report(path)

    text = _both(tmp_path, write, 1000.0)
    assert "## Modal Analysis Results" in text and _EQUILIBRIUM in text


def test_pipe_report_matches_femx(tmp_path):
    solved = {}

    def write(pkg, path):
        if pkg not in solved:
            solved[pkg] = pkg.PipeThermalAnalysis(
                0.05, 0.08, length=0.1, E=2e11, v=0.3, alpha=1.2e-5, T_inner=150.0,
                T_outer=40.0, pressure_inner=4e6, n_r=8, n_z=4, verbose=False,
                **_kw(pkg)).run_simulation()
        return solved[pkg].generate_report(path)

    text = _both(tmp_path, write, 4e6)
    assert "| Bore (inner) |" in text


def test_shaft_report_matches_femx(tmp_path):
    solved = {}

    def write(pkg, path):
        if pkg not in solved:
            sm = pkg.ShaftModalAnalysis([{"length": 0.6, "d": 0.05},
                                         {"length": 0.4, "d": 0.04, "d_inner": 0.02}],
                                        [0.0, 1.0], E=2e11, nu=0.3, rho=7850.0, verbose=False,
                                        **_kw(pkg))
            sm.run(n_modes=6)
            solved[pkg] = sm
        return solved[pkg].generate_report(path)

    text = _both(tmp_path, write, 1.0)
    assert "- **First critical speed:**" in text


def test_report_image_failure_is_a_note(tmp_path, monkeypatch):
    """When the result image cannot be drawn the report says so and is
    written all the same (femx/report.py:43-51)."""
    import femx_torch.viz

    def broken(*a, **k):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(femx_torch.viz, "save_shaft_mode_plot", broken)
    sm = femx_torch.ShaftModalAnalysis([{"length": 1.0, "d": 0.04}], [0.0, 1.0], E=2e11,
                                       nu=0.3, rho=7850.0, verbose=False, device="cpu")
    sm.run(n_modes=2)
    text = open(femx_torch.report.shaft_report(sm, str(tmp_path / "s.md"))).read()
    assert "_Could not generate mode image: No module named 'matplotlib'_" in text
    assert "| 1 |" in text
