"""femx_torch.ui (the headless view-models and the PyQt5 widget layer)
against femx.ui, driven as tests/test_ui_models.py and tests/test_qt_stub.py
drive femx's: the same list strings, CRUD semantics and pre-seeded cases;
results within 1e-9 relative of femx's (displacements and stresses to 1e-9
of their largest magnitude, frequencies to 1e-9 each). Every run passes
device="cpu"; the default (None) means the CUDA card and raises here.

The Qt layer runs under femx's PyQt5 stub, loaded from tests/test_qt_stub.py
by path; the fixture restores sys.modules (no PyQt5) and reloads the gated
module afterwards, so later tests on the worker see no Qt.
"""

import functools
import importlib
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import femx
import femx.ui.models as fx_models
import femx_torch
import femx_torch.ui.models as pt_models

torch.set_num_threads(2)

_STUB_PATH = Path(__file__).with_name("test_qt_stub.py")


def _close(a, b, rtol=1e-9):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= rtol * np.abs(b).max(initial=0.0)


def test_constants_match_femx():
    for name in ("PRODUCT_OPTIONS", "IMPLEMENTED_PRODUCTS", "SECTION_TYPES"):
        assert getattr(pt_models, name) == getattr(fx_models, name), name
    import femx_torch.ui

    assert femx_torch.ui.__all__ == __import__("femx.ui", fromlist=["x"]).__all__


def test_reaction_model_defaults_and_crud_match_femx():
    """Pre-seeded 0.8 x 0.2 x 0.8 case (FEM_main.py:115-130), list strings,
    add/remove semantics."""
    fx, pt = fx_models.ReactionCalculatorModel(), pt_models.ReactionCalculatorModel()
    assert pt.system_data == fx.system_data == {"x": 0.8, "y": 0.2, "z": 0.8, "mesh": 0.05}
    assert pt.list_items() == fx.list_items()
    assert pt.list_items()[0] == "System Size: (0.8, 0.2, 0.8), Mesh Size: 0.05"
    for m in (fx, pt):
        m.set_system(0.4, 0.2, 0.4, 0.2)
        m.add_force((1.0, 2.0, 3.0), (0.1, 0.2, 0.3))
        m.add_fix((0.5, 0.0, 0.5), True, False, True)
        assert m.remove_item(2) and not m.remove_item(0) and not m.remove_item(99)
    assert pt.list_items() == fx.list_items()
    assert pt.fix_data_list == fx.fix_data_list and pt.force_data_list == fx.force_data_list


def _small_reaction_case(m, tmp_path, name):
    m.system_data = {"x": 0.4, "y": 0.2, "z": 0.4, "mesh": 0.2}
    m.force_data_list = [{"force_x": 0.0, "force_y": 3000.0, "force_z": 0.0,
                          "force_x_pstn": 0.2, "force_y_pstn": 0.2, "force_z_pstn": 0.2}]
    m.fix_data_list = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0,
                        "fix_z": 0} for x, z in [(0, 0), (0, 0.4), (0.4, 0), (0.4, 0.4)]]
    m.mesh_file = str(tmp_path / f"{name}.msh")


def test_reaction_model_end_to_end_matches_femx(tmp_path):
    fx, pt = fx_models.ReactionCalculatorModel(), pt_models.ReactionCalculatorModel()
    _small_reaction_case(fx, tmp_path, "fx")
    _small_reaction_case(pt, tmp_path, "pt")
    for m in (fx, pt):
        m.generate_mesh()
    assert (tmp_path / "pt.msh").read_bytes() == (tmp_path / "fx.msh").read_bytes()
    with pytest.raises(RuntimeError, match="Run the analysis first"):
        pt.plot_results(filename=str(tmp_path / "none.png"))
    a = fx.run_analysis(verbose=False)
    b = pt.run_analysis(verbose=False, device="cpu")
    assert b.device == torch.device("cpu")
    _close(b.u, a.u)
    _close(b.reaction_forces, a.reaction_forces)
    assert np.abs(b.equilibrium_residual()).max() < 1e-7
    assert pt.plot_results(filename=str(tmp_path / "result.png")) == str(tmp_path / "result.png")
    assert (tmp_path / "result.png").stat().st_size > 0
    html = pt.preview_mesh(str(tmp_path / "preview.html"))
    assert html.endswith("preview.html") and "femx mesh preview" in open(html).read()


def test_reaction_model_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    m = pt_models.ReactionCalculatorModel()
    _small_reaction_case(m, tmp_path, "m")
    m.generate_mesh(write=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.run_analysis(verbose=False)


def _beam_inputs(m, mesh):
    groups = m.load_mesh(mesh)
    assert set(groups) == {"fix", "load_y", "beam"}
    assert m.assign_section("beam", "rectangular section", {"d": 0.1, "b": 0.05})
    assert m.assign_bc("fix", {"type": "Fix", "fix_x": True, "fix_y": True, "fix_z": True,
                               "fix_rx": True, "fix_ry": True, "fix_rz": True})
    assert m.assign_bc("load_y", {"type": "Force", "force_x": 0.0, "force_y": -1000.0,
                                  "force_z": 0.0})


def test_beam_model_end_to_end_matches_femx(tmp_path):
    """femx's test_beam_model_end_to_end on an in-memory cantilever (the
    reference asset it reads is not in the repo)."""
    fx, pt = fx_models.BeamAnalysisModel(), pt_models.BeamAnalysisModel()
    _beam_inputs(fx, femx.cantilever_line_mesh(2.0, 2))
    _beam_inputs(pt, femx_torch.cantilever_line_mesh(2.0, 2))
    assert pt.list_items() == fx.list_items()
    assert "[BC] load_y: Force F=(0.0, -1000.0, 0.0)" in pt.list_items()
    a = fx.run_simulation(E=2e11, nu=0.3, rho=7850)
    b = pt.run_simulation(E=2e11, nu=0.3, rho=7850, device="cpu")
    iyy = 0.1 * 0.05 ** 3 / 12
    G = 2e11 / 2.6
    analytic = -1000.0 * 8 / (3 * 2e11 * iyy) + -1000.0 * 2 / ((10 / 12) * 0.005 * G)
    assert b.u[6 * 1 + 1] == pytest.approx(analytic, rel=1e-9)
    _close(b.u, a.u)
    _close(b.smoothed_stresses, a.smoothed_stresses)
    np.testing.assert_allclose(b.natural_frequencies, a.natural_frequencies, rtol=1e-9)
    # overwrite semantics and edits, as femx's
    for m in (fx, pt):
        assert m.assign_section("beam", "circular section", {"d": 0.1})
        assert not m.assign_section("beam", "circular section", {"d": 0.2}, overwrite=False)
        assert m.edit_item(0, new_params={"d": 0.12, "rotate": True})
        assert m.edit_item(1, new_bc={"group": "IGNORED", "type": "Fix", "fix_x": True})
        assert not m.edit_item(7, new_params={})
    assert pt.section_data == fx.section_data and pt.bc_data == fx.bc_data
    assert pt.list_items() == fx.list_items()
    # report, plots and the section preview; the last section assignment
    # changed, so the report is written from the results of the run above
    assert pt.create_report(str(tmp_path / "beam_report.md")).endswith(".md")
    pt.plot_static(str(tmp_path / "static.png"))
    pt.plot_modal(1, str(tmp_path / "mode1.png"))
    pt.preview_sections(str(tmp_path / "sections.png"))
    for f in ("beam_report.md", "static.png", "mode1.png", "sections.png"):
        assert (tmp_path / f).stat().st_size > 0
    with pytest.raises(ValueError, match="line"):
        pt_models.BeamAnalysisModel().load_mesh(femx_torch.box_tet10(0.2, 0.2, 0.2, 0.2))
    with pytest.raises(RuntimeError, match="load a mesh"):
        pt_models.BeamAnalysisModel().run_simulation(2e11, 0.3, device="cpu")


def test_shaft_model_matches_femx():
    fx, pt = fx_models.ShaftModalModel(), pt_models.ShaftModalModel()
    for m in (fx, pt):
        m.add_segment(0.5, 0.06, d_inner=0.03)
        m.add_bearing(2.5)
        assert len(m.list_items()) == 5
        assert m.remove_item(3)  # the bearing at x = 2
        m.n_modes = 6
    assert pt.list_items() == fx.list_items()
    a = fx.run_analysis(verbose=False)
    b = pt.run_analysis(verbose=False, device="cpu")
    np.testing.assert_allclose([m.frequency_hz for m in b], [m.frequency_hz for m in a],
                               rtol=1e-9)
    assert [m.family for m in b] == [m.family for m in a]
    assert len(pt.results_text()) == 6 and "critical speed" in pt.results_text()[0]
    assert pt.results_text() == fx.results_text()


def test_plane_model_matches_femx():
    fx, pt = fx_models.PlaneAnalysisModel(), pt_models.PlaneAnalysisModel()
    assert pt.list_items() == fx.list_items()
    for m in (fx, pt):
        m.set_system(0.4, 0.2, 0.05)
        m.add_force((100.0, 0.0), pos_xy=(0.4, 0.1))
        m.add_fix(True, False, group="bottom")
        assert len(m.list_items()) == 5 and not m.remove_item(0)
    assert pt.list_items() == fx.list_items()
    for m in (fx, pt):
        assert m.remove_item(2)  # the point force
        assert m.remove_item(3)  # the bottom fix
    a = fx.run_analysis(verbose=False)
    b = pt.run_analysis(verbose=False, device="cpu")
    assert b.solve_info["method"] == a.solve_info["method"] == "dense_cholesky"
    _close(b.u, a.u)
    _close(b.von_mises, a.von_mises)
    assert np.abs(b.equilibrium_residual()).max() < 1e-6


def test_pipe_model_matches_femx():
    fx, pt = fx_models.PipeThermalModel(), pt_models.PipeThermalModel()
    assert pt.list_items() == fx.list_items() and len(pt.list_items()) == 4
    for m in (fx, pt):
        m.n_r, m.n_z = 8, 4
    a = fx.run_analysis(verbose=False)
    b = pt.run_analysis(verbose=False, device="cpu")
    _close(b.u, a.u)
    _close(b.von_mises, a.von_mises)
    for tg, tr in zip(pt.results_text(), fx.results_text()):
        assert tg.split("=")[0] == tr.split("=")[0]
        assert float(tg.split("=")[1].split()[0]) == pytest.approx(
            float(tr.split("=")[1].split()[0]), rel=1e-4)  # printed to 5 digits


# ---------------------------------------------------------------------------
# The Qt layer under femx's PyQt5 stub
# ---------------------------------------------------------------------------
def _load_stub():
    spec = importlib.util.spec_from_file_location("_femx_qt_stub", _STUB_PATH)
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    return stub


@pytest.fixture()
def qt(monkeypatch):
    """Install femx's stub as PyQt5, reload femx_torch.ui.qt against it, and
    restore sys.modules and the gated module afterwards."""
    stub = _load_stub()
    widgets = types.ModuleType("PyQt5.QtWidgets")
    for name in ("QApplication", "QCheckBox", "QComboBox", "QDialog", "QDoubleSpinBox",
                 "QFileDialog", "QLabel", "QLineEdit", "QListView", "QMessageBox",
                 "QPushButton", "QWidget"):
        setattr(widgets, name, getattr(stub, name))
    widgets.QFormLayout = widgets.QHBoxLayout = widgets.QVBoxLayout = stub._Layout
    qtcore = types.ModuleType("PyQt5.QtCore")
    qtcore.QStringListModel = stub.QStringListModel
    pyqt5 = types.ModuleType("PyQt5")
    pyqt5.QtWidgets, pyqt5.QtCore = widgets, qtcore
    monkeypatch.setitem(sys.modules, "PyQt5", pyqt5)
    monkeypatch.setitem(sys.modules, "PyQt5.QtWidgets", widgets)
    monkeypatch.setitem(sys.modules, "PyQt5.QtCore", qtcore)
    import femx_torch.ui.qt as qt_mod

    qt_mod = importlib.reload(qt_mod)
    assert qt_mod.QT_AVAILABLE
    stub.QMessageBox.calls = []
    try:
        yield qt_mod
    finally:
        for name in ("PyQt5", "PyQt5.QtWidgets", "PyQt5.QtCore"):
            monkeypatch.delitem(sys.modules, name, raising=False)
        importlib.reload(qt_mod)
    assert "PyQt5" not in sys.modules and not qt_mod.QT_AVAILABLE


def _on_cpu(model, method):
    """The window's model, run on the CPU (the windows call the models with
    their default device, the card)."""
    setattr(model, method, functools.partial(getattr(model, method), device="cpu"))


def test_qt_windows_under_the_stub(qt, tmp_path):
    # the launcher opens a real window with a bound view-model for all five
    assert qt.IMPLEMENTED_PRODUCTS == qt.PRODUCT_OPTIONS
    for i, name in enumerate(qt.PRODUCT_OPTIONS):
        dlg = qt.SelectionDialog()
        dlg.comboBox.setCurrentIndex(i)
        dlg.on_ok_button_clicked()
        assert hasattr(dlg.selected_window, "model"), name

    win = qt.ReactionForceCalculatorWindow()
    assert any("System" in s for s in win.list_model.strings)
    win.model.set_system(0.2, 0.1, 0.2, 0.1)
    win.model.mesh_file = str(tmp_path / "win.msh")
    win._system_dialog()
    win._mesh()
    assert qt.QMessageBox.calls[-1][0] == "information"
    if not torch.cuda.is_available():
        win._run()  # the default device is the card: a handled error, no fallback
        assert qt.QMessageBox.calls[-1][0] == "critical" and "CUDA" in qt.QMessageBox.calls[-1][1][1]
    _on_cpu(win.model, "run_analysis")
    win._run()
    assert qt.QMessageBox.calls[-1] == ("information", ("Success", "Analysis complete."))
    assert np.abs(win.model.analysis_instance.equilibrium_residual()).max() < 1e-6
    win._remove()
    assert qt.QMessageBox.calls[-1][0] == "warning"
    n_before = len(win.model.list_items())
    win.listView.select_row(1)
    win._remove()
    assert len(win.model.list_items()) == n_before - 1
    win.young_input.setText("not-a-number")
    assert not win._apply_material() and qt.QMessageBox.calls[-1][0] == "warning"

    beam = qt.BeamAnalysisWindow()
    path = tmp_path / "cantilever.msh"
    femx_torch.write_msh(str(path), femx_torch.cantilever_line_mesh(2.0, 2))
    qt.QFileDialog.next_path = str(path)
    beam._load_mesh()
    assert "beam" in beam.physical_group_combo._items
    _on_cpu(beam.model, "run_simulation")
    beam._run()  # no section assigned: a handled error
    assert qt.QMessageBox.calls[-1][0] == "critical"
    _beam_inputs(beam.model, str(path))
    beam._run()
    assert qt.QMessageBox.calls[-1] == ("information", ("Success", "Static and Modal analyses completed."))
    assert np.all(np.isfinite(beam.model.results.u))

    shaft = qt.ShaftModalWindow()
    shaft._segment_dialog()
    assert len(shaft.model.segments) == 2
    shaft.listView.select_row(1)
    shaft._remove()
    shaft.model.n_modes = 4
    _on_cpu(shaft.model, "run_analysis")
    shaft._run()
    assert qt.QMessageBox.calls[-1] == ("information", ("Success", "Analysis complete."))
    assert any("critical speed" in s for s in shaft.list_model.strings)
    shaft.young_input.setText("nope")
    shaft._run()
    assert qt.QMessageBox.calls[-1][0] == "warning"

    plane = qt.PlaneAnalysisWindow()
    plane.model.set_system(0.4, 0.2, 0.05)
    plane._system_dialog()
    plane._force_dialog()  # empty fields: a warning, no state change
    assert qt.QMessageBox.calls[-1][0] == "warning"
    plane._fix_dialog()
    assert len(plane.model.fix_data_list) == 2
    _on_cpu(plane.model, "run_analysis")
    plane._run()
    assert qt.QMessageBox.calls[-1][0] == "information" and "von Mises" in qt.QMessageBox.calls[-1][1][1]

    pipe = qt.PipeThermalWindow()
    pipe.model.n_r, pipe.model.n_z = 8, 4
    _on_cpu(pipe.model, "run_analysis")
    pipe._run()
    assert qt.QMessageBox.calls[-1] == ("information", ("Success", "Analysis complete."))
    assert any("von Mises" in s for s in pipe.list_model.strings)
    pipe._edits["r_inner"].setText("bad")
    pipe._run()
    assert qt.QMessageBox.calls[-1][0] == "warning"


def test_qt_gated_cleanly_without_pyqt5():
    from femx_torch.ui import qt

    assert qt.QT_AVAILABLE is False and "PyQt5" not in sys.modules
    with pytest.raises(RuntimeError, match="PyQt5 is not installed"):
        qt.launch([])
