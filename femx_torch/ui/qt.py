"""PyQt5 GUI bindings (port of femx/ui/qt.py; optional, gated on PyQt5).

Thin widget layer over femx_torch.ui.models, replicating the reference's
window set: a launcher dialog with the 5 product options
(FEM_main.py:436-455), the Reaction Force Calculator window
(FEM_main.py:105-396) and the Beam Analysis window (BeamSolver.py:176-465).
The reference's three placeholder entries ('Shaft modal', '2D Static
Analysis', 'Pipe Thermal Stress Analysis', empty modal.ui/static.ui stubs,
FEM_main.py:412-431) open real windows here, bound to
femx_torch.analysis.{shaft,plane,pipe}. Widgets are built programmatically;
no .ui files are needed.

Without PyQt5 the module still imports, QT_AVAILABLE is False and `launch()`
raises a clear error. All state and logic live in femx_torch.ui.models
(headless-tested); this module is only widget plumbing, and its analyses
run on the CUDA card (the models' device default).
"""

from __future__ import annotations

from femx_torch.ui.models import (
    IMPLEMENTED_PRODUCTS,  # re-exported: femx_torch.ui.qt.IMPLEMENTED_PRODUCTS
    PRODUCT_OPTIONS,
    SECTION_TYPES,
    BeamAnalysisModel,
    PipeThermalModel,
    PlaneAnalysisModel,
    ReactionCalculatorModel,
    ShaftModalModel,
)

try:
    from PyQt5.QtCore import QStringListModel  # noqa: F401
    from PyQt5.QtWidgets import (  # noqa: F401
        QApplication,
        QCheckBox,
        QComboBox,
        QDialog,
        QFileDialog,
        QFormLayout,
        QHBoxLayout,
        QLabel,
        QLineEdit,
        QListView,
        QMessageBox,
        QPushButton,
        QVBoxLayout,
    )

    QT_AVAILABLE = True
except ImportError:
    QT_AVAILABLE = False


def _require_qt():
    if not QT_AVAILABLE:
        raise RuntimeError(
            "PyQt5 is not installed; use the headless CLI (`python -m femx_torch`) "
            "or the view-models in femx_torch.ui.models."
        )


if QT_AVAILABLE:

    class SelectionDialog(QDialog):
        """Product launcher (reference: SelectionDialog FEM_main.py:436-455)."""

        def __init__(self):
            super().__init__()
            self.setWindowTitle("FEM calculator")
            lay = QVBoxLayout(self)
            self.comboBox = QComboBox()
            self.comboBox.addItems(PRODUCT_OPTIONS)
            lay.addWidget(self.comboBox)
            ok = QPushButton("OK")
            ok.clicked.connect(self.on_ok_button_clicked)
            lay.addWidget(ok)
            self.selected_window = None

        def on_ok_button_clicked(self):
            choice = self.comboBox.currentText()
            windows = {
                "Reaction Force Calculator": ReactionForceCalculatorWindow,
                "Beam analysis": BeamAnalysisWindow,
                "Shaft modal": ShaftModalWindow,
                "2D Static Analysis": PlaneAnalysisWindow,
                "Pipe Thermal Stress Analysis": PipeThermalWindow,
            }
            self.selected_window = windows[choice]()
            self.accept()

    class ReactionForceCalculatorWindow(QDialog):
        def __init__(self):
            super().__init__()
            self.model = ReactionCalculatorModel()
            self.setWindowTitle("Reaction Force Calculator")
            lay = QVBoxLayout(self)

            form = QFormLayout()
            self.young_input = QLineEdit(str(self.model.youngs_modul))
            self.poisson_input = QLineEdit(str(self.model.poisson_ratio))
            form.addRow("Young's modulus E (Pa)", self.young_input)
            form.addRow("Poisson's ratio v", self.poisson_input)
            lay.addLayout(form)

            self.listView = QListView()
            self.list_model = QStringListModel()
            self.listView.setModel(self.list_model)
            lay.addWidget(self.listView)

            btns = QHBoxLayout()
            for label, slot in [
                ("System info", self._system_dialog),
                ("Add force", self._force_dialog),
                ("Add fix", self._fix_dialog),
                ("Remove", self._remove),
                ("Update mesh", self._mesh),
                ("Run", self._run),
                ("Plot", self._plot),
            ]:
                b = QPushButton(label)
                b.clicked.connect(slot)
                btns.addWidget(b)
            lay.addLayout(btns)
            self._refresh()

        def _refresh(self):
            self.list_model.setStringList(self.model.list_items())

        def _ask_floats(self, title, fields, defaults=()):
            dlg = QDialog(self)
            dlg.setWindowTitle(title)
            form = QFormLayout(dlg)
            edits = []
            for i, f in enumerate(fields):
                e = QLineEdit(str(defaults[i]) if i < len(defaults) else "")
                form.addRow(f, e)
                edits.append(e)
            ok = QPushButton("OK")
            ok.clicked.connect(dlg.accept)
            form.addRow(ok)
            if dlg.exec_() != QDialog.Accepted:
                return None
            try:
                return [float(e.text()) for e in edits]
            except ValueError:
                QMessageBox.warning(self, "Input Error", "Enter valid numbers in all fields.")
                return None

        def _system_dialog(self):
            s = self.model.system_data
            vals = self._ask_floats("System Information", ["x", "y", "z", "mesh size"],
                                    [s["x"], s["y"], s["z"], s["mesh"]])
            if vals:
                self.model.set_system(*vals)
                self._refresh()

        def _force_dialog(self):
            vals = self._ask_floats(
                "Force Information",
                ["Fx", "Fy", "Fz", "pos x", "pos y", "pos z"],
            )
            if vals:
                self.model.add_force(vals[:3], vals[3:])
                self._refresh()

        def _fix_dialog(self):
            dlg = QDialog(self)
            dlg.setWindowTitle("Fix Information")
            form = QFormLayout(dlg)
            edits = [QLineEdit() for _ in range(3)]
            for lbl, e in zip(["pos x", "pos y", "pos z"], edits):
                form.addRow(lbl, e)
            checks = [QCheckBox(a) for a in "XYZ"]
            row = QHBoxLayout()
            for c in checks:
                c.setChecked(True)
                row.addWidget(c)
            form.addRow("Fix DOFs", row)
            ok = QPushButton("OK")
            ok.clicked.connect(dlg.accept)
            form.addRow(ok)
            if dlg.exec_() == QDialog.Accepted:
                try:
                    pos = [float(e.text()) for e in edits]
                except ValueError:
                    QMessageBox.warning(self, "Input Error", "Enter valid numbers.")
                    return
                self.model.add_fix(pos, *[c.isChecked() for c in checks])
                self._refresh()

        def _remove(self):
            sel = self.listView.selectedIndexes()
            if not sel:
                QMessageBox.warning(self, "Selection Error", "Select an item to remove.")
                return
            self.model.remove_item(sel[0].row())
            self._refresh()

        def _apply_material(self) -> bool:
            try:
                self.model.youngs_modul = float(self.young_input.text())
                self.model.poisson_ratio = float(self.poisson_input.text())
                return True
            except ValueError:
                QMessageBox.warning(self, "Input Error", "Invalid material values.")
                return False

        def _mesh(self):
            if self._apply_material():
                mesh = self.model.generate_mesh()
                QMessageBox.information(
                    self, "Mesh",
                    f"Generated {mesh.num_nodes} nodes / "
                    f"{len(mesh.cells['tetra10'])} Tetra10 elements.")

        def _run(self):
            if not self._apply_material():
                return
            try:
                self.model.run_analysis()
                QMessageBox.information(self, "Success", "Analysis complete.")
            except Exception as e:
                QMessageBox.critical(self, "Analysis failed", str(e))

        def _plot(self):
            try:
                path = self.model.plot_results()
                QMessageBox.information(self, "Plot", f"Result view saved to {path}")
            except Exception as e:
                QMessageBox.critical(self, "Plot failed", str(e))

    class BeamAnalysisWindow(QDialog):
        def __init__(self):
            super().__init__()
            self.model = BeamAnalysisModel()
            self.setWindowTitle("3D Timoshenko Beam Analysis")
            lay = QVBoxLayout(self)

            form = QFormLayout()
            self.young_input = QLineEdit("2e11")
            self.poisson_input = QLineEdit("0.3")
            self.density_input = QLineEdit("7850")
            form.addRow("Young's modulus E (Pa)", self.young_input)
            form.addRow("Poisson's ratio v", self.poisson_input)
            form.addRow("Density rho (kg/m^3)", self.density_input)
            lay.addLayout(form)

            row = QHBoxLayout()
            self.physical_group_combo = QComboBox()
            self.section_type_combo = QComboBox()
            self.section_type_combo.addItems(SECTION_TYPES)
            self.bc_combo = QComboBox()
            row.addWidget(QLabel("Group"))
            row.addWidget(self.physical_group_combo)
            row.addWidget(QLabel("Section"))
            row.addWidget(self.section_type_combo)
            row.addWidget(QLabel("BC group"))
            row.addWidget(self.bc_combo)
            lay.addLayout(row)

            self.listView = QListView()
            self.list_model = QStringListModel()
            self.listView.setModel(self.list_model)
            lay.addWidget(self.listView)

            btns = QHBoxLayout()
            for label, slot in [
                ("Load mesh", self._load_mesh),
                ("Run", self._run),
            ]:
                b = QPushButton(label)
                b.clicked.connect(slot)
                btns.addWidget(b)
            lay.addLayout(btns)

        def _load_mesh(self):
            path, _ = QFileDialog.getOpenFileName(
                self, "Select Gmsh .msh file", "", "Gmsh mesh (*.msh)")
            if not path:
                return
            try:
                groups = self.model.load_mesh(path)
            except Exception as e:
                QMessageBox.critical(self, "Mesh Load Error", f"Failed to read mesh:\n{e}")
                return
            self.physical_group_combo.clear()
            self.bc_combo.clear()
            self.physical_group_combo.addItems(groups)
            self.bc_combo.addItems(groups)
            self.list_model.setStringList(self.model.list_items())

        def _run(self):
            try:
                self.model.run_simulation(
                    float(self.young_input.text()),
                    float(self.poisson_input.text()),
                    float(self.density_input.text()),
                )
                QMessageBox.information(self, "Success", "Static and Modal analyses completed.")
            except Exception as e:
                QMessageBox.critical(self, "Simulation Error", str(e))

    class _ListRunWindow(QDialog):
        """Shared plumbing for the three parameter-form product windows:
        a list view of the model's items, buttons, and a Run that swaps the
        list to the model's results text."""

        def __init__(self, title: str):
            super().__init__()
            self.setWindowTitle(title)
            self._lay = QVBoxLayout(self)
            self.listView = QListView()
            self.list_model = QStringListModel()
            self.listView.setModel(self.list_model)

        def _finish_layout(self, buttons):
            self._lay.addWidget(self.listView)
            btns = QHBoxLayout()
            for label, slot in buttons:
                b = QPushButton(label)
                b.clicked.connect(slot)
                btns.addWidget(b)
            self._lay.addLayout(btns)
            self._refresh()

        def _refresh(self):
            self.list_model.setStringList(self.model.list_items())

        def _ask_floats(self, title, fields, defaults=()):
            dlg = QDialog(self)
            dlg.setWindowTitle(title)
            form = QFormLayout(dlg)
            edits = []
            for i, f in enumerate(fields):
                e = QLineEdit(str(defaults[i]) if i < len(defaults) else "")
                form.addRow(f, e)
                edits.append(e)
            ok = QPushButton("OK")
            ok.clicked.connect(dlg.accept)
            form.addRow(ok)
            if dlg.exec_() != QDialog.Accepted:
                return None
            try:
                return [float(e.text()) for e in edits]
            except ValueError:
                QMessageBox.warning(self, "Input Error",
                                    "Enter valid numbers in all fields.")
                return None

        def _remove(self):
            sel = self.listView.selectedIndexes()
            if not sel:
                QMessageBox.warning(self, "Selection Error",
                                    "Select an item to remove.")
                return
            self.model.remove_item(sel[0].row())
            self._refresh()

        def _run(self):
            try:
                self.model.run_analysis()
                if hasattr(self.model, "results_text"):
                    self.list_model.setStringList(self.model.results_text())
                QMessageBox.information(self, "Success", "Analysis complete.")
            except Exception as e:
                QMessageBox.critical(self, "Analysis failed", str(e))

    class ShaftModalWindow(_ListRunWindow):
        def __init__(self):
            super().__init__("Shaft Modal Analysis")
            self.model = ShaftModalModel()
            form = QFormLayout()
            self.young_input = QLineEdit(str(self.model.E))
            self.poisson_input = QLineEdit(str(self.model.nu))
            self.density_input = QLineEdit(str(self.model.rho))
            form.addRow("Young's modulus E (Pa)", self.young_input)
            form.addRow("Poisson's ratio v", self.poisson_input)
            form.addRow("Density rho (kg/m^3)", self.density_input)
            self._lay.addLayout(form)
            self._finish_layout([
                ("Add segment", self._segment_dialog),
                ("Add bearing", self._bearing_dialog),
                ("Remove", self._remove),
                ("Run", self._run),
            ])

        def _segment_dialog(self):
            vals = self._ask_floats(
                "Shaft segment",
                ["length (m)", "outer diameter d (m)",
                 "inner diameter (0 = solid)"], [1.0, 0.04, 0.0])
            if vals:
                self.model.add_segment(*vals)
                self._refresh()

        def _bearing_dialog(self):
            vals = self._ask_floats("Bearing", ["axial position x (m)"])
            if vals:
                self.model.add_bearing(vals[0])
                self._refresh()

        def _run(self):
            try:
                self.model.E = float(self.young_input.text())
                self.model.nu = float(self.poisson_input.text())
                self.model.rho = float(self.density_input.text())
            except ValueError:
                QMessageBox.warning(self, "Input Error", "Invalid material values.")
                return
            super()._run()

    class PlaneAnalysisWindow(_ListRunWindow):
        def __init__(self):
            super().__init__("2D Static Analysis")
            self.model = PlaneAnalysisModel()
            form = QFormLayout()
            self.young_input = QLineEdit(str(self.model.E))
            self.poisson_input = QLineEdit(str(self.model.nu))
            self.thickness_input = QLineEdit(str(self.model.thickness))
            self.mode_combo = QComboBox()
            self.mode_combo.addItems(["stress", "strain"])
            form.addRow("Young's modulus E (Pa)", self.young_input)
            form.addRow("Poisson's ratio v", self.poisson_input)
            form.addRow("Thickness t (m)", self.thickness_input)
            form.addRow("Plane mode", self.mode_combo)
            self._lay.addLayout(form)
            self.edge_combo = QComboBox()
            self.edge_combo.addItems(["left", "right", "bottom", "top"])
            row = QHBoxLayout()
            row.addWidget(QLabel("Edge group"))
            row.addWidget(self.edge_combo)
            self._lay.addLayout(row)
            self._finish_layout([
                ("Plate size", self._system_dialog),
                ("Add edge force", self._force_dialog),
                ("Add edge fix", self._fix_dialog),
                ("Remove", self._remove),
                ("Run", self._run),
            ])

        def _system_dialog(self):
            s = self.model.system_data
            vals = self._ask_floats("Plate", ["width", "height", "mesh size"],
                                    [s["w"], s["h"], s["mesh"]])
            if vals:
                self.model.set_system(*vals)
                self._refresh()

        def _force_dialog(self):
            vals = self._ask_floats("Edge force (total resultant)",
                                    ["Fx (N)", "Fy (N)"])
            if vals:
                self.model.add_force(vals, group=self.edge_combo.currentText())
                self._refresh()

        def _fix_dialog(self):
            dlg = QDialog(self)
            dlg.setWindowTitle("Edge fix")
            form = QFormLayout(dlg)
            checks = [QCheckBox(a) for a in "XY"]
            row = QHBoxLayout()
            for c in checks:
                c.setChecked(True)
                row.addWidget(c)
            form.addRow("Fix DOFs", row)
            ok = QPushButton("OK")
            ok.clicked.connect(dlg.accept)
            form.addRow(ok)
            if dlg.exec_() == QDialog.Accepted:
                self.model.add_fix(*[c.isChecked() for c in checks],
                                   group=self.edge_combo.currentText())
                self._refresh()

        def _run(self):
            try:
                self.model.E = float(self.young_input.text())
                self.model.nu = float(self.poisson_input.text())
                self.model.thickness = float(self.thickness_input.text())
            except ValueError:
                QMessageBox.warning(self, "Input Error", "Invalid material values.")
                return
            self.model.mode = self.mode_combo.currentText()
            try:
                a = self.model.run_analysis()
                vm = float(a.von_mises.max())
                QMessageBox.information(
                    self, "Success",
                    f"Analysis complete. Max von Mises: {vm:.4e} Pa.")
            except Exception as e:
                QMessageBox.critical(self, "Analysis failed", str(e))

    class PipeThermalWindow(_ListRunWindow):
        def __init__(self):
            super().__init__("Pipe Thermal Stress Analysis")
            self.model = PipeThermalModel()
            form = QFormLayout()
            self._edits = {}
            for key, label in [
                ("r_inner", "Inner radius (m)"), ("r_outer", "Outer radius (m)"),
                ("length", "Length (m)"), ("E", "Young's modulus E (Pa)"),
                ("v", "Poisson's ratio v"),
                ("alpha", "Thermal expansion alpha (1/K)"),
                ("T_inner", "Inner wall dT (K)"), ("T_outer", "Outer wall dT (K)"),
                ("pressure_inner", "Inner pressure (Pa)"),
                ("pressure_outer", "Outer pressure (Pa)"),
            ]:
                e = QLineEdit(str(self.model.params[key]))
                form.addRow(label, e)
                self._edits[key] = e
            self.end_combo = QComboBox()
            self.end_combo.addItems(["plane_strain", "free"])
            form.addRow("End condition", self.end_combo)
            self._lay.addLayout(form)
            self._finish_layout([("Run", self._run)])

        def _run(self):
            try:
                for key, e in self._edits.items():
                    self.model.params[key] = float(e.text())
            except ValueError:
                QMessageBox.warning(self, "Input Error", "Invalid parameter values.")
                return
            self.model.end_condition = self.end_combo.currentText()
            super()._run()


def launch(argv=None) -> int:
    """Start the Qt application: launcher dialog -> selected product window."""
    _require_qt()
    import sys

    app = QApplication(argv or sys.argv)
    dlg = SelectionDialog()
    if dlg.exec_() == QDialog.Accepted and dlg.selected_window is not None:
        dlg.selected_window.show()
        return app.exec_()
    return 0
