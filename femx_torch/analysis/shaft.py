"""Shaft modal / critical-speed analysis (port of femx/analysis/shaft.py).

The reference lists "Shaft modal" in its launcher but loads an empty
placeholder dialog (FEM_main.py:412-431, modal.ui); femx implements the
product on its Timoshenko beam machinery, and so does the port, on
femx_torch.analysis.beam: a stepped circular shaft on bearings, solved as a
3D frame modal problem on `device` (None = CUDA), the modes classified into
lateral (whirl) / torsional / axial families and the lateral frequencies
reported as critical speeds in RPM (N_c = 60 f for a non-gyroscopic model).

Model:
  - the shaft axis lies along +x; segments are (length, d_outer[, d_inner])
    steps meshed with 2-node Timoshenko elements ("circular section" /
    "hollow circular section" properties);
  - bearings are ideal pinned supports at given axial positions (u_y, u_z
    fixed, rotations free), inserted as mesh breakpoints;
  - one thrust bearing (by default the first) also fixes u_x and, unless
    ``free_torsion=True``, r_x. With ``free_torsion=True`` the rigid
    torsional mode is filtered by the modal solver's lambda > tol cutoff
    (BeamSolver.py:449-455).

Gyroscopic effects are out of scope, as in femx: this is the
stationary-shaft modal spectrum. The whirl pairs of a circular shaft are
degenerate in exact arithmetic; a dense eigensolve splits them by its
rounding, about eps * lambda_max / lambda relative (tests/test_torch_shaft.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from femx_torch.analysis.beam import BeamAnalysis
from femx_torch.config import resolve_device
from femx_torch.mesh.generators import FrameBuilder


@dataclass
class ShaftMode:
    frequency_hz: float
    family: str  # 'lateral' | 'torsional' | 'axial'
    critical_speed_rpm: Optional[float]  # lateral modes only
    shape: np.ndarray  # (6N,) full-DOF mode vector


class ShaftModalAnalysis:
    """Critical speeds of a stepped circular shaft on pinned bearings."""

    def __init__(
        self,
        segments: Sequence[dict],
        bearings: Sequence[float],
        E: float,
        nu: float,
        rho: float,
        target_elem_length: Optional[float] = None,
        n_elems: int = 40,
        thrust_bearing: int = 0,
        free_torsion: bool = False,
        mass: str = "consistent",
        verbose: bool = True,
        device=None,
    ):
        """Args:
          segments: [{'length', 'd'[, 'd_inner']}] axial steps, in order
            from x = 0. 'd_inner' > 0 makes the segment hollow.
          bearings: axial positions of the pinned supports (>= 2 recommended;
            at least 1 required). Must lie within [0, total_length].
          E, nu, rho: material (Pa, -, kg/m^3).
          target_elem_length: mesh size; default total_length / n_elems.
          thrust_bearing: index into `bearings` of the axially-fixing one.
          free_torsion: keep r_x unconstrained (free-free torsional branch).
          mass: 'consistent' (default — modal accuracy) or 'lumped'
            (the reference beam path's default, BeamSolver.py:398-418).
          device: where the analysis runs (None = CUDA).
        """
        self.device = resolve_device(device)
        if not segments:
            raise ValueError("need at least one shaft segment")
        if not bearings:
            raise ValueError("need at least one bearing")
        self.segments = [dict(s) for s in segments]
        for s in self.segments:
            if s["length"] <= 0 or s["d"] <= 0:
                raise ValueError(f"bad segment {s!r}: need length > 0, d > 0")
            if s.get("d_inner", 0.0) >= s["d"]:
                raise ValueError(f"bad segment {s!r}: d_inner >= d")
        self.total_length = float(sum(s["length"] for s in self.segments))
        self.bearings = sorted(float(b) for b in bearings)
        eps = 1e-9 * max(self.total_length, 1.0)
        if self.bearings[0] < -eps or self.bearings[-1] > self.total_length + eps:
            raise ValueError(
                f"bearing positions {self.bearings} outside the shaft "
                f"[0, {self.total_length}]")
        if not 0 <= thrust_bearing < len(self.bearings):
            raise ValueError("thrust_bearing index out of range")
        self.E, self.nu, self.rho = float(E), float(nu), float(rho)
        self.h = float(target_elem_length or self.total_length / n_elems)
        self.thrust_bearing = int(thrust_bearing)
        self.free_torsion = bool(free_torsion)
        self.mass = mass
        self.verbose = verbose
        self.modes: List[ShaftMode] = []
        self.analysis: Optional[BeamAnalysis] = None

        self._build_mesh()

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def _build_mesh(self) -> None:
        """Line mesh along +x with nodes at every segment boundary and
        bearing position; elements tagged by segment group."""
        seg_ends = np.cumsum([s["length"] for s in self.segments])
        breaks = np.unique(np.concatenate(
            [[0.0], seg_ends, np.asarray(self.bearings)]))
        fb = FrameBuilder()
        node_of = {float(x): fb.add_node((float(x), 0.0, 0.0)) for x in breaks}
        for a, b in zip(breaks[:-1], breaks[1:]):
            mid = 0.5 * (a + b)
            seg = int(np.searchsorted(seg_ends, mid))
            n = max(1, int(round((b - a) / self.h)))
            fb.add_member(node_of[float(a)], node_of[float(b)],
                          f"seg{seg}", n_elems=n)
        for i, x in enumerate(self.bearings):
            # snap to the nearest breakpoint (within eps they are identical)
            key = float(breaks[np.argmin(np.abs(breaks - x))])
            fb.add_vertex_group(f"bearing{i}", [node_of[key]])
        self.mesh = fb.build()
        self._log(f"1. Shaft mesh: {len(self.mesh.points)} nodes, "
                  f"{len(self.mesh.cells['line'])} Timoshenko elements, "
                  f"{len(self.segments)} segment(s), "
                  f"{len(self.bearings)} bearing(s).")

    def _section_data(self) -> List[dict]:
        out = []
        for i, s in enumerate(self.segments):
            di = float(s.get("d_inner", 0.0))
            if di > 0.0:
                out.append({"group": f"seg{i}",
                            "type": "hollow circular section",
                            "params": {"d": s["d"],
                                       "t": 0.5 * (s["d"] - di)}})
            else:
                out.append({"group": f"seg{i}", "type": "circular section",
                            "params": {"d": s["d"]}})
        return out

    def _bc_data(self) -> List[dict]:
        out = []
        for i in range(len(self.bearings)):
            thrust = (i == self.thrust_bearing)
            out.append({
                "group": f"bearing{i}", "type": "Fix",
                "fix_x": thrust, "fix_y": True, "fix_z": True,
                "fix_rx": thrust and not self.free_torsion,
                "fix_ry": False, "fix_rz": False,
            })
        return out

    @staticmethod
    def _classify(shape: np.ndarray) -> str:
        """Mode family by dominant DOF energy: lateral (u_y/u_z), torsional
        (r_x) or axial (u_x). Bending rotations r_y/r_z ride with lateral."""
        s = shape.reshape(-1, 6)
        e_lat = float(np.sum(s[:, 1] ** 2 + s[:, 2] ** 2))
        e_tor = float(np.sum(s[:, 3] ** 2))
        e_ax = float(np.sum(s[:, 0] ** 2))
        return ("lateral", "torsional", "axial")[
            int(np.argmax([e_lat, e_tor, e_ax]))]

    def run(self, n_modes: int = 12, rigid_tol_hz: float = 0.01) -> List[ShaftMode]:
        """Solve for the lowest `n_modes` elastic modes.

        rigid_tol_hz: modes below this frequency are discarded as numerical
        leakage of rigid-body motion (with ``free_torsion=True`` the torsional
        rigid mode comes back from the eigensolver as ~1e-3 Hz noise instead
        of exactly zero; real shaft criticals are orders of magnitude above
        0.01 Hz)."""
        self._log("2. Assembling Timoshenko stiffness/mass and solving the "
                  "eigenproblem...")
        self.analysis = BeamAnalysis(
            self.mesh, self._section_data(), self._bc_data(),
            E=self.E, nu=self.nu, rho=self.rho, mass=self.mass, device=self.device)
        # request a buffer: a filtered rigid mode must not cost an elastic one
        res = self.analysis.run(n_modes=n_modes + 2)
        self.modes = []
        for k, w in enumerate(res.natural_frequencies):
            if len(self.modes) >= n_modes:
                break
            f_hz = float(w) / (2.0 * np.pi)
            if f_hz < rigid_tol_hz:
                continue
            fam = self._classify(res.mode_shapes[:, k])
            self.modes.append(ShaftMode(
                frequency_hz=f_hz, family=fam,
                critical_speed_rpm=60.0 * f_hz if fam == "lateral" else None,
                shape=np.asarray(res.mode_shapes[:, k])))
        self._log("\n--- Shaft Modal Results ---")
        for i, m in enumerate(self.modes):
            rpm = (f", critical speed {m.critical_speed_rpm:.1f} RPM"
                   if m.critical_speed_rpm is not None else "")
            self._log(f"  Mode {i + 1}: {m.frequency_hz:.3f} Hz "
                      f"[{m.family}]{rpm}")
        return self.modes

    # alias matching the reference pipelines' entry-point name
    run_simulation = run

    @property
    def critical_speeds_rpm(self) -> np.ndarray:
        """Ascending lateral critical speeds in RPM (whirl pairs included)."""
        return np.array([m.critical_speed_rpm for m in self.modes
                         if m.family == "lateral"])

    def lateral_frequencies_hz(self) -> np.ndarray:
        return np.array([m.frequency_hz for m in self.modes
                         if m.family == "lateral"])

    def plot_mode(self, mode_num: int = 1, filename: str = "shaft_mode.png") -> str:
        raise NotImplementedError("plots are not ported yet (ROADMAP A16)")

    def generate_report(self, filename: str = "shaft_report.md") -> str:
        raise NotImplementedError("reports are not ported yet (ROADMAP A16)")
