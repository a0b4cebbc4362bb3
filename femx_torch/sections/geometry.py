"""Parametric cross-section geometry: polygons (with holes) for 7 types
(a numpy copy of femx/sections/geometry.py for the port).

The reference delegates to the `sectionproperties` library
(BeamSolver.py:41-54) with these parametrizations:
  I section:        d, b, t_f, t_w, r (root radius), n_r=8
  C section:        d, b, t_f, t_w, r, n_r=8
  L section:        d, b, t, r_r (root), r_t (toe), n_r=8
  hollow box:       d, b, t, r_out, n_r=8
  rectangular:      d, b
  circular:         d, n=64
  hollow circular:  d, t, n=64

The shapes are explicit polygons: an outer boundary (counter-clockwise)
plus optional hole boundaries, with circles and fillet radii discretized as
the reference's calls do (n=64 circle points, n_r=8 points per fillet arc).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SectionGeometry:
    """A planar region: CCW outer boundary and CW-irrelevant hole list
    (holes are subtracted by signed-area convention in the property code)."""

    outer: np.ndarray  # (n, 2)
    holes: List[np.ndarray] = dataclasses.field(default_factory=list)
    name: str = ""

    def all_vertices(self) -> np.ndarray:
        vs = [self.outer] + list(self.holes)
        return np.concatenate(vs, axis=0)

    def loops_signed(self) -> List[np.ndarray]:
        """Outer loop CCW (positive area) and holes CW (negative area)."""
        loops = [_orient(self.outer, ccw=True)]
        loops += [_orient(h, ccw=False) for h in self.holes]
        return loops


def _orient(poly: np.ndarray, ccw: bool) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    a2 = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    if (a2 > 0) != ccw:
        return poly[::-1]
    return poly


def _arc(cx, cy, r, theta0, theta1, n) -> np.ndarray:
    """n-point arc from theta0 to theta1 (inclusive endpoints)."""
    t = np.linspace(theta0, theta1, max(n, 2))
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], axis=1)


def _dedup(points: np.ndarray, tol=1e-12) -> np.ndarray:
    keep = [0]
    for i in range(1, len(points)):
        if np.linalg.norm(points[i] - points[keep[-1]]) > tol:
            keep.append(i)
    if np.linalg.norm(points[keep[-1]] - points[keep[0]]) <= tol and len(keep) > 1:
        keep = keep[:-1]
    return points[keep]


def rectangular(d: float, b: float) -> SectionGeometry:
    """Rectangle, width b along x, depth d along y, corner at origin."""
    return SectionGeometry(
        outer=np.array([[0.0, 0.0], [b, 0.0], [b, d], [0.0, d]]), name="rectangular"
    )


def circular(d: float, n: int = 64) -> SectionGeometry:
    """Circle of diameter d discretized as a regular n-gon (center origin)."""
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = d / 2.0
    return SectionGeometry(outer=np.stack([r * np.cos(t), r * np.sin(t)], axis=1), name="circular")


def circular_hollow(d: float, t: float, n: int = 64) -> SectionGeometry:
    outer = circular(d, n).outer
    inner = circular(d - 2 * t, n).outer
    return SectionGeometry(outer=outer, holes=[inner], name="circular_hollow")


def i_section(
    d: float, b: float, t_f: float, t_w: float, r: float = 0.0, n_r: int = 8
) -> SectionGeometry:
    """Doubly-symmetric I: depth d (y), flange width b (x), web t_w, flange
    t_f, root radius r between web and flanges. Origin at bottom-left."""
    xw0 = (b - t_w) / 2.0  # web left face
    xw1 = (b + t_w) / 2.0  # web right face
    pts = [np.array([[0.0, 0.0], [b, 0.0], [b, t_f]])]
    if r > 0:
        pts.append(_arc(xw1 + r, t_f + r, r, 1.5 * np.pi, np.pi, n_r))
    else:
        pts.append(np.array([[xw1, t_f]]))
    if r > 0:
        pts.append(_arc(xw1 + r, d - t_f - r, r, np.pi, 0.5 * np.pi, n_r))
    else:
        pts.append(np.array([[xw1, d - t_f]]))
    pts.append(np.array([[b, d - t_f], [b, d], [0.0, d], [0.0, d - t_f]]))
    if r > 0:
        pts.append(_arc(xw0 - r, d - t_f - r, r, 0.5 * np.pi, 0.0, n_r))
        pts.append(_arc(xw0 - r, t_f + r, r, 0.0, -0.5 * np.pi, n_r))
    else:
        pts.append(np.array([[xw0, d - t_f], [xw0, t_f]]))
    pts.append(np.array([[0.0, t_f]]))
    return SectionGeometry(outer=_dedup(np.concatenate(pts, axis=0)), name="i_section")


def channel(
    d: float, b: float, t_f: float, t_w: float, r: float = 0.0, n_r: int = 8
) -> SectionGeometry:
    """C-channel: web on the left (x=0..t_w), flanges at top/bottom extending
    to x=b, root radius r at the two inner web/flange corners."""
    pts = [np.array([[0.0, 0.0], [b, 0.0], [b, t_f]])]
    if r > 0:
        pts.append(_arc(t_w + r, t_f + r, r, 1.5 * np.pi, np.pi, n_r))
        pts.append(_arc(t_w + r, d - t_f - r, r, np.pi, 0.5 * np.pi, n_r))
    else:
        pts.append(np.array([[t_w, t_f], [t_w, d - t_f]]))
    pts.append(np.array([[b, d - t_f], [b, d], [0.0, d]]))
    return SectionGeometry(outer=_dedup(np.concatenate(pts, axis=0)), name="channel")


def angle(
    d: float, b: float, t: float, r_r: float = 0.0, r_t: float = 0.0, n_r: int = 8
) -> SectionGeometry:
    """L-angle: vertical leg height d (thickness t along x), horizontal leg
    width b (thickness t along y), root radius r_r at the inner corner, toe
    radius r_t at the two leg tips."""
    pts = [np.array([[0.0, 0.0], [b, 0.0]])]
    if r_t > 0:
        pts.append(_arc(b - r_t, t - r_t, r_t, 0.0, 0.5 * np.pi, n_r))
    else:
        pts.append(np.array([[b, t]]))
    if r_r > 0:
        pts.append(_arc(t + r_r, t + r_r, r_r, 1.5 * np.pi, np.pi, n_r))
    else:
        pts.append(np.array([[t, t]]))
    if r_t > 0:
        pts.append(_arc(t - r_t, d - r_t, r_t, 0.0, 0.5 * np.pi, n_r))
    else:
        pts.append(np.array([[t, d]]))
    pts.append(np.array([[0.0, d]]))
    return SectionGeometry(outer=_dedup(np.concatenate(pts, axis=0)), name="angle")


def rectangular_hollow(
    d: float, b: float, t: float, r_out: float = 0.0, n_r: int = 8
) -> SectionGeometry:
    """RHS/box: outer b x d with corner radius r_out, wall thickness t,
    inner corner radius max(r_out - t, 0)."""

    def rounded_rect(w, h, rad, off):
        if rad <= 0:
            return np.array([[off, off], [off + w, off], [off + w, off + h], [off, off + h]])
        cx0, cx1 = off + rad, off + w - rad
        cy0, cy1 = off + rad, off + h - rad
        return _dedup(
            np.concatenate(
                [
                    _arc(cx1, cy0, rad, -0.5 * np.pi, 0.0, n_r),
                    _arc(cx1, cy1, rad, 0.0, 0.5 * np.pi, n_r),
                    _arc(cx0, cy1, rad, 0.5 * np.pi, np.pi, n_r),
                    _arc(cx0, cy0, rad, np.pi, 1.5 * np.pi, n_r),
                ]
            )
        )

    outer = rounded_rect(b, d, r_out, 0.0)
    r_in = max(r_out - t, 0.0)
    inner = rounded_rect(b - 2 * t, d - 2 * t, r_in, t)
    return SectionGeometry(outer=outer, holes=[inner], name="rectangular_hollow")


# Section-type registry keyed by the reference GUI's type strings
# (BeamSolver.py:41-54 / section_type_combo, BeamSolver.py:191-192).
def build_geometry(section_type: str, params: dict) -> SectionGeometry:
    st = section_type.strip().lower()
    if st == "i section":
        return i_section(
            params["d"], params["b"], params["t_f"], params["t_w"], params.get("r", 0.0)
        )
    if st == "c section":
        return channel(
            params["d"], params["b"], params["t_f"], params["t_w"], params.get("r", 0.0)
        )
    if st == "l section":
        return angle(
            params["d"], params["b"], params["t"], params.get("r_r", 0.0), params.get("r_t", 0.0)
        )
    if st == "hollow box section":
        return rectangular_hollow(params["d"], params["b"], params["t"], params.get("r_out", 0.0))
    if st == "rectangular section":
        return rectangular(params["d"], params["b"])
    if st == "circular section":
        return circular(params["d"], int(params.get("n", 64)))
    if st == "hollow circular section":
        return circular_hollow(params["d"], params["t"], int(params.get("n", 64)))
    raise ValueError(f"Unknown section type '{section_type}'")
