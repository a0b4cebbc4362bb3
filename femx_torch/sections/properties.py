"""Section properties: exact polygon moments + torsion/shear constants
(port of femx/sections/properties.py).

- A, centroid, centroidal Ixx/Iyy/Ixy and extreme-fibre distances exactly,
  by Green's theorem on the parametric polygon (host numpy);
- J and the shear-area ratios kappa closed-form where exact (circle, tube,
  rectangle by series) and by classical formulas otherwise, or from the 2D
  warping FEM of femx_torch.sections.warping, which solves on `device`.

Return contract: the reference's 8-tuple
(A, I_x, I_y, J, kappa_y, kappa_z, c_y_max, c_z_max) with I_x = Ixx_c,
I_y = Iyy_c, kappa = A_s/A, c_y_max = max|x - cx|, c_z_max = max|y - cy|
(BeamSolver.py:69-79); `rotate=True` swaps each (y, z) pair
(BeamSolver.py:76-77).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from femx_torch.config import resolve_device, torch_dtype

from femx_torch.sections.geometry import SectionGeometry, build_geometry


class SectionProperties(NamedTuple):
    A: float
    I_x: float  # centroidal Ixx (bending about the horizontal axis)
    I_y: float  # centroidal Iyy
    J: float
    kappa_y: float
    kappa_z: float
    c_y_max: float  # extreme fiber distance in x from centroid
    c_z_max: float  # extreme fiber distance in y from centroid

    def as_tuple(self):
        return tuple(self)

    def rotated(self) -> "SectionProperties":
        return SectionProperties(
            A=self.A,
            I_x=self.I_y,
            I_y=self.I_x,
            J=self.J,
            kappa_y=self.kappa_z,
            kappa_z=self.kappa_y,
            c_y_max=self.c_z_max,
            c_z_max=self.c_y_max,
        )


def polygon_moments(geom: SectionGeometry):
    """Exact A, centroid (cx, cy), centroidal ixx, iyy, ixy via Green's
    theorem over the signed loops (outer CCW positive, holes negative)."""
    A = cx_m = cy_m = ixx = iyy = ixy = 0.0
    for loop in geom.loops_signed():
        x, y = loop[:, 0], loop[:, 1]
        x1, y1 = np.roll(x, -1), np.roll(y, -1)
        cross = x * y1 - x1 * y
        A += 0.5 * np.sum(cross)
        cx_m += np.sum((x + x1) * cross) / 6.0
        cy_m += np.sum((y + y1) * cross) / 6.0
        ixx += np.sum((y * y + y * y1 + y1 * y1) * cross) / 12.0
        iyy += np.sum((x * x + x * x1 + x1 * x1) * cross) / 12.0
        ixy += np.sum((x * y1 + 2 * x * y + 2 * x1 * y1 + x1 * y) * cross) / 24.0
    cx, cy = cx_m / A, cy_m / A
    ixx_c = ixx - A * cy * cy
    iyy_c = iyy - A * cx * cx
    ixy_c = ixy - A * cx * cy
    return A, cx, cy, ixx_c, iyy_c, ixy_c


def extreme_fibers(geom: SectionGeometry, cx: float, cy: float):
    v = geom.all_vertices()
    return float(np.max(np.abs(v[:, 0] - cx))), float(np.max(np.abs(v[:, 1] - cy)))


def torsion_rectangle(a: float, b: float, terms: int = 25) -> float:
    """Exact series for a solid rectangle a x b (Saint-Venant)."""
    long_, short = (a, b) if a >= b else (b, a)
    n = np.arange(terms) * 2 + 1
    s = np.sum(np.tanh(n * np.pi * long_ / (2 * short)) / n**5)
    return float(long_ * short**3 * (1.0 / 3.0 - (64.0 / np.pi**5) * (short / long_) * s))


def _closed_form_jk(section_type: str, params: dict, A: float, nu: float = 0.0):
    """Closed-form / classical J and kappa per type. nu=0 matches the
    reference, whose sectionproperties material defaults to nu=0."""
    st = section_type.strip().lower()
    if st == "circular section":
        d = params["d"]
        J = np.pi * d**4 / 32.0
        k = 6.0 * (1 + nu) / (7.0 + 6.0 * nu)
        return J, k, k
    if st == "hollow circular section":
        d, t = params["d"], params["t"]
        di = d - 2 * t
        J = np.pi * (d**4 - di**4) / 32.0
        m = di / d
        # Thick-tube shear factor (Cowper): nu=0 limit of the classical form.
        k = 6.0 * (1 + nu) * (1 + m**2) ** 2 / (
            (7 + 6 * nu) * (1 + m**2) ** 2 + (20 + 12 * nu) * m**2
        )
        return J, k, k
    if st == "rectangular section":
        d, b = params["d"], params["b"]
        J = torsion_rectangle(b, d)
        k = 10.0 * (1 + nu) / (12.0 + 11.0 * nu)
        return J, k, k
    if st == "i section":
        d, b, tf, tw = params["d"], params["b"], params["t_f"], params["t_w"]
        J = (2 * b * tf**3 + (d - 2 * tf) * tw**3) / 3.0
        web_area = (d - 2 * tf) * tw
        flange_area = 2 * b * tf
        # Shear along y carried by the web; along x by the flanges.
        return J, min(1.0, flange_area * 0.83 / A), min(1.0, web_area / A)
    if st == "c section":
        d, b, tf, tw = params["d"], params["b"], params["t_f"], params["t_w"]
        J = (2 * b * tf**3 + (d - 2 * tf) * tw**3) / 3.0
        web_area = (d - 2 * tf) * tw
        flange_area = 2 * b * tf
        return J, min(1.0, flange_area * 0.83 / A), min(1.0, web_area / A)
    if st == "l section":
        d, b, t = params["d"], params["b"], params["t"]
        J = (b * t**3 + (d - t) * t**3) / 3.0
        return J, min(1.0, b * t * 0.85 / A), min(1.0, d * t * 0.85 / A)
    if st == "hollow box section":
        d, b, t = params["d"], params["b"], params["t"]
        bm, dm = b - t, d - t  # midline dimensions
        J = 2 * t * (bm * dm) ** 2 / (bm + dm)  # Bredt, uniform wall
        kz = min(1.0, 2 * dm * t / A)
        ky = min(1.0, 2 * bm * t / A)
        return J, ky, kz
    raise ValueError(f"Unknown section type '{section_type}'")


# Shapes whose closed-form J/kappa are already exact (or exact-series);
# the warping FEM only adds value for the open/box thin-walled shapes.
_CLOSED_FORM_EXACT = {"rectangular section", "circular section", "hollow circular section"}


def _reference_mesh_size(params: dict) -> float:
    """The reference's refinement rule: min thickness / 10, falling back to
    min(d, b) / 10 for solid shapes (BeamSolver.py:58-64)."""
    t_vals = [v for k, v in params.items() if "t" in k and isinstance(v, (int, float)) and v > 0]
    if t_vals:
        return min(t_vals) / 10.0
    dims = [v for k, v in params.items() if k in ("d", "b") and v > 0]
    return (min(dims) if dims else 1.0) / 10.0


@lru_cache(maxsize=256)
def _fem_jk_cached(section_type: str, params_key: tuple, nu: float, device: torch.device,
                   dtype: torch.dtype):
    from femx_torch.sections.warping import warping_constants

    params = dict(params_key)
    geom = build_geometry(section_type, params)
    return warping_constants(geom, nu=nu, mesh_size=_reference_mesh_size(params),
                             device=device, dtype=dtype)


def compute_properties(
    section_type: str,
    params: dict,
    rotate: bool = False,
    method: str = "auto",
    nu: float = 0.0,
    device=None,
    dtype=torch.float64,
) -> SectionProperties:
    """Full 8-component property set for one section.

    method: 'closed_form' uses classical J/kappa formulas; 'fem' runs the 2D
    warping/shear FEM (femx_torch.sections.warping) for reference-grade
    J/kappa; 'auto' uses closed forms where they are exact
    (rect/circle/tube) and the FEM for thin-walled open/box shapes
    (I/C/L/hollow-box), cached per (type, params, nu, device, dtype). The
    FEM solves on `device` (None = CUDA) in `dtype`; as in femx, a failed
    FEM falls back to the closed forms under 'auto'.
    """
    dev = resolve_device(device)
    geom = build_geometry(section_type, params)
    A, cx, cy, ixx_c, iyy_c, _ixy_c = polygon_moments(geom)
    c_y, c_z = extreme_fibers(geom, cx, cy)
    st = section_type.strip().lower()
    use_fem = method == "fem" or (method == "auto" and st not in _CLOSED_FORM_EXACT)
    J = ky = kz = None
    if use_fem:
        try:
            key = tuple(sorted((k, float(v)) for k, v in params.items()))
            J, ky, kz = _fem_jk_cached(st, key, float(nu), dev, torch_dtype(dtype))
        except Exception:
            if method == "fem":
                raise
    if J is None:
        J, ky, kz = _closed_form_jk(section_type, params, A, nu=nu)
    props = SectionProperties(
        A=float(A),
        I_x=float(ixx_c),
        I_y=float(iyy_c),
        J=float(J),
        kappa_y=float(ky),
        kappa_z=float(kz),
        c_y_max=c_y,
        c_z_max=c_z,
    )
    return props.rotated() if rotate else props


def calculate_section_properties(section_type: str, params: dict, rotate: bool = False,
                                 device=None):
    """The reference function's contract (BeamSolver.py:32-82): same
    signature, same 8-tuple return, a zeros tuple on failure. `device` (None
    = CUDA) is resolved first, so a missing card raises."""
    dev = resolve_device(device)
    try:
        clean = {k: v for k, v in params.items() if k != "rotate"}
        return compute_properties(section_type, clean, rotate=rotate, device=dev).as_tuple()
    except Exception as e:  # the reference's forgiving contract
        print(f"Error computing section properties for {section_type} ({params}): {e}")
        return (0.0,) * 8
