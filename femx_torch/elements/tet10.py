"""Tetra10 element constants (host numpy).

The part of femx.elements.tet10 that the structured cell stiffness and the
solid analysis need: the reference's 4-point Gauss rule
(ReactionSolver.py:120-123), the natural-coordinate shape gradients, the
Voigt selector and the isotropic material matrix.
"""

from __future__ import annotations

import numpy as np

# 4-point Gauss rule on the reference tetrahedron.
_A, _B = 0.5854101966249685, 0.1381966011250105
GAUSS_POINTS = np.array(
    [[_A, _B, _B], [_B, _A, _B], [_B, _B, _A], [_B, _B, _B]], dtype=np.float64
)
GAUSS_WEIGHT_CORRECT = 1.0 / 24.0
GAUSS_WEIGHT_REFERENCE = 0.25  # reference's (buggy) weight


def _dshape_natural(xi, eta, zeta):
    """d(N_i)/d(xi,eta,zeta) for the 10 Tet10 shape functions. Node order: 4
    vertices then midsides on edges (0,1),(1,2),(0,2),(0,3),(1,3),(2,3) — gmsh
    order, the reference kernel's layout (ReactionSolver.py:100-113)."""
    L1 = 1.0 - xi - eta - zeta
    L2, L3, L4 = xi, eta, zeta
    dN_L = np.zeros((4, 10))
    dN_L[0, 0] = 4 * L1 - 1
    dN_L[1, 1] = 4 * L2 - 1
    dN_L[2, 2] = 4 * L3 - 1
    dN_L[3, 3] = 4 * L4 - 1
    dN_L[0, 4], dN_L[1, 4] = 4 * L2, 4 * L1
    dN_L[1, 5], dN_L[2, 5] = 4 * L3, 4 * L2
    dN_L[0, 6], dN_L[2, 6] = 4 * L3, 4 * L1
    dN_L[0, 7], dN_L[3, 7] = 4 * L4, 4 * L1
    dN_L[1, 8], dN_L[3, 8] = 4 * L4, 4 * L2
    dN_L[2, 9], dN_L[3, 9] = 4 * L4, 4 * L3
    dL = np.array([[-1, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float64)
    return dL.T @ dN_L  # (3, 10)


# (4 gauss, 3, 10) natural-coordinate shape gradients.
DN_NATURAL = np.stack([_dshape_natural(*p) for p in GAUSS_POINTS])

# Voigt selector Sel[a, c, k]: strain component a gets contribution
# dN[k, i] * u[(i, c)].  Rows: xx, yy, zz, xy, yz, zx.
_SEL = np.zeros((6, 3, 3))
_SEL[0, 0, 0] = 1.0
_SEL[1, 1, 1] = 1.0
_SEL[2, 2, 2] = 1.0
_SEL[3, 0, 1] = _SEL[3, 1, 0] = 1.0
_SEL[4, 1, 2] = _SEL[4, 2, 1] = 1.0
_SEL[5, 0, 2] = _SEL[5, 2, 0] = 1.0


def material_matrix(E, v) -> np.ndarray:
    """(6, 6) float64 isotropic elasticity matrix, Voigt order
    [xx,yy,zz,xy,yz,zx] (reference: ReactionSolver.py:87-98)."""
    E_, v_ = float(E), float(v)
    c1 = E_ / ((1 + v_) * (1 - 2 * v_))
    C = np.zeros((6, 6))
    C[:3, :3] = v_
    np.fill_diagonal(C[:3, :3], 1 - v_)
    C[3, 3] = C[4, 4] = C[5, 5] = (1 - 2 * v_) / 2
    return c1 * C
