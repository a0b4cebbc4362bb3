"""Tetra10 solid elasticity element (port of femx/elements/tet10.py).

Host numpy constants — the reference's 4-point Gauss rule
(ReactionSolver.py:120-123), the natural-coordinate shape gradients, the
Voigt selector and the isotropic material matrix — and the batched element
kernels as torch einsums on the caller's device:

  Ke[(i,c),(j,d)] = sum_g w*detJ_g * dN_g[k,i] * Chat[c,k,d,l] * dN_g[l,j]
  with Chat[c,k,d,l] = Sel[a,c,k] C[a,b] Sel[b,d,l]

plus the exact straight-sided Tet10 mass terms (consistent and HRZ-lumped)
and the Gauss-point strain/stress and von Mises postprocessing.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """Host constant (or tensor) in `like`'s dtype on its device."""
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                           dtype=like.dtype, device=like.device)


def chat_tensor(C: torch.Tensor) -> torch.Tensor:
    """Chat[c,k,d,l] = Sel[a,c,k] C[a,b] Sel[b,d,l] (3,3,3,3)."""
    sel = _const(_SEL, C)
    return torch.einsum("ack,ab,bdl->ckdl", sel, C, sel)


def _inv3x3(J: torch.Tensor):
    """Closed-form batched 3x3 inverse and determinant by cofactors.
    Returns (Jinv, detJ) for J of shape (..., 3, 3); a zero determinant
    divides by 1 instead."""
    a, b, c = J[..., 0, :], J[..., 1, :], J[..., 2, :]
    cb = torch.linalg.cross(b, c)
    ca = torch.linalg.cross(c, a)
    ab = torch.linalg.cross(a, b)
    det = (a * cb).sum(-1)
    inv_cols = torch.stack([cb, ca, ab], dim=-1)  # (..., 3, 3): columns
    safe = torch.where(det.abs() > 1e-300, det, torch.ones_like(det))
    return inv_cols / safe[..., None, None], det


def jacobians(coords: torch.Tensor):
    """Per-element, per-Gauss-point Jacobian data.

    Args:
      coords: (E, 10, 3) element node coordinates.
    Returns:
      dN_glob: (E, 4, 3, 10) global shape-function gradients.
      wdet:    (E, 4) w-free quadrature factor detJ, zeroed where
               detJ <= 1e-12 (the reference skips and counts such points,
               ReactionSolver.py:133-135).
      detJ:    (E, 4) raw determinants.
    """
    dn = _const(DN_NATURAL, coords)
    J = torch.einsum("gkn,enc->egkc", dn, coords)
    Jinv, detJ = _inv3x3(J)
    dN_glob = torch.einsum("egkc,gcn->egkn", Jinv, dn)
    ok = detJ > 1e-12
    wdet = torch.where(ok, detJ, torch.zeros_like(detJ))
    dN_glob = torch.where(ok[..., None, None], dN_glob, torch.zeros_like(dN_glob))
    return dN_glob, wdet, detJ


def element_stiffness(coords: torch.Tensor, C, weight=GAUSS_WEIGHT_CORRECT):
    """Batched Tet10 stiffness matrices.

    Returns Ke (E, 30, 30) in node-major / xyz-minor DOF order and the count
    of skipped integration points (detJ <= 1e-12)."""
    dN, wdet, detJ = jacobians(coords)
    chat = chat_tensor(_const(C, coords))
    ke = torch.einsum("egki,ckdl,eglj,eg->eicjd", dN, chat, dN, weight * wdet)
    return ke.reshape(coords.shape[0], 30, 30), int((detJ <= 1e-12).sum())


def element_apply(dN, wdet, C, ue, weight=GAUSS_WEIGHT_CORRECT):
    """Matrix-free element action fe = Ke @ ue without forming Ke: strains
    at the Gauss points, stress via C, the transposed-B contraction.

    dN (E, 4, 3, 10), wdet (E, 4), C (6, 6), ue (E, 10, 3) -> fe (E, 10, 3).
    """
    sel = _const(_SEL, ue)
    C = _const(C, ue)
    grad = torch.einsum("egkn,enc->egkc", dN, ue)
    strain = torch.einsum("ack,egkc->ega", sel, grad)
    stress = torch.einsum("ab,egb->ega", C, strain)
    return torch.einsum("egkn,ack,ega,eg->enc", dN, sel, stress, weight * wdet)


def element_strain_stress(dN, C, ue):
    """Per-Gauss-point strain and stress tensors (Voigt) for postprocessing:
    dN (E, 4, 3, 10), C (6, 6), ue (E, 10, 3) -> (E, 4, 6) each."""
    sel = _const(_SEL, ue)
    C = _const(C, ue)
    grad = torch.einsum("egkn,enc->egkc", dN, ue)
    strain = torch.einsum("ack,egkc->ega", sel, grad)
    stress = torch.einsum("ab,egb->ega", C, strain)
    return strain, stress


def von_mises(stress):
    """Von Mises stress from Voigt [xx,yy,zz,xy,yz,zx] stresses (..., 6)."""
    sxx, syy, szz = stress[..., 0], stress[..., 1], stress[..., 2]
    sxy, syz, szx = stress[..., 3], stress[..., 4], stress[..., 5]
    return torch.sqrt(
        0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2 + (szz - sxx) ** 2)
        + 3.0 * (sxy**2 + syz**2 + szx**2))


def _mass_matrix_hat() -> np.ndarray:
    """Mhat[i,j] = (1/V) * integral(N_i N_j dV) over a straight-sided Tet10,
    exact: each shape function is a quadratic in the barycentric coordinates
    (N_corner_i = L_i(2L_i - 1), N_edge_ij = 4 L_i L_j), and

        integral(L1^a L2^b L3^c L4^d dV) = 6V * a! b! c! d! / (a+b+c+d+3)!

    so Mhat is dimensionless and geometry-independent (host float64)."""
    from math import factorial

    def corner(i):
        e2 = [0, 0, 0, 0]
        e2[i] = 2
        e1 = [0, 0, 0, 0]
        e1[i] = 1
        return {tuple(e2): 2.0, tuple(e1): -1.0}

    def edge(i, j):
        e = [0, 0, 0, 0]
        e[i] += 1
        e[j] += 1
        return {tuple(e): 4.0}

    # gmsh Tet10 node order, as DN_NATURAL
    shapes = [corner(i) for i in range(4)] + [
        edge(0, 1), edge(1, 2), edge(0, 2), edge(0, 3), edge(1, 3), edge(2, 3)]

    def integral(mono):  # integral(prod L^e dV) / V
        num = 6.0
        for e in mono:
            num *= factorial(e)
        return num / factorial(sum(mono) + 3)

    M = np.zeros((10, 10))
    for i in range(10):
        for j in range(i, 10):
            acc = 0.0
            for ei, ci in shapes[i].items():
                for ej, cj in shapes[j].items():
                    acc += ci * cj * integral(tuple(a + b for a, b in zip(ei, ej)))
            M[i, j] = M[j, i] = acc
    return M


MASS_HAT = _mass_matrix_hat()  # (10, 10), exact, straight-sided tets


def element_volume(coords: torch.Tensor) -> torch.Tensor:
    """Signed volumes (E,) of straight tets from their 4 corner nodes."""
    v1 = coords[:, 1, :] - coords[:, 0, :]
    v2 = coords[:, 2, :] - coords[:, 0, :]
    v3 = coords[:, 3, :] - coords[:, 0, :]
    return (v1 * torch.linalg.cross(v2, v3)).sum(-1) / 6.0


def element_mass_consistent(coords: torch.Tensor, rho) -> torch.Tensor:
    """Batched exact consistent mass (E, 30, 30) of straight-sided Tet10s:
    Me[(i,c),(j,d)] = rho * V * Mhat[i,j] * delta_cd, DOF order node-major /
    xyz-minor (element_stiffness's)."""
    V = element_volume(coords)
    m_node = rho * V[:, None, None] * _const(MASS_HAT, V)  # (E, 10, 10)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    return torch.einsum("eij,cd->eicjd", m_node, eye3).reshape(-1, 30, 30)


def element_mass_lumped(coords: torch.Tensor, rho) -> torch.Tensor:
    """Batched HRZ-lumped nodal masses (E, 10): the consistent mass's
    diagonal scaled so each element keeps its total rho*V (row-sum lumping
    would go negative on Tet10 corners)."""
    d = np.diag(MASS_HAT)
    V = element_volume(coords)
    return rho * V[:, None] * _const(d / d.sum(), V)
