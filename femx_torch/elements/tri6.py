"""Tri6 2D elasticity element (port of femx/elements/tri6.py).

Quadratic 6-node triangle in PLANE STRESS / PLANE STRAIN and AXISYMMETRIC
formulations, the element of the 2D products (PlaneAnalysis,
PipeThermalAnalysis). Host numpy constants (Gauss rules, shape functions
and gradients, Voigt selectors, the exact mass constant) and batched torch
functions of element tensors on the caller's device and in its dtype; the
material matrices are built in an explicit dtype. The contractions over
an element's 6 nodes (the displacement gradients, and the transpose that
sends stresses back to the nodes) are broadcast products summed over one
axis: a torch matmul of (E, 3, 2, 6) by (E, 1, 6, 2) runs as dozens of
cuBLAS calls over 2 x 6 tiles, which made it the bulk of an apply's device
time (chip_smoke.py phase 16 times the apply).

Voigt orders:
  plane:        [xx, yy, xy]                      C is 3x3
  axisymmetric: [rr, zz, tt, rz]  (tt = hoop)     C is 4x4

Node order: gmsh "triangle6" — 3 vertices then midsides on edges
(0,1), (1,2), (2,0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from femx_torch.config import torch_dtype

# 3-point Gauss rule on the reference triangle (degree-2 exact).
GAUSS_POINTS = np.array(
    [[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]], dtype=np.float64
)
GAUSS_WEIGHT = 1.0 / 6.0  # per point; sum = 1/2 = area of reference triangle


def _shape(xi, eta):
    """The 6 Tri6 shape functions at (xi, eta)."""
    L1 = 1.0 - xi - eta
    L2, L3 = xi, eta
    return np.array([
        L1 * (2 * L1 - 1), L2 * (2 * L2 - 1), L3 * (2 * L3 - 1),
        4 * L1 * L2, 4 * L2 * L3, 4 * L3 * L1,
    ])


def _dshape_natural(xi, eta):
    """d(N_i)/d(xi,eta) for the 6 shape functions, shape (2, 6)."""
    L1 = 1.0 - xi - eta
    L2, L3 = xi, eta
    dN_L = np.zeros((3, 6))
    dN_L[0, 0] = 4 * L1 - 1
    dN_L[1, 1] = 4 * L2 - 1
    dN_L[2, 2] = 4 * L3 - 1
    dN_L[0, 3], dN_L[1, 3] = 4 * L2, 4 * L1
    dN_L[1, 4], dN_L[2, 4] = 4 * L3, 4 * L2
    dN_L[2, 5], dN_L[0, 5] = 4 * L1, 4 * L3
    dL = np.array([[-1, -1], [1, 0], [0, 1]], dtype=np.float64)  # (3, 2)
    return dL.T @ dN_L  # (2, 6)


# (3 gauss, 2, 6) gradients and (3 gauss, 6) values.
DN_NATURAL = np.stack([_dshape_natural(*p) for p in GAUSS_POINTS])
N_AT_GAUSS = np.stack([_shape(*p) for p in GAUSS_POINTS])

# Natural coordinates of the 6 nodes and the shape gradients there, for the
# O(h^2) nodal stress recovery.
NODE_NATURAL = np.array([
    [0.0, 0.0], [1.0, 0.0], [0.0, 1.0],
    [0.5, 0.0], [0.5, 0.5], [0.0, 0.5],
])
DN_AT_NODES = np.stack([_dshape_natural(*p) for p in NODE_NATURAL])

# Voigt selector Sel[a, c, k]: plane strain component a gets contribution
# dN[k, i] * u[(i, c)].  Rows: xx, yy, xy.
_SEL2 = np.zeros((3, 2, 2))
_SEL2[0, 0, 0] = 1.0
_SEL2[1, 1, 1] = 1.0
_SEL2[2, 0, 1] = _SEL2[2, 1, 0] = 1.0

# Axisymmetric selector for the gradient part (rr, zz, rz rows; the hoop row
# tt = u_r / r needs shape values, not gradients).
_SEL_AX = np.zeros((4, 2, 2))
_SEL_AX[0, 0, 0] = 1.0  # rr = du_r/dr
_SEL_AX[1, 1, 1] = 1.0  # zz = du_z/dz
_SEL_AX[3, 0, 1] = _SEL_AX[3, 1, 0] = 1.0  # rz = du_r/dz + du_z/dr


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def material_matrix_plane(E, v, mode="stress", dtype=torch.float64) -> torch.Tensor:
    """(3, 3) isotropic elasticity matrix, Voigt [xx, yy, xy], computed in
    `dtype` (a CPU tensor; callers move it).

    mode="stress": plane stress (sigma_zz = 0, thin plates).
    mode="strain": plane strain (eps_zz = 0, long prismatic bodies).
    """
    dt = torch_dtype(dtype)
    E = torch.tensor(float(E), dtype=dt)
    v = torch.tensor(float(v), dtype=dt)
    C = torch.zeros((3, 3), dtype=dt)
    if mode == "stress":
        c = E / (1 - v * v)
        C[0, 0] = C[1, 1] = 1.0
        C[0, 1] = C[1, 0] = v
        C[2, 2] = (1 - v) / 2
        return c * C
    if mode == "strain":
        c = E / ((1 + v) * (1 - 2 * v))
        C[0, 0] = C[1, 1] = 1 - v
        C[0, 1] = C[1, 0] = v
        C[2, 2] = (1 - 2 * v) / 2
        return c * C
    raise ValueError(f"mode must be 'stress' or 'strain', got {mode!r}")


def material_matrix_axisym(E, v, dtype=torch.float64) -> torch.Tensor:
    """(4, 4) isotropic elasticity matrix, Voigt [rr, zz, tt, rz], computed
    in `dtype` (a CPU tensor)."""
    dt = torch_dtype(dtype)
    E = torch.tensor(float(E), dtype=dt)
    v = torch.tensor(float(v), dtype=dt)
    c = E / ((1 + v) * (1 - 2 * v))
    out = torch.zeros((4, 4), dtype=dt)
    out[:3, :3] = v
    out[0, 0] = out[1, 1] = out[2, 2] = 1 - v
    out[3, 3] = (1 - 2 * v) / 2
    return c * out


def _inv2x2(J: torch.Tensor):
    """Closed-form batched 2x2 inverse and determinant for J (..., 2, 2)."""
    a, b = J[..., 0, 0], J[..., 0, 1]
    c, d = J[..., 1, 0], J[..., 1, 1]
    det = a * d - b * c
    safe = torch.where(det.abs() > 1e-300, det, torch.ones_like(det))
    inv = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2) / safe[..., None, None]
    return inv, det


def _gradients_at(dn_natural: np.ndarray, coords: torch.Tensor):
    """Global shape gradients (E, P, 2, 6) and detJ (E, P) at the P points
    whose natural gradients are dn_natural (P, 2, 6)."""
    dn = _const(dn_natural, coords)
    J = torch.einsum("gkn,enc->egkc", dn, coords)  # (E, P, 2, 2)
    Jinv, detJ = _inv2x2(J)
    return torch.einsum("egkc,gcn->egkn", Jinv, dn), detJ


def jacobians(coords: torch.Tensor):
    """Per-element, per-Gauss-point Jacobian data.

    Args:
      coords: (E, 6, 2) element node coordinates.
    Returns:
      dN_glob: (E, 3, 2, 6) global shape gradients.
      wdet:    (E, 3) GAUSS_WEIGHT * detJ, zeroed where detJ <= 1e-14.
      detJ:    (E, 3) raw determinants.
    """
    dN_glob, detJ = _gradients_at(DN_NATURAL, coords)
    ok = detJ > 1e-14
    wdet = torch.where(ok, GAUSS_WEIGHT * detJ, torch.zeros_like(detJ))
    dN_glob = torch.where(ok[..., None, None], dN_glob, torch.zeros_like(dN_glob))
    return dN_glob, wdet, detJ


def chat_tensor_plane(C: torch.Tensor) -> torch.Tensor:
    """Chat[c,k,d,l] = Sel[a,c,k] C[a,b] Sel[b,d,l] (2,2,2,2)."""
    sel = _const(_SEL2, C)
    return torch.einsum("ack,ab,bdl->ckdl", sel, C, sel)


def _grad(dN: torch.Tensor, ue: torch.Tensor) -> torch.Tensor:
    """grad[e,g,k,c] = sum_n dN[e,g,k,n] ue[e,n,c]: (E, G, 2, 2)."""
    return (dN[..., None] * ue[:, None, None]).sum(3)


def _strain_plane(grad: torch.Tensor) -> torch.Tensor:
    """Voigt [xx, yy, xy] from displacement gradients (..., 2, 2)."""
    return torch.stack([grad[..., 0, 0], grad[..., 1, 1],
                        grad[..., 0, 1] + grad[..., 1, 0]], dim=-1)


def _stress_matrix(s_xx, s_yy, s_xy) -> torch.Tensor:
    """The symmetric 2x2 [[s_xx, s_xy], [s_xy, s_yy]] of (...) components:
    Sel[a,c,k] stress[a] as a (k, c) matrix."""
    return torch.stack([torch.stack([s_xx, s_xy], dim=-1),
                        torch.stack([s_xy, s_yy], dim=-1)], dim=-2)


def _back(dN: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """fe[e,n,c] = sum_g sum_k dN[e,g,k,n] T[e,g,k,c]: (E, 6, 2)."""
    return (dN[..., None] * T[:, :, :, None, :]).sum((1, 2))


def _apply_C(C: torch.Tensor, strain: torch.Tensor) -> torch.Tensor:
    """stress[..., a] = sum_b C[a, b] strain[..., b]."""
    return strain @ C.T


def element_stiffness_plane(coords: torch.Tensor, C: torch.Tensor, thickness=1.0):
    """Batched plane stiffness matrices.

    Returns Ke (E, 12, 12), DOF order node-major / xy-minor, and the count
    of skipped integration points (detJ <= 1e-14)."""
    dN, wdet, detJ = jacobians(coords)
    ke = _stiffness_from(dN, thickness * wdet, chat_tensor_plane(C))
    return ke, (detJ <= 1e-14).sum()


def _stiffness_from(dN: torch.Tensor, w: torch.Tensor, chat: torch.Tensor) -> torch.Tensor:
    """Ke[(i,c),(j,d)] = sum_g w dN[g,k,i] chat[c,k,d,l] dN[g,l,j]."""
    E = dN.shape[0]
    A = torch.einsum("egki,ckdl->egicdl", dN, chat)  # (E, 3, 6, 2, 2, 2)
    ke = torch.einsum("egicdl,eglj,eg->eicjd", A, dN, w)
    return ke.reshape(E, 12, 12)


def element_apply_plane(dN, wdet, C, ue, thickness=1.0) -> torch.Tensor:
    """Matrix-free plane element action fe = Ke @ ue, (E, 6, 2)."""
    stress = _apply_C(C, _strain_plane(_grad(dN, ue)))  # (E, 3, 3)
    w = (thickness * wdet)[..., None, None]
    return _back(dN, _stress_matrix(stress[..., 0], stress[..., 1], stress[..., 2]) * w)


def element_strain_stress_plane(dN, C, ue):
    """Per-gauss-point plane strain and stress (Voigt [xx, yy, xy])."""
    strain = _strain_plane(_grad(dN, ue))
    return strain, _apply_C(C, strain)


def _gauss_values(coords: torch.Tensor, nodal: torch.Tensor) -> torch.Tensor:
    """(E, 3): a nodal field (E, 6) interpolated to the Gauss points."""
    return nodal @ _const(N_AT_GAUSS, coords).T


def element_thermal_load_plane(coords, C, alpha_eff, dT_nodes, thickness=1.0):
    """2D thermoelastic load fe = int B^T C (alpha_eff dT [1,1,0]) t dA,
    (E, 6, 2). alpha_eff is alpha for plane STRESS, (1+nu) alpha for plane
    STRAIN; dT_nodes (E, 6) nodal temperature rise."""
    dN, wdet, _ = jacobians(coords)
    dT_g = _gauss_values(coords, dT_nodes)
    eps_th = alpha_eff * dT_g[..., None] * _const([1.0, 1.0, 0.0], coords)
    stress = _apply_C(C, eps_th)
    w = (thickness * wdet)[..., None, None]
    return _back(dN, _stress_matrix(stress[..., 0], stress[..., 1], stress[..., 2]) * w)


# Degree-4 (Dunavant) 6-point rule — exact for the P2 mass integrand.
_MASS_PTS = np.array([
    [0.445948490915965, 0.445948490915965],
    [0.445948490915965, 0.108103018168070],
    [0.108103018168070, 0.445948490915965],
    [0.091576213509771, 0.091576213509771],
    [0.091576213509771, 0.816847572980459],
    [0.816847572980459, 0.091576213509771],
])
_MASS_W = 0.5 * np.array([0.223381589678011] * 3 + [0.109951743655322] * 3)
_N_AT_MASS = np.stack([_shape(*p) for p in _MASS_PTS])
_DN_AT_MASS = np.stack([_dshape_natural(*p) for p in _MASS_PTS])


def element_mass_plane(coords, rho, thickness=1.0) -> torch.Tensor:
    """Consistent plane mass matrices (E, 12, 12), exact quadrature:
    M[(i,c),(j,d)] = delta_cd int rho t N_i N_j dA."""
    dn = _const(_DN_AT_MASS, coords)
    J = torch.einsum("gkn,enc->egkc", dn, coords)
    _, detJ = _inv2x2(J)
    w = _const(_MASS_W, coords)
    n_g = _const(_N_AT_MASS, coords)  # (6, 6)
    mn = rho * thickness * torch.einsum("g,gi,gj,eg->eij", w, n_g, n_g,
                                        torch.clamp(detJ, min=0.0))
    eye = torch.eye(2, dtype=coords.dtype, device=coords.device)
    E = coords.shape[0]
    return torch.einsum("eij,cd->eicjd", mn, eye).reshape(E, 12, 12)


def _node_gradients(coords):
    """Global shape gradients at the 6 node positions, (E, 6, 2, 6) (index
    1 is the evaluation node, index 3 the shape function), and detJ."""
    return _gradients_at(DN_AT_NODES, coords)


def element_stress_at_nodes_plane(coords, C, ue, alpha_eff=0.0, dT_nodes=None):
    """Plane stresses evaluated at the element nodes, (E, 6, 3); with
    dT_nodes, the mechanical stress C (eps - alpha_eff dT [1,1,0])."""
    dN, _ = _node_gradients(coords)
    strain = _strain_plane(_grad(dN, ue))
    if dT_nodes is not None:
        strain = strain - alpha_eff * dT_nodes[..., None] * _const([1.0, 1.0, 0.0], ue)
    return _apply_C(C, strain)


def element_stress_at_nodes_axisym(coords, C, ue, alpha=0.0, dT_nodes=None):
    """Axisymmetric stresses at the element nodes, (E, 6, 4). The hoop
    strain at node n is u_r[n] / r[n]; on the axis (r = 0) its limit
    du_r/dr."""
    dN, _ = _node_gradients(coords)
    grad = _grad(dN, ue)
    strain = _strain_axisym_grad(grad)
    r = coords[:, :, 0]
    on_axis = r <= 1e-300
    hoop = torch.where(on_axis, strain[:, :, 0],
                       ue[:, :, 0] / torch.where(on_axis, torch.ones_like(r), r))
    strain = strain + hoop[..., None] * _const([0.0, 0.0, 1.0, 0.0], ue)
    if dT_nodes is not None:
        strain = strain - alpha * dT_nodes[..., None] * _const([1.0, 1.0, 1.0, 0.0], coords)
    return _apply_C(C, strain)


def von_mises_plane(stress, v=None):
    """Von Mises from plane Voigt [xx, yy, xy] stresses (..., 3); plane
    strain passes Poisson's ratio so sigma_zz = v (sigma_xx + sigma_yy)."""
    sxx, syy, sxy = stress[..., 0], stress[..., 1], stress[..., 2]
    szz = 0.0 if v is None else v * (sxx + syy)
    return torch.sqrt(
        0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2 + (szz - sxx) ** 2)
        + 3.0 * sxy**2
    )


# ---------------------------------------------------------------------------
# Axisymmetric formulation: coordinates (r, z), displacement (u_r, u_z); the
# volume integrals carry the 2*pi*r measure.
# ---------------------------------------------------------------------------


def axisym_gauss_data(coords: torch.Tensor):
    """Per-element, per-Gauss-point axisymmetric data.

    Returns dN_glob (E, 3, 2, 6), wdet_r (E, 3) = GAUSS_WEIGHT detJ 2 pi r_g,
    n_over_r (E, 3, 6) = N_k(g) / r_g, detJ (E, 3)."""
    dN_glob, wdet, detJ = jacobians(coords)
    r_g = _gauss_values(coords, coords[:, :, 0])  # (E, 3)
    r_safe = torch.where(r_g > 1e-300, r_g, torch.ones_like(r_g))
    wdet_r = wdet * 2.0 * math.pi * r_g
    n_over_r = _const(N_AT_GAUSS, coords)[None, :, :] / r_safe[:, :, None]
    return dN_glob, wdet_r, n_over_r, detJ


def _strain_axisym_grad(grad: torch.Tensor) -> torch.Tensor:
    """Voigt [rr, zz, tt, rz] from gradients, the hoop row left 0."""
    return torch.stack([grad[..., 0, 0], grad[..., 1, 1], torch.zeros_like(grad[..., 0, 0]),
                        grad[..., 0, 1] + grad[..., 1, 0]], dim=-1)


def _axisym_strain(dN, n_over_r, ue) -> torch.Tensor:
    """Voigt [rr, zz, tt, rz] strains at Gauss points, (E, 3, 4)."""
    strain = _strain_axisym_grad(_grad(dN, ue))
    hoop = (n_over_r * ue[:, None, :, 0]).sum(-1)  # (E, 3)
    return strain + hoop[..., None] * _const([0.0, 0.0, 1.0, 0.0], ue)


def _axisym_back(dN, n_over_r, stress, wdet_r) -> torch.Tensor:
    """fe = B^T stress w for axisymmetric stresses (E, 3, 4), (E, 6, 2)."""
    w = wdet_r[..., None, None]
    fe = _back(dN, _stress_matrix(stress[..., 0], stress[..., 1], stress[..., 3]) * w)
    # hoop row transpose: f_r[n] += N_n / r * sigma_tt
    fe_hoop = (n_over_r * (stress[..., 2] * wdet_r)[..., None]).sum(dim=1)  # (E, 6)
    return fe + fe_hoop[..., None] * _const([1.0, 0.0], fe)


def element_apply_axisym(dN, wdet_r, n_over_r, C, ue) -> torch.Tensor:
    """Matrix-free axisymmetric element action fe = Ke @ ue, (E, 6, 2)."""
    stress = _apply_C(C, _axisym_strain(dN, n_over_r, ue))
    return _axisym_back(dN, n_over_r, stress, wdet_r)


def element_stiffness_axisym(coords, C):
    """Batched axisymmetric stiffness (E, 12, 12), node-major / rz-minor,
    from the matrix-free action on the 12 unit displacement patterns (one
    code path, the apply, defines both), and the skipped-point count."""
    dN, wdet_r, n_over_r, detJ = axisym_gauss_data(coords)
    return axisym_stiffness_from(dN, wdet_r, n_over_r, C), (detJ <= 1e-14).sum()


def axisym_stiffness_from(dN, wdet_r, n_over_r, C) -> torch.Tensor:
    """(E, 12, 12) element matrices from axisym_gauss_data's tensors."""
    E = dN.shape[0]
    eye = torch.eye(12, dtype=dN.dtype, device=dN.device).reshape(12, 6, 2)
    cols = torch.stack([
        element_apply_axisym(dN, wdet_r, n_over_r, C, eye[j].expand(E, 6, 2))
        for j in range(12)
    ], dim=-1)  # (E, 6, 2, 12): [e, n, c, j] = Ke[(n,c), j]
    return cols.reshape(E, 12, 12)


def element_thermal_load_axisym(coords, C, alpha, dT_nodes):
    """Thermal expansion load fe = int B^T C (alpha dT [1,1,1,0]) dV,
    (E, 6, 2); dT_nodes (E, 6) interpolated quadratically to Gauss points."""
    dN, wdet_r, n_over_r, _ = axisym_gauss_data(coords)
    dT_g = _gauss_values(coords, dT_nodes)
    eps_th = alpha * dT_g[..., None] * _const([1.0, 1.0, 1.0, 0.0], coords)
    return _axisym_back(dN, n_over_r, _apply_C(C, eps_th), wdet_r)


def element_centrifugal_load_axisym(coords, rho_omega2):
    """Spin body-force load fe = int N rho w^2 r e_r dV, (E, 6, 2), with
    rho_omega2 = rho * omega^2."""
    _, wdet_r, _, _ = axisym_gauss_data(coords)
    n_g = _const(N_AT_GAUSS, coords)  # (3, 6)
    r_g = _gauss_values(coords, coords[:, :, 0])  # (E, 3)
    fe_r = rho_omega2 * ((r_g * wdet_r) @ n_g)
    return torch.stack([fe_r, torch.zeros_like(fe_r)], dim=-1)


def element_strain_stress_axisym(coords, C, ue, alpha=0.0, dT_nodes=None):
    """Per-gauss-point axisymmetric (strain, stress), each (E, 3, 4),
    stress = C (strain - strain_thermal)."""
    dN, _wdet_r, n_over_r, _ = axisym_gauss_data(coords)
    strain = _axisym_strain(dN, n_over_r, ue)
    mech = strain
    if dT_nodes is not None:
        dT_g = _gauss_values(coords, dT_nodes)
        mech = strain - alpha * dT_g[..., None] * _const([1.0, 1.0, 1.0, 0.0], coords)
    return strain, _apply_C(C, mech)


def von_mises_axisym(stress):
    """Von Mises from Voigt [rr, zz, tt, rz] stresses (..., 4)."""
    srr, szz, stt, srz = stress[..., 0], stress[..., 1], stress[..., 2], stress[..., 3]
    return torch.sqrt(
        0.5 * ((srr - szz) ** 2 + (szz - stt) ** 2 + (stt - srr) ** 2)
        + 3.0 * srz**2
    )


# Exact consistent-mass constant Mhat[i,j] = (1/A) int N_i N_j dA over a
# straight-sided Tri6, from int L1^a L2^b L3^c dA = 2A a! b! c! / (a+b+c+2)!.
def _mass_matrix_hat() -> np.ndarray:
    from math import factorial

    def corner(i):
        e2 = [0, 0, 0]
        e2[i] = 2
        e1 = [0, 0, 0]
        e1[i] = 1
        return {tuple(e2): 2.0, tuple(e1): -1.0}

    def edge(i, j):
        e = [0, 0, 0]
        e[i] += 1
        e[j] += 1
        return {tuple(e): 4.0}

    shapes = [corner(i) for i in range(3)] + [edge(0, 1), edge(1, 2), edge(2, 0)]

    def integral(mono):
        s = sum(mono)
        num = 2.0
        for e in mono:
            num *= factorial(e)
        return num / factorial(s + 2)

    M = np.zeros((6, 6))
    for i in range(6):
        for j in range(i, 6):
            acc = 0.0
            for ei, ci in shapes[i].items():
                for ej, cj in shapes[j].items():
                    acc += ci * cj * integral(tuple(a + b for a, b in zip(ei, ej)))
            M[i, j] = M[j, i] = acc
    return M


MASS_HAT = _mass_matrix_hat()  # (6, 6)


def element_area(coords: torch.Tensor) -> torch.Tensor:
    """Signed areas of straight triangles from their 3 corner nodes (E,)."""
    v1 = coords[:, 1, :] - coords[:, 0, :]
    v2 = coords[:, 2, :] - coords[:, 0, :]
    return 0.5 * (v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])
