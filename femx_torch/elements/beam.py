"""3D Timoshenko frame element (port of femx/elements/beam.py).

The reference's beam element (BeamSolver.py:646-675) plus the consistent
mass matrix the reference lacks, as batched torch functions: every argument
may carry leading element axes, and the 12x12 matrices come out with them.
The stiffness is one matmul of the (..., 10) scalar components against the
constant placement matrix ``_K_PLACE`` (144 x 10), with femx's ``_safe_div``
zero-guards, so degenerate members (L = 0, A = 0) give a zero matrix, not
NaNs.

Local DOF order per element (the reference's):
  [ux1, uy1, uz1, rx1, ry1, rz1, ux2, uy2, uz2, rx2, ry2, rz2]
"""

from __future__ import annotations

import numpy as np
import torch

# Component order of the stiffness placement:
#   0: EA/L       1: GJ/L
#   2: k11_z  3: k12_z  4: k22_z  5: k23_z      (bending, local xy-plane)
#   6: k11_y  7: k12_y  8: k22_y  9: k23_y      (bending, local xz-plane)
# Entries (i, j, comp, sign) transcribe the standard 3D Timoshenko stiffness
# (BeamSolver.py:654-660).
_K_ENTRIES = [
    (0, 0, 0, +1), (0, 6, 0, -1), (6, 0, 0, -1), (6, 6, 0, +1),           # axial
    (3, 3, 1, +1), (3, 9, 1, -1), (9, 3, 1, -1), (9, 9, 1, +1),           # torsion
    # xy-plane bending: DOFs (uy1=1, rz1=5, uy2=7, rz2=11)
    (1, 1, 2, +1), (1, 5, 3, +1), (1, 7, 2, -1), (1, 11, 3, +1),
    (5, 1, 3, +1), (5, 5, 4, +1), (5, 7, 3, -1), (5, 11, 5, +1),
    (7, 1, 2, -1), (7, 5, 3, -1), (7, 7, 2, +1), (7, 11, 3, -1),
    (11, 1, 3, +1), (11, 5, 5, +1), (11, 7, 3, -1), (11, 11, 4, +1),
    # xz-plane bending: DOFs (uz1=2, ry1=4, uz2=8, ry2=10); rotation sign flipped
    (2, 2, 6, +1), (2, 4, 7, -1), (2, 8, 6, -1), (2, 10, 7, -1),
    (4, 2, 7, -1), (4, 4, 8, +1), (4, 8, 7, +1), (4, 10, 9, +1),
    (8, 2, 6, -1), (8, 4, 7, +1), (8, 8, 6, +1), (8, 10, 7, +1),
    (10, 2, 7, -1), (10, 4, 9, +1), (10, 8, 7, +1), (10, 10, 8, +1),
]

_K_PLACE = np.zeros((144, 10))
for _i, _j, _c, _s in _K_ENTRIES:
    _K_PLACE[_i * 12 + _j, _c] = _s

# Consistent mass building blocks (classic Euler-Bernoulli consistent mass,
# Przemieniecki ch. 11): bending block in (v1, th1, v2, th2) order with the
# xy-plane sign convention; the xz-plane block is conjugated by
# diag(1, -1, 1, -1).
_M_AX = np.array([[1 / 3, 1 / 6], [1 / 6, 1 / 3]])
_MB_T = np.array(
    [
        [13 / 35, 11 / 210, 9 / 70, -13 / 420],
        [11 / 210, 1 / 105, 13 / 420, -1 / 140],
        [9 / 70, 13 / 420, 13 / 35, -11 / 210],
        [-13 / 420, -1 / 140, -11 / 210, 1 / 105],
    ]
)
_MB_R = np.array(
    [
        [6 / 5, 1 / 10, -6 / 5, 1 / 10],
        [1 / 10, 2 / 15, -1 / 10, -1 / 30],
        [-6 / 5, -1 / 10, 6 / 5, -1 / 10],
        [1 / 10, -1 / 30, -1 / 10, 2 / 15],
    ]
)
_BEND_XY = (1, 5, 7, 11)  # (uy1, rz1, uy2, rz2)
_BEND_XZ = (2, 4, 8, 10)  # (uz1, ry1, uz2, ry2)
_SIGN_XZ = np.array([1.0, -1.0, 1.0, -1.0])


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """x (a tensor, array or number) in like's dtype on its device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _lead(x) -> torch.Tensor:
    """The argument whose dtype and device the others follow: a tensor as
    it is, numbers and arrays as float64 on the CPU."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def _safe_div(num, den):
    """num / den where den > 0, else 0 (femx's zero-guard)."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _lengths(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    d = p2 - p1
    return torch.sqrt((d * d).sum(-1))


def timoshenko_stiffness(L, E, G, A, I_x, I_y, J, kappa_y, kappa_z) -> torch.Tensor:
    """(..., 12, 12) local Timoshenko stiffness (BeamSolver.py:646-660).

    Shear factors phi = 12EI/(G kappa A L^2); every term is 0 where its
    denominator is not positive. L, A, I_x, ... are tensors of one shape (the
    element axes) or numbers; E and G numbers or tensors of that shape."""
    L = _lead(L)
    L, E, G, A, I_x, I_y, J, kappa_y, kappa_z = (
        _t(v, L) for v in (L, E, G, A, I_x, I_y, J, kappa_y, kappa_z))
    phi_z = _safe_div(12.0 * E * I_y, G * kappa_y * A * L**2)
    phi_y = _safe_div(12.0 * E * I_x, G * kappa_z * A * L**2)

    def bend(I, phi):
        k11 = _safe_div(12.0 * E * I, L**3 * (1.0 + phi))
        k12 = _safe_div(6.0 * E * I, L**2 * (1.0 + phi))
        k22 = _safe_div((4.0 + phi) * E * I, L * (1.0 + phi))
        k23 = _safe_div((2.0 - phi) * E * I, L * (1.0 + phi))
        return k11, k12, k22, k23

    kz = bend(I_y, phi_z)  # local xy-plane carries I_y (reference convention)
    ky = bend(I_x, phi_y)  # local xz-plane carries I_x
    comps = torch.stack(torch.broadcast_tensors(
        _safe_div(A * E, L), _safe_div(G * J, L), *kz, *ky), dim=-1)
    return (comps @ _t(_K_PLACE, comps).T).reshape(*comps.shape[:-1], 12, 12)


def lumped_mass(L, A, I_x, I_y, J, rho) -> torch.Tensor:
    """(..., 12, 12) diagonal lumped mass (BeamSolver.py:662-675): half of
    rho*A*L at each node's translations, rotary rho*J*L/2 (torsion),
    rho*I_x*L/2, rho*I_y*L/2."""
    L = _lead(L)
    L, A, I_x, I_y, J, rho = (_t(v, L) for v in (L, A, I_x, I_y, J, rho))
    tm = rho * A * L / 2.0
    rx = rho * J * L / 2.0
    ry = rho * I_x * L / 2.0
    rz = rho * I_y * L / 2.0
    diag = torch.stack(torch.broadcast_tensors(tm, tm, tm, rx, ry, rz, tm, tm, tm, rx, ry, rz),
                       dim=-1)
    return torch.diag_embed(diag)


def consistent_mass(L, A, I_x, I_y, J, rho) -> torch.Tensor:
    """(..., 12, 12) consistent mass with rotary inertia (not in the
    reference). The torsional inertia is the POLAR moment I_x + I_y, not the
    St-Venant constant J (which belongs in the stiffness only); J is kept
    for the signature the stiffness and lumped mass share."""
    L = _lead(L)
    L, A, I_x, I_y, rho = (_t(v, L) for v in (L, A, I_x, I_y, rho))
    L, A, I_x, I_y, rho = torch.broadcast_tensors(L, A, I_x, I_y, rho)
    m = torch.zeros(*L.shape, 12, 12, dtype=L.dtype, device=L.device)
    m_ax = _t(_M_AX, L)
    for (a, b), coef in (((0, 6), rho * A * L), ((3, 9), rho * (I_x + I_y) * L)):
        ii = torch.tensor([a, b], device=L.device)
        m[..., ii[:, None], ii[None, :]] += coef[..., None, None] * m_ax

    one_l = torch.ones_like(L)
    Ls = torch.stack([one_l, L, one_l, L], dim=-1)
    scale = Ls[..., :, None] * Ls[..., None, :]
    mb_t, mb_r = _t(_MB_T, L), _t(_MB_R, L)
    for idx, I, sign in ((_BEND_XY, I_y, np.ones(4)), (_BEND_XZ, I_x, _SIGN_XZ)):
        blk = ((rho * A * L)[..., None, None] * mb_t * scale
               + (rho * I / L)[..., None, None] * mb_r * scale)
        s = _t(sign, L)
        ii = torch.tensor(idx, device=L.device)
        m[..., ii[:, None], ii[None, :]] += blk * (s[:, None] * s[None, :])
    return m


def direction_cosine_matrix(p1, p2, eps: float = 1e-6) -> torch.Tensor:
    """(..., 3, 3) direction cosines of members p1 -> p2 (..., 3).

    Branch-free version of the reference's transform, vertical-member case
    included (BeamSolver.py:378-384): where the member axis is within eps of
    global Z, lambda = [[0,0,s],[0,1,0],[-s,0,0]] with s = sign(Czx)."""
    p1 = _lead(p1)
    p2 = _t(p2, p1)
    d = p2 - p1
    L = _lengths(p1, p2)
    pos = L > 0
    dirv = torch.where(pos[..., None], d / torch.where(pos, L, torch.ones_like(L))[..., None],
                       torch.zeros_like(d))
    Cxx, Cyx, Czx = dirv[..., 0], dirv[..., 1], dirv[..., 2]
    vert = Cxx**2 + Cyx**2 < eps**2
    D = torch.sqrt(torch.clamp(Cxx**2 + Cyx**2, min=1e-300))
    zero = torch.zeros_like(D)
    lam_gen = torch.stack([
        torch.stack([Cxx, Cyx, Czx], dim=-1),
        torch.stack([-Cyx / D, Cxx / D, zero], dim=-1),
        torch.stack([-Cxx * Czx / D, -Cyx * Czx / D, D], dim=-1),
    ], dim=-2)
    s = torch.where(Czx > 0, torch.ones_like(Czx), -torch.ones_like(Czx))
    one = torch.ones_like(s)
    lam_vert = torch.stack([
        torch.stack([zero, zero, s], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([-s, zero, zero], dim=-1),
    ], dim=-2)
    return torch.where(vert[..., None, None], lam_vert, lam_gen)


def rotation_12(lam: torch.Tensor) -> torch.Tensor:
    """R = kron(I4, lambda): the (..., 12, 12) block-diagonal rotation
    (BeamSolver.py:386)."""
    R = torch.zeros(*lam.shape[:-2], 12, 12, dtype=lam.dtype, device=lam.device)
    for a in range(4):
        R[..., 3 * a:3 * a + 3, 3 * a:3 * a + 3] = lam
    return R


def _local_stiffness(p1, p2, E, G, props):
    L = _lengths(p1, p2)
    A, I_x, I_y, J, kappa_y, kappa_z = (props[..., i] for i in range(6))
    return timoshenko_stiffness(L, E, G, A, I_x, I_y, J, kappa_y, kappa_z), L


def element_matrices(p1, p2, E, G, props, rho, mass: str = "lumped"):
    """Global-frame element (ke, me, L) for members p1 -> p2 (..., 3).

    props (..., 8) = (A, I_x, I_y, J, kappa_y, kappa_z, c_y_max, c_z_max),
    the section engine's 8-tuple (BeamSolver.py:79,371). Batched over the
    leading axes, so it is also femx's ``batched_element_matrices``."""
    p1 = _lead(p1)
    p2, props = _t(p2, p1), _t(props, p1)
    k_local, L = _local_stiffness(p1, p2, E, G, props)
    mfun = lumped_mass if mass == "lumped" else consistent_mass
    m_local = mfun(L, props[..., 0], props[..., 1], props[..., 2], props[..., 3], rho)
    R = rotation_12(direction_cosine_matrix(p1, p2))
    Rt = R.transpose(-1, -2)
    return Rt @ k_local @ R, Rt @ m_local @ R, L


batched_element_matrices = element_matrices


def local_end_forces(p1, p2, E, G, props, u_element) -> torch.Tensor:
    """(..., 12) local end forces f_local = k_local @ (R @ u_e), for stress
    recovery (BeamSolver.py:425-431)."""
    p1 = _lead(p1)
    p2, props, u_element = _t(p2, p1), _t(props, p1), _t(u_element, p1)
    k_local, _ = _local_stiffness(p1, p2, E, G, props)
    R = rotation_12(direction_cosine_matrix(p1, p2))
    return (k_local @ (R @ u_element[..., None]))[..., 0]
