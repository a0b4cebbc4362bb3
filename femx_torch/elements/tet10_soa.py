"""Tetra10 kernels in structure-of-arrays (element-last) layout (port of
femx/elements/tet10_soa.py).

The arrays keep femx's layouts — coordinates (10, 3, E), global gradients
dNg (4, 3, 10, E), Jacobian factors wdet (4, E), element vectors (30, E) —
so operators carry across unchanged. femx writes the kernels as unrolled
scalar formulas over (E,)-wide vectors for XLA to fuse; run eagerly that is
~2,000 launches per apply, so here each kernel is a few einsums over the
element axis: gradient, Voigt strain, C6 @ eps, force. TF32 stays off
(femx_torch.config), so every product is a true float32/float64 product.
"""

from __future__ import annotations

import numpy as np
import torch

from femx_torch.elements.tet10 import DN_NATURAL, GAUSS_WEIGHT_CORRECT, _SEL, _const

# Voigt selector flattened over the gradient's (k, c) pair:
# eps[a] = sum_{k,c} S9[(k,c), a] grad[k][c]
_S9 = np.ascontiguousarray(np.transpose(_SEL, (2, 1, 0)).reshape(9, 6))


def chat_numpy(C: np.ndarray) -> np.ndarray:
    """Chat[c,k,d,l] = Sel[a,c,k] C[a,b] Sel[b,d,l] as a numpy constant."""
    return np.einsum("ack,ab,bdl->ckdl", _SEL, np.asarray(C, dtype=np.float64), _SEL)


def coords_soa(points: np.ndarray, conn: np.ndarray, dtype) -> np.ndarray:
    """(10, 3, E) element coordinates, element axis last, gathered from a
    transposed (3, N) copy so the element axis is written contiguously."""
    ptsT = np.ascontiguousarray(points.T.astype(dtype))  # (3, N)
    return np.ascontiguousarray(np.transpose(ptsT[:, conn.T], (1, 0, 2)))


def dof_table(conn: np.ndarray) -> np.ndarray:
    """(30, E) int32 global DOF index per (local node-major/xyz-minor) slot."""
    base = 3 * np.asarray(conn).T.astype(np.int32)  # (10, E)
    return (base[:, None, :] + np.arange(3, dtype=np.int32)[None, :, None]).reshape(30, -1)


def geometry(coords: torch.Tensor):
    """Per-Gauss-point global shape gradients and Jacobian factors, E-last.

    Args:
      coords: (10, 3, E) tensor.
    Returns:
      dNg:  (4, 3, 10, E) global gradients, zeroed where detJ <= 1e-12.
      wdet: (4, E) masked detJ (weight NOT applied).
      detJ: (4, E) raw determinants.
    """
    dn = _const(DN_NATURAL, coords)  # (4, 3, 10)
    J = torch.einsum("gkn,nce->gkce", dn, coords)  # (4, 3, 3, E)
    a, b, c = J[:, 0], J[:, 1], J[:, 2]  # rows (4, 3, E)
    cb = torch.linalg.cross(b, c, dim=1)
    ca = torch.linalg.cross(c, a, dim=1)
    ab = torch.linalg.cross(a, b, dim=1)
    det = (a * cb).sum(1)  # (4, E)
    ok = det > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    # J^-1 has the cofactor vectors as its columns: Jinv[g, k, c] = col_c[k]
    Jinv = torch.stack([cb, ca, ab], dim=2) * inv_det[:, None, None]  # (4, 3, 3, E)
    dNg = torch.einsum("gkce,gcn->gkne", Jinv, dn)
    return dNg, torch.where(ok, det, torch.zeros_like(det)), det


def apply_element_forces(dNg, wdet, C6, ue, weight=GAUSS_WEIGHT_CORRECT):
    """fe = Ke @ ue without forming Ke.

    Args:
      dNg:  (4, 3, 10, E) global gradients.
      wdet: (4, E) masked Jacobian factors.
      C6:   (6, 6) material matrix (numpy or tensor).
      ue:   (30, E) element displacements (node-major, xyz-minor).
    Returns:
      fe:   (30, E) element force contributions.
    """
    E = ue.shape[-1]
    s9 = _const(_S9, ue)
    grad = torch.einsum("gkne,nce->gkce", dNg, ue.reshape(10, 3, E))  # (4, 3, 3, E)
    eps = torch.einsum("xa,gxe->gae", s9, grad.reshape(4, 9, E))  # Voigt strain
    sig = torch.einsum("ab,gbe->gae", _const(C6, ue), eps)
    tau = torch.einsum("xa,gae->gxe", s9, sig).reshape(4, 3, 3, E) * (weight * wdet)[:, None, None]
    return torch.einsum("gkne,gkce->nce", dNg, tau).reshape(30, E)


def block_diagonal_entries(dNg, wdet, chat, weight=GAUSS_WEIGHT_CORRECT):
    """Per-element nodal 3x3 block-diagonal entries, E-last:
    bke (10, 3, 3, E) with bke[n,c,d] = Ke[(n,c),(n,d)]. chat: (3,3,3,3)
    from `chat_numpy`."""
    # P[k,l,n,e] = sum_g w wdet[g,e] dNg[g,k,n,e] dNg[g,l,n,e], then the
    # (c,d) <- (k,l) contraction with chat: two small steps, no (E, 1080)
    # intermediate
    P = torch.einsum("gkne,glne->klne", dNg * (weight * wdet)[:, None, None], dNg)
    return torch.einsum("ckdl,klne->ncde", _const(chat, dNg), P)
