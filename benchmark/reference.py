"""Plain reference of the solid box configurations: mesh, stiffness, loads,
supports and the checks that decide `correct`.

It imports torch and numpy only, and nothing of the program. From the
configuration alone it builds the box mesh (a lattice of hexahedral cells,
each cut into the 6 tetrahedra of its (0,0,0)-(1,1,1) diagonal, promoted to
10-node quadratic tetrahedra), every element stiffness matrix (4-point Gauss
rule, isotropic material) and the load and support vectors; it then judges
displacements and reactions that the program produced, given with the
coordinates of the program's nodes, which map them onto the reference's
lattice.

Numbers a run compares (each against a limit of benchmark/limits):
  residual  ||(f - K u) on the free DOFs|| / ||f||, K u in float64;
  support   max |u| over the supported DOFs / max |u|;
  reaction  ||R - (K u) on the supported DOFs|| / ||f||, R the program's
            reactions (whole analyses only).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch

F64 = torch.float64

# 4-point Gauss rule on the unit tetrahedron (volume 1/6): barycentric
# points (a, b, b, b) and permutations, weight 1/24 each.
_GA = (5.0 + 3.0 * 5.0 ** 0.5) / 20.0
_GB = (5.0 - 5.0 ** 0.5) / 20.0
GAUSS_BARY = np.array([[_GA, _GB, _GB, _GB], [_GB, _GA, _GB, _GB],
                       [_GB, _GB, _GA, _GB], [_GB, _GB, _GB, _GA]])
GAUSS_WEIGHT = 1.0 / 24.0
# the reference's own node order: 4 corners, then the midpoints of these edges
EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


class Lattice:
    """The box's half-spaced lattice: every node of the quadratic mesh sits
    at an integer position of a grid (2 nx + 1, 2 ny + 1, 2 nz + 1) with
    step h / 2; the reference numbers nodes in raster order of it."""

    def __init__(self, dims: Sequence[float], cells: Sequence[int]):
        self.cells = tuple(int(c) for c in cells)
        self.half = np.asarray(dims, dtype=np.float64) / np.asarray(self.cells) / 2.0
        self.shape = tuple(2 * c + 1 for c in self.cells)
        self.num_nodes = int(np.prod(self.shape))

    def points(self) -> np.ndarray:
        axes = [np.arange(s) * hh for s, hh in zip(self.shape, self.half)]
        g = np.meshgrid(*axes, indexing="ij")
        return np.stack([a.reshape(-1) for a in g], axis=1)

    def index_of(self, xyz) -> np.ndarray:
        """Raster index of each point, which must lie on the lattice (to
        1e-6 of a half step); raises otherwise."""
        xyz = np.atleast_2d(np.asarray(xyz, dtype=np.float64))
        t = xyz / self.half
        p = np.rint(t)
        if np.abs(t - p).max(initial=0.0) > 1e-6:
            raise ValueError("a point lies off the mesh's lattice")
        p = p.astype(np.int64)
        if (p < 0).any() or (p >= np.asarray(self.shape)).any():
            raise ValueError("a point lies outside the box")
        return (p[:, 0] * self.shape[1] + p[:, 1]) * self.shape[2] + p[:, 2]

    def connectivity(self) -> np.ndarray:
        """(6 cells, 10) node indices: for each cell and each ordering of the
        three axes, the monotone path of corners from (0,0,0) to (1,1,1);
        corners 0..3 positively oriented, then the 6 edge midpoints."""
        nx, ny, nz = self.cells
        cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
        base = np.stack([cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)], axis=1) * 2
        blocks = []
        for order in itertools.permutations(range(3)):
            corner = np.zeros((4, 3), dtype=np.int64)
            for k, axis in enumerate(order):
                corner[k + 1:, axis] += 2
            e = corner[1:] - corner[0]
            if np.linalg.det(e.astype(np.float64)) < 0:
                corner = corner[[0, 2, 1, 3]]
            mids = np.stack([(corner[a] + corner[b]) // 2 for a, b in EDGES])
            local = np.concatenate([corner, mids])  # (10, 3)
            p = base[:, None, :] + local[None, :, :]
            blocks.append((p[..., 0] * self.shape[1] + p[..., 1]) * self.shape[2] + p[..., 2])
        return np.concatenate(blocks).astype(np.int64)


def shape_gradients_natural() -> np.ndarray:
    """(4 Gauss points, 3, 10) derivatives of the quadratic shape functions
    (corners L(2L - 1), edges 4 La Lb) by the natural coordinates
    (L1, L2, L3), with L0 = 1 - L1 - L2 - L3."""
    out = np.zeros((4, 3, 10))
    for g, L in enumerate(GAUSS_BARY):
        dN_dL = np.zeros((4, 10))  # by the 4 barycentric coordinates
        for i in range(4):
            dN_dL[i, i] = 4.0 * L[i] - 1.0
        for k, (a, b) in enumerate(EDGES):
            dN_dL[a, 4 + k] = 4.0 * L[b]
            dN_dL[b, 4 + k] = 4.0 * L[a]
        out[g] = dN_dL[1:] - dN_dL[0]  # chain rule through L0
    return out


def elasticity(E: float, nu: float) -> np.ndarray:
    """(6, 6) isotropic stiffness on strains (xx, yy, zz, 2xy, 2yz, 2zx)."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] += 2.0 * mu
    C[np.arange(3, 6), np.arange(3, 6)] = mu
    return C


def element_stiffness(coords: torch.Tensor, E: float, nu: float) -> torch.Tensor:
    """(B, 30, 30) stiffness of B elements from their (B, 10, 3) node
    coordinates, DOFs ordered (node, component)."""
    dev = coords.device
    dNn = torch.as_tensor(shape_gradients_natural(), dtype=F64, device=dev)
    C = torch.as_tensor(elasticity(E, nu), dtype=F64, device=dev)
    nb = coords.shape[0]
    K = torch.zeros((nb, 30, 30), dtype=F64, device=dev)
    for g in range(4):
        J = torch.einsum("kn,bnc->bkc", dNn[g], coords)  # d x_c / d xi_k
        det = torch.linalg.det(J)
        dN = torch.linalg.solve(J, dNn[g].expand(nb, 3, 10))  # d N / d x
        B = torch.zeros((nb, 6, 10, 3), dtype=F64, device=dev)
        B[:, 0, :, 0] = dN[:, 0]
        B[:, 1, :, 1] = dN[:, 1]
        B[:, 2, :, 2] = dN[:, 2]
        B[:, 3, :, 0], B[:, 3, :, 1] = dN[:, 1], dN[:, 0]
        B[:, 4, :, 1], B[:, 4, :, 2] = dN[:, 2], dN[:, 1]
        B[:, 5, :, 0], B[:, 5, :, 2] = dN[:, 2], dN[:, 0]
        B = B.reshape(nb, 6, 30)
        K += (GAUSS_WEIGHT * det)[:, None, None] * (B.transpose(1, 2) @ C @ B)
    return K


def box_cells(config: dict) -> tuple:
    """Cells along x, y, z of the configuration's box: its dimensions over
    its mesh size, rounded, at least 1 (the box generator's rule)."""
    dims = np.asarray(config["box"]["dims_m"], dtype=np.float64)
    n = np.maximum(1, np.round(dims / float(config["mesh_size_m"])).astype(int))
    return tuple(int(v) for v in n)


class BoxModel:
    """The configuration's box, worked out by the reference: lattice,
    elements, stiffness matrices, supports. Stiffness is kept per element
    on `device` in float64 and applied block by block."""

    def __init__(self, config: dict, device="cpu", block: int = 65536):
        self.lattice = Lattice(config["box"]["dims_m"], box_cells(config))
        self.E = float(config["material"]["E_pa"])
        self.nu = float(config["material"]["nu"])
        self.device = torch.device(device)
        self.block = int(block)
        self.points = self.lattice.points()
        conn = self.lattice.connectivity()
        self.conn = torch.as_tensor(conn, device=self.device)
        pts = torch.as_tensor(self.points, dtype=F64, device=self.device)
        self.Ke = torch.cat([element_stiffness(pts[self.conn[i:i + self.block]], self.E, self.nu)
                             for i in range(0, len(conn), self.block)])
        d = torch.arange(3, device=self.device)
        self.dofs = (3 * self.conn[:, :, None] + d).reshape(len(conn), 30)
        fixes = [(s["x"], s["y"], s["z"]) for s in config["supports"]]
        nodes = self.lattice.index_of(fixes)
        self.fixed = np.unique((3 * nodes[:, None] + np.arange(3)).reshape(-1))
        self.ndof = 3 * self.lattice.num_nodes

    def apply(self, u: np.ndarray) -> np.ndarray:
        """K u in float64 on the reference's node order."""
        ut = torch.as_tensor(u, dtype=F64, device=self.device)
        y = torch.zeros(self.ndof, dtype=F64, device=self.device)
        for i in range(0, self.Ke.shape[0], self.block):
            d = self.dofs[i:i + self.block]
            y.index_add_(0, d.reshape(-1), torch.bmm(self.Ke[i:i + self.block],
                                                    ut[d].unsqueeze(-1)).reshape(-1))
        return y.cpu().numpy()

    def loads(self, forces: List[dict]) -> np.ndarray:
        """The load vector of point loads, each at the lattice node of its
        position."""
        f = np.zeros(self.ndof)
        for item in forces:
            n = int(self.lattice.index_of([(item["x"], item["y"], item["z"])])[0])
            f[3 * n:3 * n + 3] += (item["fx"], item["fy"], item["fz"])
        return f

    def order_of(self, program_points: np.ndarray) -> np.ndarray:
        """For each of the program's nodes, the reference's index of the
        node at the same coordinates; raises unless the program's nodes are
        exactly the reference's, each once."""
        idx = self.lattice.index_of(program_points)
        if len(idx) != self.lattice.num_nodes or len(np.unique(idx)) != len(idx):
            raise ValueError("the program's nodes are not the box's lattice")
        if np.abs(self.points[idx] - program_points).max() > 1e-9 * self.lattice.half.max():
            raise ValueError("the program's node coordinates differ from the box's")
        return idx

    def to_reference(self, v_program: np.ndarray, order: np.ndarray) -> np.ndarray:
        """A (3N,) vector of the program's node order in the reference's."""
        out = np.empty(self.ndof)
        out.reshape(-1, 3)[order] = np.asarray(v_program, dtype=np.float64).reshape(-1, 3)
        return out

    def judge(self, forces: List[dict], u: np.ndarray,
              reactions: np.ndarray = None) -> Dict[str, float]:
        """The numbers compared for one answer: u (and the program's
        reactions R) in the reference's node order."""
        f = self.loads(forces)
        Ku = self.apply(u)
        free = np.ones(self.ndof, dtype=bool)
        free[self.fixed] = False
        fnorm = float(np.linalg.norm(f))
        out = {"residual": float(np.linalg.norm((f - Ku)[free])) / fnorm,
               "support": float(np.abs(u[self.fixed]).max() / max(np.abs(u).max(), 1e-300))}
        if reactions is not None:
            out["reaction"] = float(np.linalg.norm(reactions[self.fixed] - Ku[self.fixed])) / fnorm
        return out
