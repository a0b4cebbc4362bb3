"""Gather-free structured-grid stiffness operator (PyTorch port of
femx/assembly_structured.py).

On femx's structured Kuhn mesh the Tetra10 node set is exactly the
half-spaced lattice (StructuredBoxInfo), so K @ u becomes:

  1. a gather of the 27 cell-local lattice slots x 3 components of every
     cell from 8 parity-phase subgrids, and ONE constant 81x81 cell-stiffness
     matmul against the (81, n_cells) result — the hand-written kernel
     femx_torch.elements.cell_matmul.structured_cell_matmul on the card;
  2. an overlap-add of the 27 slot results back onto the phase grids
     (torch slice adds).

The operator runs in its own internal DOF ordering (phase-major,
component-major); `to_internal` / `to_global` convert once per solve on the
host. The 81x81 cell matrix is assembled once on the host in float64 from the
6 Tetra10 elements of a single cell. Setup-stage data (cell matrix, masks,
block-Jacobi blocks) is host numpy; only what the apply uses per iteration
lives on the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from femx_torch.config import numpy_dtype, resolve_device, torch_dtype
from femx_torch.elements.cell_matmul import (
    _SLOTS, phase_offsets, phase_shapes, split_phases, structured_cell_matmul)
from femx_torch.elements.tet10 import (
    DN_NATURAL, GAUSS_WEIGHT_CORRECT, MASS_HAT, _SEL, material_matrix)

__all__ = ["StructuredSolidOperator", "StructuredBlockJacobi", "constrained_block_inverse"]


def _cell_stiffness(spacing, E_mod, nu, weight, dtype) -> np.ndarray:
    """Exact (81, 81) stiffness of one structured cell (6 Tet10 elements),
    in raster order of the 27 cell-local lattice slots x 3 components.
    Host numpy in float64, cast to `dtype` at the end."""
    from femx_torch.mesh.generators import box_tet10

    hx, hy, hz = spacing
    cell = box_tet10(hx, hy, hz, mesh_size=max(spacing) * 1.01)
    if cell.num_nodes != 27:
        raise ValueError(f"single-cell mesh has {cell.num_nodes} nodes, not 27")
    pts = np.asarray(cell.points, dtype=np.float64)
    conn = np.asarray(cell.cells["tetra10"])  # (6, 10)
    C = material_matrix(E_mod, nu)
    chat = np.einsum("ack,ab,bdl->ckdl", _SEL, C, _SEL)
    coords = pts[conn]  # (6, 10, 3)
    J = np.einsum("gkn,enc->egkc", DN_NATURAL, coords)
    Jinv = np.linalg.inv(J)
    detJ = np.linalg.det(J)
    dN = np.einsum("egkc,gcn->egkn", Jinv, DN_NATURAL)
    wdet = np.where(detJ > 1e-12, detJ, 0.0)
    ke = np.einsum("egki,ckdl,eglj,eg->eicjd", dN, chat, dN,
                   float(weight) * wdet).reshape(6, 30, 30)
    edof = (3 * conn[:, :, None] + np.arange(3)).reshape(6, 30)
    K = np.zeros((81, 81))
    np.add.at(K, (edof[:, :, None], edof[:, None, :]), ke)
    K = 0.5 * (K + K.T)  # exact symmetry before a low-precision cast
    return K.astype(dtype)


def _cell_lumped_mass(spacing, rho) -> np.ndarray:
    """(27,) HRZ-lumped nodal masses of one structured cell (6 straight
    Tet10 elements), raster slot order, host float64. Exact per-cell total:
    rho * hx*hy*hz."""
    from femx_torch.mesh.generators import box_tet10

    hx, hy, hz = (float(s) for s in spacing)
    cell = box_tet10(hx, hy, hz, mesh_size=max(hx, hy, hz) * 1.01)
    if cell.num_nodes != 27:
        raise ValueError(f"single-cell mesh has {cell.num_nodes} nodes, not 27")
    conn = np.asarray(cell.cells["tetra10"])  # (6, 10)
    pts = np.asarray(cell.points, dtype=np.float64)
    c0 = pts[conn[:, 0]]
    vol = np.abs(np.einsum("ei,ei->e", pts[conn[:, 1]] - c0,
                           np.cross(pts[conn[:, 2]] - c0, pts[conn[:, 3]] - c0))) / 6.0
    frac = np.diag(MASS_HAT) / np.diag(MASS_HAT).sum()  # (10,), sums to 1
    lumped = float(rho) * vol[:, None] * frac[None, :]  # (6, 10)
    out = np.zeros(27)
    np.add.at(out, conn.reshape(-1), lumped.reshape(-1))
    return out


def _inv3x3_np(A: np.ndarray) -> np.ndarray:
    """Vectorized closed-form 3x3 inverse (cofactor columns) for (N, 3, 3);
    np.linalg.inv loops LAPACK per matrix, ~100x slower at 463k blocks."""
    a, b, c = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    cb = np.cross(b, c)
    ca = np.cross(c, a)
    ab = np.cross(a, b)
    det = np.einsum("...i,...i->...", a, cb)
    return np.stack([cb, ca, ab], axis=-1) / det[..., None, None]


def _device_array(x, dtype: torch.dtype, device: torch.device):
    """A copy of host array x as a tensor (None stays None)."""
    return None if x is None else torch.tensor(np.asarray(x), dtype=dtype, device=device)


@dataclasses.dataclass(eq=False)
class StructuredSolidOperator:
    """Matrix-free K for a structured box Tetra10 mesh.

    Operates on an internal phase-major flat DOF vector; `to_internal` /
    `to_global` convert between mesh node order (lattice raster,
    femx_torch.mesh.box_tet10) and the internal layout. Device tensors
    (Kcell, free_mask, layer weights) sit on one device; `Kcell_host` and
    `free_mask_host` are their host numpy copies for setup-stage math.

    x/y/z_weight: optional per-layer cell weights ((nx,), (ny,), (nz,)):
    cell (i, j, k) contributes x_weight[i] * y_weight[j] * z_weight[k] *
    Kcell. The ghost-padded coarse levels of StructuredMultigrid use them to
    give fully-ghost cell layers zero stiffness. None means all ones.
    """

    Kcell: torch.Tensor  # (81, 81)
    n_cells: Tuple[int, int, int]
    grid_shape: Tuple[int, int, int]
    weight: float
    Kcell_host: np.ndarray = dataclasses.field(repr=False)
    free_mask: Optional[torch.Tensor] = None  # internal layout
    free_mask_host: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    spacing: Optional[Tuple[float, float, float]] = None
    x_weight: Optional[torch.Tensor] = None
    y_weight: Optional[torch.Tensor] = None
    z_weight: Optional[torch.Tensor] = None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_host(cls, Kcell, n_cells, weight, spacing=None, free_mask=None,
                  x_weight=None, y_weight=None, z_weight=None, device=None):
        """Build from host arrays: Kcell (81, 81) sets the dtype; the other
        arrays are cast to it. The device tensors go to `device`."""
        dev = resolve_device(device)
        Kc = np.array(Kcell, order="C")  # owned copy: the tensor shares it on the CPU
        dt = torch_dtype(Kc.dtype)
        n = tuple(int(v) for v in n_cells)
        mask = None if free_mask is None else np.asarray(free_mask).astype(Kc.dtype)
        return cls(
            Kcell=torch.as_tensor(Kc, device=dev),
            n_cells=n,
            grid_shape=tuple(2 * c + 1 for c in n),
            weight=float(weight),
            Kcell_host=Kc,
            free_mask=_device_array(mask, dt, dev),
            free_mask_host=mask,
            spacing=None if spacing is None else tuple(float(s) for s in spacing),
            x_weight=_device_array(x_weight, dt, dev),
            y_weight=_device_array(y_weight, dt, dev),
            z_weight=_device_array(z_weight, dt, dev),
        )

    @classmethod
    def from_mesh(cls, mesh, E_mod, nu, weight=None, dtype=np.float32, device=None):
        info = mesh.structured
        if info is None:
            raise ValueError("Mesh has no structured-lattice metadata")
        return cls.from_lattice(info.n_cells, info.spacing, E_mod, nu,
                                weight=weight, dtype=dtype, device=device)

    @classmethod
    def from_lattice(cls, n_cells, spacing, E_mod, nu, weight=None,
                     dtype=np.float32, device=None):
        """Build directly from (n_cells, spacing): the operator is fully
        determined by the cell stiffness and the lattice extents."""
        if weight is None:
            weight = GAUSS_WEIGHT_CORRECT
        sp = tuple(float(s) for s in spacing)
        Kc = _cell_stiffness(sp, E_mod, nu, weight, numpy_dtype(dtype))
        return cls.from_host(Kc, n_cells, weight, spacing=sp, device=device)

    def coarsened(self) -> "StructuredSolidOperator":
        """The operator on the lattice coarsened 2x along every axis. The
        cell stiffness rescales exactly: under x -> 2x, B -> B/2 and
        dV -> 8 dV, so K -> 2K."""
        n = tuple(c // 2 for c in self.n_cells)
        if any(2 * c != cf for c, cf in zip(n, self.n_cells)):
            raise ValueError(f"cell counts {self.n_cells} not divisible by 2")
        return StructuredSolidOperator.from_host(
            2.0 * self.Kcell_host, n, self.weight,
            spacing=None if self.spacing is None
            else tuple(2.0 * s for s in self.spacing),
            device=self.device)

    # -- layout bookkeeping --------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.Kcell.device

    @property
    def dtype(self) -> np.dtype:
        return self.Kcell_host.dtype

    @property
    def ndof(self) -> int:
        P = self.grid_shape
        return 3 * P[0] * P[1] * P[2]

    @property
    def n_nodes(self) -> int:
        return self.ndof // 3

    def _phase_shapes(self) -> List[Tuple[int, int, int]]:
        return phase_shapes(self.n_cells)

    def _phase_offsets(self) -> List[int]:
        return phase_offsets(self.n_cells)

    def _permutation(self) -> np.ndarray:
        """perm[internal_idx] = global dof index (3*node + comp), where node
        ids are the mesher's lattice raster order."""
        Px, Py, Pz = self.grid_shape
        perm = np.empty(self.ndof, dtype=np.int64)
        pos = 0
        for px in (0, 1):
            for py in (0, 1):
                for pz in (0, 1):
                    P_, Q_, R_ = np.meshgrid(np.arange(px, Px, 2), np.arange(py, Py, 2),
                                             np.arange(pz, Pz, 2), indexing="ij")
                    nodes = ((P_ * Py + Q_) * Pz + R_).ravel()
                    for comp in range(3):
                        perm[pos:pos + nodes.size] = 3 * nodes + comp
                        pos += nodes.size
        return perm

    @functools.cached_property
    def _perm(self) -> np.ndarray:
        return self._permutation()

    def to_internal(self, x: np.ndarray) -> np.ndarray:
        """Global (3*node+comp) vector -> internal phase-major vector (host)."""
        return np.asarray(x)[self._perm]

    def to_global(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y)
        out = np.empty_like(y)
        out[self._perm] = y
        return out

    def _with(self, **changes) -> "StructuredSolidOperator":
        out = dataclasses.replace(self, **changes)
        if "_perm" in self.__dict__:  # same lattice: share the cached permutation
            out._perm = self._perm
        return out

    def astype(self, dtype) -> "StructuredSolidOperator":
        """The same operator with every array cast to `dtype` (from the host
        copies). Builds the float64 residual operator of mixed-precision
        refinement (femx_torch.solve.cg.pcg_refined)."""
        dt = numpy_dtype(dtype)
        if dt == self.dtype:
            return self
        tdt = torch_dtype(dt)
        Kc = self.Kcell_host.astype(dt)
        mask = None if self.free_mask_host is None else self.free_mask_host.astype(dt)

        def cast(w):
            return None if w is None else w.to(tdt)

        return self._with(
            Kcell=torch.as_tensor(Kc, device=self.device), Kcell_host=Kc,
            free_mask=_device_array(mask, tdt, self.device), free_mask_host=mask,
            x_weight=cast(self.x_weight), y_weight=cast(self.y_weight),
            z_weight=cast(self.z_weight))

    def with_free_mask(self, free_mask_internal: np.ndarray) -> "StructuredSolidOperator":
        """The operator with a 1/0 free-DOF mask (internal layout, host)."""
        mask = np.asarray(free_mask_internal).astype(self.dtype)
        return self._with(free_mask=_device_array(mask, self.Kcell.dtype, self.device),
                          free_mask_host=mask)

    # -- core ---------------------------------------------------------------
    def _split_phases(self, u: torch.Tensor) -> List[torch.Tensor]:
        return split_phases(u, self.n_cells)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u (internal layout): gather + cell matmul (the kernel on the
        card), the layer weights, then the overlap-add."""
        nx, ny, nz = self.n_cells
        fe = structured_cell_matmul(u, self.Kcell, self.n_cells).view(27, 3, nx, ny, nz)
        # layer weights act on the cell results, after the matmul
        if self.x_weight is not None:
            fe = fe * self.x_weight[:, None, None]
        if self.y_weight is not None:
            fe = fe * self.y_weight[:, None]
        if self.z_weight is not None:
            fe = fe * self.z_weight
        return self._overlap_add(fe)

    def _overlap_add(self, fe: torch.Tensor) -> torch.Tensor:
        """Add each slot's (3, nx, ny, nz) cell results onto its phase grid
        at the slot's offset, in slot order (femx sums the same padded
        slices in the same order)."""
        nx, ny, nz = self.n_cells
        out = torch.zeros(self.ndof, dtype=fe.dtype, device=fe.device)
        phases = split_phases(out, self.n_cells)
        for s, (a, b, c) in enumerate(_SLOTS):
            pidx = (a % 2) * 4 + (b % 2) * 2 + (c % 2)
            ia, jb, kc = a // 2, b // 2, c // 2
            phases[pidx][:, ia:ia + nx, jb:jb + ny, kc:kc + nz] += fe[s]
        return out

    def apply_constrained(self, u: torch.Tensor) -> torch.Tensor:
        s = self.free_mask
        v = self.apply(u * s) * s
        return v + u * (1.0 - s)

    def _cell_weight_host(self) -> Optional[np.ndarray]:
        """(nx, ny, nz) combined per-cell weight on host, or None if all-ones."""
        if self.x_weight is None and self.y_weight is None and self.z_weight is None:
            return None

        def ax(w, n):
            return np.ones(n) if w is None else w.cpu().numpy().astype(np.float64)

        nx, ny, nz = self.n_cells
        return (ax(self.x_weight, nx)[:, None, None]
                * ax(self.y_weight, ny)[None, :, None]
                * ax(self.z_weight, nz)[None, None, :])

    # -- preconditioning ----------------------------------------------------
    def block_diagonal_internal(self) -> np.ndarray:
        """(n_nodes, 3, 3) nodal diagonal blocks, nodes in internal order
        (host numpy)."""
        nx, ny, nz = self.n_cells
        Kc = self.Kcell_host.reshape(27, 3, 27, 3)
        cw = self._cell_weight_host()
        grids = [np.zeros((s[0], s[1], s[2], 3, 3), dtype=Kc.dtype)
                 for s in self._phase_shapes()]
        for s, (a, b, c) in enumerate(_SLOTS):
            pidx = (a % 2) * 4 + (b % 2) * 2 + (c % 2)
            ia, jb, kc = a // 2, b // 2, c // 2
            contrib = Kc[s, :, s, :]
            if cw is not None:
                contrib = cw[:, :, :, None, None] * contrib
            grids[pidx][ia:ia + nx, jb:jb + ny, kc:kc + nz] += contrib
        return np.concatenate([g.reshape(-1, 3, 3) for g in grids])

    def diagonal(self) -> np.ndarray:
        """diag(K) in internal layout (components grouped per phase), host
        numpy."""
        bd = self.block_diagonal_internal()
        parts = []
        pos = 0
        for s in self._phase_shapes():
            cnt = s[0] * s[1] * s[2]
            blk = bd[pos:pos + cnt]
            pos += cnt
            parts.append(np.stack([blk[:, c, c] for c in range(3)]).reshape(-1))
        return np.concatenate(parts)

    def constrained_diagonal(self) -> np.ndarray:
        """diag of the constrained operator: diag(K) on free DOFs, 1 on
        fixed ones (host numpy)."""
        s = self.free_mask_host
        return self.diagonal() * s + (1.0 - s)

    def lumped_mass_diagonal(self, rho: float) -> np.ndarray:
        """(ndof,) HRZ-lumped mass diagonal, internal layout, host float64.

        Every cell contributes the same (27,) slot masses, scaled by its
        layer weights, so assembly is one overlap-add per slot. Total mass
        is rho * box volume per component."""
        if self.spacing is None:
            raise ValueError("operator has no spacing metadata (needed for mass)")
        nx, ny, nz = self.n_cells
        mcell = _cell_lumped_mass(self.spacing, rho)
        cw = self._cell_weight_host()
        cw = 1.0 if cw is None else cw
        grids = [np.zeros(s) for s in self._phase_shapes()]
        for s_idx, (a, b, c) in enumerate(_SLOTS):
            pidx = (a % 2) * 4 + (b % 2) * 2 + (c % 2)
            ia, jb, kc = a // 2, b // 2, c // 2
            grids[pidx][ia:ia + nx, jb:jb + ny, kc:kc + nz] += mcell[s_idx] * cw
        return np.concatenate([np.broadcast_to(g, (3,) + g.shape).reshape(-1) for g in grids])

    def block_jacobi_tensors(self) -> List[np.ndarray]:
        """Per-phase (3, 3, cnt) inverse nodal blocks (host numpy, once)."""
        bd = self.block_diagonal_internal()
        offs = self._phase_offsets()
        mask = self.free_mask_host
        mask3 = np.concatenate([
            mask[offs[i]:offs[i + 1]].reshape(3, -1).T for i in range(8)
        ])  # (n_nodes, 3) in internal node order
        binv = constrained_block_inverse(bd, mask3)
        out = []
        node_pos = 0
        for s in self._phase_shapes():
            cnt = s[0] * s[1] * s[2]
            out.append(np.ascontiguousarray(
                np.transpose(binv[node_pos:node_pos + cnt], (1, 2, 0))))
            node_pos += cnt
        return out

    def apply_block_jacobi(self, binv_phases: Sequence[torch.Tensor],
                           r: torch.Tensor) -> torch.Tensor:
        """r -> M^-1 r given `block_jacobi_tensors` output on r's device."""
        offs = self._phase_offsets()
        outs = []
        for i in range(8):
            rp = r[offs[i]:offs[i + 1]].reshape(3, -1)
            B = binv_phases[i]
            # row i: B[i,0] r0 + B[i,1] r1 + B[i,2] r2, the reference's order
            outs.append((B[:, 0] * rp[0] + B[:, 1] * rp[1] + B[:, 2] * rp[2]).reshape(-1))
        return torch.cat(outs)


class StructuredBlockJacobi:
    """The structured operator's block-Jacobi preconditioner r -> M^-1 r:
    its per-phase inverse blocks on the operator's device (femx keeps them
    as the ("st_bj", tensors) pair that solve_cases and modal dispatch on)."""

    def __init__(self, op: StructuredSolidOperator):
        self.op = op
        self.tensors = [torch.as_tensor(b, device=op.device)
                        for b in op.block_jacobi_tensors()]

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.op.apply_block_jacobi(self.tensors, r)


def constrained_block_inverse(bd: np.ndarray, mask3: np.ndarray) -> np.ndarray:
    """Invert per-node 3x3 diagonal blocks under a DOF mask (host, once).

    Masked rows/columns are zeroed and fixed diagonal entries replaced by
    identity before inversion, so fixed DOFs map r -> r and free DOFs get the
    constrained block inverse. bd (n, 3, 3) nodal blocks; mask3 (n, 3) 1/0."""
    blk = bd.copy()
    blk *= mask3[:, :, None] * mask3[:, None, :]
    blk += (1.0 - mask3)[:, :, None] * np.eye(3, dtype=bd.dtype)
    return _inv3x3_np(blk)
