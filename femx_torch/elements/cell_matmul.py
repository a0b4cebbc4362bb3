"""Gather + cell-stiffness matmul stage of the structured apply.

``structured_cell_matmul(u, kcell, n_cells)`` returns fe = Kcell @ ue with
shape (81, nx*ny*nz): ue stacks, for the 27 cell-local lattice slots of every
cell, the 3 components read from that slot's parity-phase grid of the flat
internal-layout vector u (femx_torch.assembly_structured). Cells are in
(x, y, z) raster order, z minor.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/structured_cell_matmul.cu`` (the counterpart of the TPU kernel
femx/elements/pallas_structured.py:101) and counts the launch in
``LAUNCHES``; on a CPU tensor it runs ``structured_cell_matmul_plain``, the
slot slicing + stack + matmul that is also the kernel's reference.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, Sequence, Tuple

import torch

from femx_torch import build

# The 27 cell-local slots in raster order (a-major), a,b,c in {0,1,2}:
# lattice position = cell*2 + (a,b,c). Slot s = 9a + 3b + c.
_SLOTS = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]

# Kernel launches per dtype name ("float32"/"float64"), counted only where
# the kernel is launched.
LAUNCHES: collections.Counter = collections.Counter()

_KERNEL = "structured_cell_matmul"
_FUNCS = {}


def phase_shapes(n_cells: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Node extents of the 8 parity phases, p = 4px + 2py + pz."""
    nx, ny, nz = n_cells
    return [(nx + 1 - px, ny + 1 - py, nz + 1 - pz)
            for px in (0, 1) for py in (0, 1) for pz in (0, 1)]


def phase_offsets(n_cells: Sequence[int]) -> List[int]:
    """Start of each phase in the flat vector (9 entries, last = ndof)."""
    offs = [0]
    for s in phase_shapes(n_cells):
        offs.append(offs[-1] + 3 * s[0] * s[1] * s[2])
    return offs


def split_phases(u: torch.Tensor, n_cells) -> List[torch.Tensor]:
    """The flat vector as the 8 (3, sx, sy, sz) phase grids (views when u is
    contiguous)."""
    offs = phase_offsets(n_cells)
    return [u[offs[i]:offs[i + 1]].reshape(3, *s)
            for i, s in enumerate(phase_shapes(n_cells))]


def structured_cell_matmul_plain(u: torch.Tensor, kcell: torch.Tensor,
                                 n_cells) -> torch.Tensor:
    """Reference version: slot slices of the phase grids stacked to
    ue (81, C), then Kcell @ ue."""
    nx, ny, nz = n_cells
    phases = split_phases(u, n_cells)
    slots = [phases[(a % 2) * 4 + (b % 2) * 2 + (c % 2)]
             [:, a // 2:a // 2 + nx, b // 2:b // 2 + ny, c // 2:c // 2 + nz]
             for (a, b, c) in _SLOTS]
    ue = torch.stack(slots).reshape(81, nx * ny * nz)
    return kcell @ ue


def _kernel_fn(dtype: torch.dtype):
    if dtype not in _FUNCS:
        suffix = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(build.load(_KERNEL), f"femx_structured_cell_matmul_{suffix}")
        # pointers and the stream as c_void_p: without argtypes ctypes would
        # pass them as 32-bit ints and cut them
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCS[dtype] = fn
    return _FUNCS[dtype]


def structured_cell_matmul(u: torch.Tensor, kcell: torch.Tensor,
                           n_cells) -> torch.Tensor:
    """fe (81, nx*ny*nz) = Kcell @ gathered slots of u; see the module doc."""
    nx, ny, nz = (int(v) for v in n_cells)
    ndof = phase_offsets((nx, ny, nz))[-1]
    if u.dtype not in (torch.float32, torch.float64) or kcell.dtype != u.dtype:
        raise TypeError(f"u and kcell must share float32/float64, got "
                        f"{u.dtype} and {kcell.dtype}")
    if u.shape != (ndof,) or kcell.shape != (81, 81):
        raise ValueError(f"expected u ({ndof},) and kcell (81, 81) for cells "
                         f"{(nx, ny, nz)}, got {tuple(u.shape)} and "
                         f"{tuple(kcell.shape)}")
    if u.device != kcell.device:
        raise ValueError(f"u on {u.device} but kcell on {kcell.device}")
    if u.device.type == "cpu":
        return structured_cell_matmul_plain(u, kcell, (nx, ny, nz))
    if u.device.type != "cuda":
        raise RuntimeError(f"no structured_cell_matmul for device {u.device}")
    if not (u.is_contiguous() and kcell.is_contiguous()):
        raise ValueError("structured_cell_matmul needs contiguous u and kcell")
    fe = torch.empty((81, nx * ny * nz), dtype=u.dtype, device=u.device)
    if fe.numel() == 0:
        return fe
    fn = _kernel_fn(u.dtype)
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), kcell.data_ptr(), fe.data_ptr(), nx, ny, nz,
                 torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"structured_cell_matmul launch failed: cudaError {err}")
    LAUNCHES[str(u.dtype).removeprefix("torch.")] += 1
    return fe
