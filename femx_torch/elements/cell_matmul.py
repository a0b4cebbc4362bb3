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

The source holds two kernel families, each in several tile sizes: "fma"
(register-blocked FMAs, float32 and float64) and "dmma" (the FP64 tensor
cores, float64). What surrounds a launch is decided here, where the CPU tests
reach it: ``plan_launch`` picks the variant, tile and persistent grid from
the cell count, dtype and SM count, and ``pack_kcell`` lays the cell matrix
out the way the variant's inner loop reads it from shared memory.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import weakref
from typing import List, Optional, Sequence, Tuple

import torch

from femx_torch import launch
from femx_torch.launch import MAX_DYNAMIC_SMEM

# The 27 cell-local slots in raster order (a-major), a,b,c in {0,1,2}:
# lattice position = cell*2 + (a,b,c). Slot s = 9a + 3b + c.
_SLOTS = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]

# Kernel launches per dtype name ("float32"/"float64"), counted only where
# the kernel is launched.
LAUNCHES: collections.Counter = collections.Counter()

_KERNEL = "structured_cell_matmul"
_ENTRIES = {}


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


# -- launch planning and the packed cell matrix (host side of the kernel) ------


@dataclasses.dataclass(frozen=True)
class Variant:
    """One instantiation of a kernel family of csrc/structured_cell_matmul.cu.

    "fma": 9 warps, warp w owns rows 9w..9w+8, a lane owns `cpl` cells, so a
    tile is 32 * cpl cells. "dmma" (float64 only): `warps` warps, each on one
    n-tile of 8 cells, products of (8 m8) x 8 x 4 on the FP64 tensor cores,
    rows and depth of the cell matrix zero-padded to whole products. Both
    double-buffer the gathered tile."""

    family: str
    cpl: int = 0
    m8: int = 0
    warps: int = 9

    @property
    def code(self) -> int:
        """The variant number of the C entry's switch."""
        return 100 * self.cpl if self.family == "fma" else 10000 * self.m8 + self.warps

    def entry_tag(self, dtype: torch.dtype) -> str:
        """The part of the kernel's mangled entry name that names this
        instantiation (to find it in ptxas' output, build.kernel_resources)."""
        if self.family == "fma":
            return f"cell_matmul_fmaI{'f' if dtype == torch.float32 else 'd'}Li{self.cpl}EE"
        return f"cell_matmul_dmmaILi{self.m8}ELi{self.warps}EE"

    def label(self) -> str:
        if self.family == "fma":
            return f"fma, {self.cpl} cells/lane, tile {self.tile}"
        return f"dmma m{8 * self.m8}n8k4, {self.warps} warps, tile {self.tile}"

    @property
    def tile(self) -> int:
        return 32 * self.cpl if self.family == "fma" else 8 * self.warps

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def padded(self) -> Tuple[int, int]:
        """(rows, depth) of the cell matrix as the dmma kernel multiplies it."""
        m = 8 * self.m8
        return -(-81 // m) * m, 84

    def kpad(self, itemsize: int) -> int:
        """fma: 9 rows padded to whole 16-byte words."""
        return 12 if itemsize == 4 else 10

    def packed_numel(self, itemsize: int) -> int:
        if self.family == "fma":
            return 81 * 9 * self.kpad(itemsize)
        mp, kp = self.padded
        return mp * kp

    def smem_bytes(self, itemsize: int) -> int:
        """Dynamic shared memory of a block: the packed cell matrix and two
        gathered tiles (dmma: padded depth, row stride tile + 4)."""
        if self.family == "fma":
            tile_elems = 81 * self.tile
        else:
            tile_elems = self.padded[1] * (self.tile + 4)
        return itemsize * (self.packed_numel(itemsize) + 2 * tile_elems)


def _fma(cpl):
    return Variant("fma", cpl=cpl)


def _dmma(m8, warps):
    return Variant("dmma", m8=m8, warps=warps)


# Every variant the source builds, by dtype (scripts/kernel_sweep.py times
# them all), and the ones the planner picks from, by (family, dtype), largest
# tile first: on the H100 the fma tile of 64 cells beat 128 and 256 at every
# lattice, and m16n8k4 beat m8n8k4, with 4 warps on 32 cells no slower than
# 8 warps on 64 at the flagship and faster above it.
BUILT = {
    torch.float32: (_fma(1), _fma(2), _fma(4), _fma(8)),
    torch.float64: (_fma(1), _fma(2), _dmma(1, 4), _dmma(2, 4), _dmma(2, 8)),
}
PLANNED = {
    ("fma", torch.float32): (_fma(2), _fma(1)),
    ("fma", torch.float64): (_fma(2), _fma(1)),
    ("dmma", torch.float64): (_dmma(2, 4),),
}
DEFAULT_FAMILY = {torch.float32: "fma", torch.float64: "dmma"}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Block b of `grid` walks the tiles b, b + grid, ... < n_tiles; tile t
    holds the cells [t * variant.tile, min((t + 1) * variant.tile, cells))."""

    variant: Variant
    n_tiles: int
    grid: int
    smem: int


def blocks_per_sm(variant: Variant, itemsize: int) -> int:
    """Blocks of `variant` that fit one SM by shared memory and threads."""
    return launch.blocks_per_sm(variant.smem_bytes(itemsize), variant.threads)


@functools.lru_cache(maxsize=None)
def plan_launch(cells: int, dtype: torch.dtype, sm_count: int,
                family: Optional[str] = None,
                variant: Optional[Variant] = None) -> LaunchPlan:
    """The launch of `cells` cells: the largest tile of the family (default:
    the dtype's faster one) that still gives every SM a tile, else the
    smallest; a persistent grid of at most SMs x resident blocks. `variant`
    overrides the choice of tile (timing sweeps)."""
    itemsize = torch.finfo(dtype).bits // 8
    if variant is None:
        choices = PLANNED[(family or DEFAULT_FAMILY[dtype], dtype)]
        variant = next((v for v in choices if -(-cells // v.tile) >= sm_count),
                       choices[-1])
    n_tiles = -(-cells // variant.tile)
    smem = variant.smem_bytes(itemsize)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{variant} needs {smem} B of shared memory")
    grid = min(n_tiles, sm_count * blocks_per_sm(variant, itemsize))
    return LaunchPlan(variant, n_tiles, grid, smem)


def pack_kcell(kcell: torch.Tensor, variant: Variant) -> torch.Tensor:
    """The cell matrix (81, 81) in the order `variant`'s inner loop reads it
    from shared memory (flat, zero-padded).

    fma: k-major, (81 k, 9 warps, kpad): entry [k, w, r] = kcell[9w + r, k].
    dmma: fragment order (k-steps, m-tiles, 32 lanes, m8): value i of lane
    4g + t in (s, m) is kcell[8 m8 m + g + 8 i, 4 s + t]."""
    if variant.family == "fma":
        kt = kcell.t().reshape(81, 9, 9)
        return torch.nn.functional.pad(kt, (0, variant.kpad(kcell.element_size()) - 9)
                                       ).reshape(-1).contiguous()
    mp, kp = variant.padded
    m8 = variant.m8
    padded = torch.nn.functional.pad(kcell, (0, kp - 81, 0, mp - 81))
    # rows (m, i, g), depth (s, t) -> (s, m, lane = 4g + t, i)
    return padded.reshape(mp // (8 * m8), m8, 8, kp // 4, 4).permute(3, 0, 2, 4, 1
                                                                       ).reshape(-1).contiguous()


# id(kcell) and layout -> (weak reference, tensor version, packed copy): an
# operator applies one cell matrix thousands of times
_PACKED = {}


def _packed_kcell(kcell: torch.Tensor, variant: Variant) -> torch.Tensor:
    key = (id(kcell), variant.family, variant.m8)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is kcell and hit[1] == kcell._version:
        return hit[2]
    packed = pack_kcell(kcell, variant)
    _PACKED[key] = (weakref.ref(kcell, lambda _, key=key: _PACKED.pop(key, None)),
                    kcell._version, packed)
    return packed


def _entry(dtype: torch.dtype) -> launch.Entry:
    """The bound C entry for `dtype`, counted in LAUNCHES[dtype name]."""
    if dtype not in _ENTRIES:
        suffix = "f32" if dtype == torch.float32 else "f64"
        _ENTRIES[dtype] = launch.bind(
            _KERNEL, f"femx_structured_cell_matmul_{suffix}",
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6, LAUNCHES,
            str(dtype).removeprefix("torch."))
    return _ENTRIES[dtype]


def _args(u: torch.Tensor, kcell: torch.Tensor, fe: torch.Tensor, n_cells,
          plan: LaunchPlan) -> tuple:
    """The C entry's arguments for `plan`, the stream left out."""
    nx, ny, nz = n_cells
    packed = _packed_kcell(kcell, plan.variant)
    return (u.data_ptr(), packed.data_ptr(), fe.data_ptr(), nx, ny, nz,
            plan.variant.code, plan.grid, plan.smem)


def _launcher(u: torch.Tensor, kcell: torch.Tensor, fe: torch.Tensor, n_cells,
              plan: LaunchPlan):
    """A function of no arguments that launches `plan` on u's current stream
    and returns the C entry's code (0 = launched); counts nothing."""
    fn = _entry(u.dtype).fn
    args = (*_args(u, kcell, fe, n_cells, plan), launch.current_stream(u.get_device()))
    return lambda: fn(*args)


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
    if ndof >= 2 ** 31:
        raise ValueError(f"the kernel indexes u in 32 bits; {ndof} DOF do not fit")
    fe = torch.empty((81, nx * ny * nz), dtype=u.dtype, device=u.device)
    if fe.numel() == 0:
        return fe
    dev = u.get_device()
    plan = plan_launch(nx * ny * nz, u.dtype, launch.sm_count(dev))
    launch.launch(_entry(u.dtype), dev, *_args(u, kcell, fe, (nx, ny, nz), plan))
    return fe
