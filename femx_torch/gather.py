"""Hand-written CUDA data-movement kernels and their plain PyTorch versions.

- ``take_rows(tab, idx)`` — row gather ``tab[idx]`` (csrc/take_rows.cu):
  the unstructured transpose-gather operator's ``u3[connT]`` and bucket
  gathers, and the lattice transfers' row gathers, run through it;
- ``take_along_axis(tab, idx, axis)`` — per-element gather along one axis
  (csrc/take_along_axis.cu), launched as ``plan_take_along`` plans it;
- ``row_copy(x, row0, n_rows, scale)`` — scaled copy of a run of rows that
  starts at a device-held row (csrc/row_copy.cu);
- ``slot_set``, ``slot_copy_in``, ``slot_copy_out`` — copies between a
  buffer and the caller's vector at an address held on the device
  (csrc/slot_copy.cu): the input and output of a replayed CUDA graph.

The first three are the counterparts of the Pallas gather and lowering
repros of femx's examples/ (see each source's header). On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
version, which is also the kernel's reference (the slot copies, which move
raw addresses, have none and raise). Indices are int32 on the card and are
trusted by the kernels: builders check their range once on the host
(``index_tensor``). Every launch goes through ``femx_torch.launch`` and is
counted in ``LAUNCHES`` under "<kernel>/<dtype>" ("slot_set" alone), only
where a kernel is launched from the host: a replayed graph adds nothing.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from femx_torch import launch
from femx_torch.launch import MAX_DYNAMIC_SMEM

LAUNCHES: collections.Counter = collections.Counter()

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
# each C entry's arguments before the stream
_ARGTYPES = {
    "take_rows": [_P, _P, _P, _I64, _I, _I],
    "take_along_axis": [_P, _P, _P] + [_I] * 8,
    "row_copy": [_P, _P, _P, _I64, _I64, _D],
    "slot_set": [_P, _I64, _I64],
    "slot_copy_in": [_P, _P, _I64],
    "slot_copy_out": [_P, _P, _I64],
}
# the kernel library of each kernel whose source is not csrc/<kernel>.cu
_LIBRARY = {"slot_set": "slot_copy", "slot_copy_in": "slot_copy", "slot_copy_out": "slot_copy"}
_ENTRIES = {}


def _entry(kernel: str, dtype) -> launch.Entry:
    """The bound C entry of `kernel` for `dtype`, counted under
    "<kernel>/<dtype>"; with dtype None, femx_<kernel> counted under
    "<kernel>" (built and bound at first use)."""
    key = (kernel, dtype)
    if key not in _ENTRIES:
        symbol, counted = f"femx_{kernel}", kernel
        if dtype is not None:
            symbol += "_f32" if dtype == torch.float32 else "_f64"
            counted += f"/{str(dtype).removeprefix('torch.')}"
        _ENTRIES[key] = launch.bind(_LIBRARY.get(kernel, kernel), symbol, _ARGTYPES[kernel],
                                    LAUNCHES, counted)
    return _ENTRIES[key]


def _kernel_fn(kernel: str, dtype: torch.dtype):
    """The raw ctypes function of `kernel` (arguments, then the stream);
    calling it counts nothing (tests and timing loops)."""
    return _entry(kernel, dtype).fn


def _launch(kernel: str, ref: torch.Tensor, *args) -> None:
    """Launch `kernel` on ref's device and current stream; raise if it was
    refused."""
    launch.launch(_entry(kernel, ref.dtype), ref.get_device(), *args)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    first = tensors[0]
    if not first.is_cuda:
        raise RuntimeError(f"no {name} kernel for device {first.device}")
    dev = first.get_device()
    for t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


_FLOATS = (torch.float32, torch.float64)


def _check_float(name: str, tab: torch.Tensor) -> None:
    if tab.dtype not in _FLOATS:
        raise TypeError(f"{name}: table must be float32 or float64, got {tab.dtype}")


def _check_index(name: str, idx: torch.Tensor, cuda: bool) -> None:
    if idx.dtype != torch.int32 and (cuda or idx.dtype != torch.int64):
        ok = "torch.int32" if cuda else "torch.int32 or torch.int64"
        raise TypeError(f"{name}: index must be {ok}, got {idx.dtype}")


def index_tensor(a, n_rows: int, device) -> torch.Tensor:
    """Host index array -> the tensor the wrappers take on `device`: int32
    on the card (the kernels' type), int64 on the CPU (torch indexing's, so
    the plain versions convert nothing per call), contiguous. Raises unless
    every index lies in [0, n_rows): the kernels trust their indices."""
    a = np.ascontiguousarray(a)
    if a.size and (a.min() < 0 or a.max() >= n_rows):
        raise ValueError(f"index out of range [0, {n_rows}): "
                         f"[{a.min()}, {a.max()}]")
    if n_rows > np.iinfo(np.int32).max:
        raise ValueError(f"{n_rows} rows do not fit int32 indices")
    dev = torch.device(device)
    return torch.tensor(a, dtype=torch.int32 if dev.type == "cuda" else torch.int64,
                        device=dev)


# -- take_rows ----------------------------------------------------------------
def take_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Reference version: ``tab[idx]`` (rows of a 2-D table, elements of a
    1-D one)."""
    return tab[idx if idx.dtype == torch.int64 else idx.long()]


def take_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx]`` for tab (R,) or (R, W) and an index array of any shape:
    out has shape (*idx.shape,) or (*idx.shape, W)."""
    _check_float("take_rows", tab)
    if tab.ndim not in (1, 2):
        raise ValueError(f"take_rows: table must be 1-D or 2-D, got {tuple(tab.shape)}")
    cuda = tab.device.type == "cuda"
    _check_index("take_rows", idx, cuda)
    if tab.device.type == "cpu":
        return take_rows_plain(tab, idx)
    _check_cuda("take_rows", tab, idx)
    width = 1 if tab.ndim == 1 else tab.shape[1]
    out = torch.empty((*idx.shape, *tab.shape[1:]), dtype=tab.dtype, device=tab.device)
    if out.numel() == 0:
        return out
    _launch("take_rows", tab, tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
            idx.numel(), width, 0)
    return out


# -- take_along_axis ----------------------------------------------------------
def take_along_axis_plain(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Reference version: ``torch.gather(tab, axis, idx)``."""
    return torch.gather(tab, axis, idx if idx.dtype == torch.int64 else idx.long())


# The launch plan of csrc/take_along_axis.cu; these constants and
# `slab_position` mirror the source's, and the C entry refuses (code 1001) a
# plan whose shared memory or grid disagrees with it.
SLAB_BYTES = 32                # an axis-0 slab is one 32-byte sector of columns
SLAB_THREADS = 512
SIMPLE_THREADS, SIMPLE_PER_THREAD = 256, 4
ALONG_VARIANTS = {"slab": 1, "slab_scalar": 2, "l2": 3, "axis1": 4}


@dataclasses.dataclass(frozen=True)
class AlongPlan:
    """"slab"/"slab_scalar" (axis 0, the table's slab in shared memory):
    block b stages column slab b % n_slabs and streams the index rows
    [r rows_per_block, (r + 1) rows_per_block) with r = b // n_slabs;
    "slab" in 16-byte output words (`word_columns` columns), "slab_scalar"
    one element at a time. "l2" (axis 0, a table too tall for a slab) and
    "axis1": output element e by block e // (SIMPLE_THREADS *
    SIMPLE_PER_THREAD)."""

    variant: str
    grid: int
    threads: int
    smem: int
    n_slabs: int = 0
    rows_per_block: int = 0

    @property
    def code(self) -> int:
        return ALONG_VARIANTS[self.variant]


def slab_columns(itemsize: int) -> int:
    """Table columns in one slab: 8 float32 or 4 float64."""
    return SLAB_BYTES // itemsize


def word_columns(itemsize: int) -> int:
    """Columns of one 16-byte output word of the "slab" variant."""
    return 16 // itemsize


def slab_position(k, c, itemsize: int):
    """Where the slab keeps column c of table row k (in elements): rows of
    one sector, columns XOR-swizzled by the row's bits above the 4 rows of
    one 128-byte bank line, so random rows spread over all 32 banks."""
    s = slab_columns(itemsize)
    return k * s + (c ^ ((k >> 2) & (s - 1)))


@functools.lru_cache(maxsize=None)
def plan_take_along(rows: int, cols: int, tab_rows: int, tab_cols: int, axis: int,
                    itemsize: int, sm_count: int, aligned: bool = True) -> AlongPlan:
    """The launch of take_along_axis on idx (rows, cols), tab (tab_rows,
    tab_cols): axis 0 takes the slab variants while the slab of all table
    rows fits a block's shared memory, else "l2"; "slab" needs rows of whole
    16-byte output words (cols a multiple of `word_columns`) and `aligned`
    (both streams' base pointers 16-byte aligned). The slab grid fills the
    SMs once: as many row ranges per slab as resident blocks allow."""
    if rows * cols >= 2 ** 31 or tab_rows * tab_cols >= 2 ** 31:
        raise ValueError(f"take_along_axis indexes in 32 bits: idx ({rows}, {cols}), "
                         f"table ({tab_rows}, {tab_cols}) do not fit")
    smem = tab_rows * SLAB_BYTES
    if axis == 1 or smem > MAX_DYNAMIC_SMEM:
        grid = -(-rows * cols // (SIMPLE_THREADS * SIMPLE_PER_THREAD))
        return AlongPlan("axis1" if axis == 1 else "l2", grid, SIMPLE_THREADS, 0)
    per_sm = launch.blocks_per_sm(smem, SLAB_THREADS)
    n_slabs = -(-cols // slab_columns(itemsize))
    ranges = max(1, min(rows, sm_count * per_sm // n_slabs))
    rows_per_block = -(-rows // ranges)
    ranges = -(-rows // rows_per_block)  # no block without rows
    variant = "slab" if aligned and cols % word_columns(itemsize) == 0 else "slab_scalar"
    return AlongPlan(variant, n_slabs * ranges, SLAB_THREADS, smem, n_slabs, rows_per_block)


def take_along_axis(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """axis 0: out[i, j] = tab[idx[i, j], j] (idx may have more rows than
    tab); axis 1: out[i, j] = tab[i, idx[i, j]]. tab and idx are 2-D; out
    has idx's shape."""
    _check_float("take_along_axis", tab)
    if axis not in (0, 1) or tab.ndim != 2 or idx.ndim != 2:
        raise ValueError("take_along_axis takes a 2-D table and index and axis 0 or 1")
    if (axis == 0 and idx.shape[1] != tab.shape[1]) or (axis == 1 and idx.shape[0] != tab.shape[0]):
        raise ValueError(f"take_along_axis(axis={axis}): index {tuple(idx.shape)} "
                         f"does not fit table {tuple(tab.shape)}")
    cuda = tab.device.type == "cuda"
    _check_index("take_along_axis", idx, cuda)
    if tab.device.type == "cpu":
        return take_along_axis_plain(tab, idx, axis)
    _check_cuda("take_along_axis", tab, idx)
    out = torch.empty(idx.shape, dtype=tab.dtype, device=tab.device)
    if out.numel() == 0:
        return out
    (rows, cols), (tab_rows, tab_cols) = idx.shape, tab.shape
    plan = plan_take_along(rows, cols, tab_rows, tab_cols, axis, tab.element_size(),
                           launch.sm_count(tab.get_device()),
                           idx.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _launch("take_along_axis", tab, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
            tab_rows, tab_cols, plan.code, plan.grid, plan.smem, plan.rows_per_block)
    return out


# -- row_copy -----------------------------------------------------------------
def row_copy_plain(x: torch.Tensor, row0: torch.Tensor, n_rows: int,
                   scale: float = 1.0) -> torch.Tensor:
    """Reference version: ``scale * x[row0:row0 + n_rows]``."""
    r = int(row0.reshape(-1)[0])
    return scale * x[r:r + n_rows]


def row_copy(x: torch.Tensor, row0: torch.Tensor, n_rows: int,
             scale: float = 1.0) -> torch.Tensor:
    """out (n_rows, C) = scale * x[row0[0] + r, :] for x (R, C), with the
    start row read from the int32 tensor row0 on the device (never on the
    host); row0 is trusted to keep the run inside x."""
    # the checks of _check_float, _check_index and _check_cuda written out:
    # at the repros' 8 KB a call costs only its host work
    dtype = x.dtype
    if dtype is not torch.float32 and dtype is not torch.float64:
        raise TypeError(f"row_copy: table must be float32 or float64, got {dtype}")
    shape = x.shape
    if len(shape) != 2 or not 0 <= n_rows <= shape[0]:
        raise ValueError(f"row_copy: x must be 2-D with at least {n_rows} rows, "
                         f"got {tuple(shape)}")
    if not x.is_cuda:
        _check_index("row_copy", row0, False)
        if x.device.type == "cpu":
            return row_copy_plain(x, row0, n_rows, scale)
        raise RuntimeError(f"no row_copy kernel for device {x.device}")
    if row0.dtype != torch.int32:
        _check_index("row_copy", row0, True)
    dev = x.get_device()
    if row0.get_device() != dev:
        raise ValueError(f"row_copy: tensors on {x.device} and {row0.device}")
    if not (x.is_contiguous() and row0.is_contiguous()):
        raise ValueError("row_copy needs contiguous tensors")
    out = x.new_empty(n_rows, shape[1])  # sizes as ints: a third cheaper than a tuple
    if n_rows and shape[1]:
        launch.launch(_entry("row_copy", dtype), dev, x.data_ptr(), row0.data_ptr(),
                      out.data_ptr(), n_rows, shape[1], scale)
    return out


# -- slot copies --------------------------------------------------------------
def _check_slots(name: str, slots: torch.Tensor, buf=None) -> None:
    if slots.dtype != torch.int64 or tuple(slots.shape) != (2,):
        raise ValueError(f"{name}: slots must be an int64 tensor of 2, got {slots.dtype} "
                         f"{tuple(slots.shape)}")
    if buf is not None:
        _check_float(name, buf)
    _check_cuda(name, slots, *(() if buf is None else (buf,)))


def slot_set(slots: torch.Tensor, src: int, dst: int) -> None:
    """slots = (src, dst), two device addresses written by a kernel on the
    current stream: what the next slot_copy_in and slot_copy_out in stream
    order read."""
    _check_slots("slot_set", slots)
    launch.launch(_entry("slot_set", None), slots.get_device(), slots.data_ptr(), src, dst)


def slot_copy_in(slots: torch.Tensor, buf: torch.Tensor) -> None:
    """buf = the buf.numel() elements of buf's dtype at the address in
    slots[0]; the address is read on the card, so a captured launch reads
    each replay's own."""
    _check_slots("slot_copy_in", slots, buf)
    _launch("slot_copy_in", buf, slots.data_ptr(), buf.data_ptr(), buf.numel())


def slot_copy_out(slots: torch.Tensor, buf: torch.Tensor) -> None:
    """The buf.numel() elements at the address in slots[1] = buf (the
    address read on the card, as slot_copy_in's)."""
    _check_slots("slot_copy_out", slots, buf)
    _launch("slot_copy_out", buf, slots.data_ptr(), buf.data_ptr(), buf.numel())
