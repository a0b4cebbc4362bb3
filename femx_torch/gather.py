"""Hand-written CUDA data-movement kernels and their plain PyTorch versions.

- ``take_rows(tab, idx)`` — row gather ``tab[idx]`` (csrc/take_rows.cu):
  the unstructured transpose-gather operator's ``u3[connT]`` and bucket
  gathers, and the lattice transfers' row gathers, run through it;
- ``take_along_axis(tab, idx, axis)`` — per-element gather along one axis
  (csrc/take_along_axis.cu);
- ``row_copy(x, row0, n_rows, scale)`` — scaled copy of a run of rows that
  starts at a device-held row (csrc/row_copy.cu).

They are the counterparts of the Pallas gather and lowering repros of
femx's examples/ (see each source's header). On a CUDA tensor a wrapper
launches its kernel or raises; on a CPU tensor it runs the plain version,
which is also the kernel's reference. Indices are int32 on the card and are
trusted by the kernels: builders check their range once on the host
(``index_tensor``). Launches are counted in ``LAUNCHES`` under
"<kernel>/<dtype>", only where a kernel is launched.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from femx_torch import build

LAUNCHES: collections.Counter = collections.Counter()

_FUNCS = {}
_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_ARGTYPES = {
    "take_rows": [_P, _P, _P, _I64, _I, _I, _P],
    "take_along_axis": [_P, _P, _P, _I64, _I, _I, _I, _P],
    "row_copy": [_P, _P, _P, _I64, _I64, _D, _P],
}


def _kernel_fn(kernel: str, dtype: torch.dtype):
    key = (kernel, dtype)
    if key not in _FUNCS:
        suffix = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(build.load(kernel), f"femx_{kernel}_{suffix}")
        # pointers and the stream as c_void_p, 64-bit counts as c_int64:
        # without argtypes ctypes would pass them as 32-bit ints
        fn.argtypes = _ARGTYPES[kernel]
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return _FUNCS[key]


def _launch(kernel: str, ref: torch.Tensor, *args) -> None:
    """Launch `kernel` on ref's device and stream; raise if it was refused."""
    fn = _kernel_fn(kernel, ref.dtype)
    with torch.cuda.device(ref.device):
        err = fn(*args, torch.cuda.current_stream(ref.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[f"{kernel}/{str(ref.dtype).removeprefix('torch.')}"] += 1


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"no {name} kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _check_float(name: str, tab: torch.Tensor) -> None:
    if tab.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: table must be float32 or float64, got {tab.dtype}")


def _check_index(name: str, idx: torch.Tensor, cuda: bool) -> None:
    ok = (torch.int32,) if cuda else (torch.int32, torch.int64)
    if idx.dtype not in ok:
        raise TypeError(f"{name}: index must be {' or '.join(map(str, ok))}, got {idx.dtype}")


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
    _launch("take_along_axis", tab, tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
            idx.shape[0], idx.shape[1], tab.shape[1], axis)
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
    _check_float("row_copy", x)
    if x.ndim != 2 or not 0 <= n_rows <= x.shape[0]:
        raise ValueError(f"row_copy: x must be 2-D with at least {n_rows} rows, "
                         f"got {tuple(x.shape)}")
    cuda = x.device.type == "cuda"
    _check_index("row_copy", row0, cuda)
    if x.device.type == "cpu":
        return row_copy_plain(x, row0, n_rows, scale)
    _check_cuda("row_copy", x, row0)
    out = torch.empty((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("row_copy", x, x.data_ptr(), row0.data_ptr(), out.data_ptr(), n_rows,
            x.shape[1], float(scale))
    return out
