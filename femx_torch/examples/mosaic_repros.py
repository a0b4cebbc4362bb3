"""Counterparts of femx's Mosaic lowering repros (examples/pallas_mosaic_repros.py).

Each femx repro is a tiny pallas_call isolating one pattern of the
structured TPU kernel; each function here keeps its name and its inputs and
runs the same copy through femx_torch.gather.row_copy, the hand-written
CUDA kernel on the card (the plain version on a CPU device):

  repro_reshape_merge            (8, 4, 128) -> (8, 512) copy
  repro_dynslice_value           rows [4, 12) of (16, 128), start row on the device
  repro_strip_loop{,_f32_carry,_pyint_bounds}   2 * x on (8, 128)

Run on a machine with a CUDA card: python -m femx_torch.examples.mosaic_repros
"""

from __future__ import annotations

import numpy as np
import torch

from femx_torch.config import resolve_device
from femx_torch.gather import row_copy


def run(name, fn):
    """Print PASS with the first values, or FAIL with the error."""
    try:
        out = fn()
        print(f"PASS  {name}: {out.reshape(-1)[:3].cpu().numpy()}")
        return True
    except Exception as e:  # report every failure, as the femx runner does
        print(f"FAIL  {name}: {type(e).__name__}: {str(e)[:300]}")
        return False


def _row0(i: int, dev) -> torch.Tensor:
    return torch.tensor([i], dtype=torch.int32 if dev.type == "cuda" else torch.int64,
                        device=dev)


def repro_reshape_merge(device=None):
    """Copy of (8, 4, 128) into (8, 512): the merged view is contiguous."""
    dev = resolve_device(device)
    x = torch.arange(8 * 4 * 128, dtype=torch.float32, device=dev).reshape(8, 4, 128)
    return row_copy(x.reshape(8, 4 * 128), _row0(0, dev), 8)


def repro_dynslice_value(device=None):
    """Rows [i, i+8) of a (16, 128) value, i = 4 read on the device."""
    dev = resolve_device(device)
    x = torch.arange(16 * 128, dtype=torch.float32, device=dev).reshape(16, 128)
    return row_copy(x, _row0(4, dev), 8)


def _strip(device):
    dev = resolve_device(device)
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    return row_copy(x, _row0(0, dev), 8, scale=2.0)


def repro_strip_loop(device=None):
    """2 * x on (8, 128), row by row in femx (int loop carry)."""
    return _strip(device)


def repro_strip_loop_f32_carry(device=None):
    """The same with a float carry in femx: the carry has no counterpart."""
    return _strip(device)


def repro_strip_loop_pyint_bounds(device=None):
    """The same with Python-int loop bounds in femx."""
    return _strip(device)


REPROS = {
    "reshape_merge_lanes": repro_reshape_merge,
    "dynamic_slice_on_value": repro_dynslice_value,
    "fori_loop_int_carry": repro_strip_loop,
    "fori_loop_f32_carry": repro_strip_loop_f32_carry,
    "fori_loop_pyint_bounds": repro_strip_loop_pyint_bounds,
}


def expected(name: str) -> np.ndarray:
    """What each repro computes, from its inputs in numpy."""
    if name == "reshape_merge_lanes":
        return np.arange(8 * 4 * 128, dtype=np.float32).reshape(8, 512)
    if name == "dynamic_slice_on_value":
        return np.arange(16 * 128, dtype=np.float32).reshape(16, 128)[4:12]
    return 2.0 * np.arange(8 * 128, dtype=np.float32).reshape(8, 128)


if __name__ == "__main__":
    for name, fn in REPROS.items():
        run(name, fn)
