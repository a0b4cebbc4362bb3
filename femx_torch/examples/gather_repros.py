"""Counterparts of femx's in-kernel gather repros (examples/pallas_gather_repros.py).

femx's repros probe whether the unstructured operator's gathers can run
inside a TPU kernel from a VMEM-resident table. Each function here keeps the
repro's name and its inputs (numpy default_rng(0)) and runs the gather
through the port's hand-written CUDA kernels (the plain versions on a CPU
device):

  repro_take_values          tab (16384,) f32, idx (8, 128)  -> take_rows
  repro_take_rows_2d         tab (128, 128), idx (8,)         -> take_rows
  repro_take_along_lanes     (8, 128), axis 1                 -> take_along_axis
  repro_take_along_sublanes  tab (512, 128), idx (8, 128)     -> take_along_axis
  repro_dynamic_ref_rows     tab (512, 128), idx (8,)         -> take_rows

Run on a machine with a CUDA card: python -m femx_torch.examples.gather_repros
"""

from __future__ import annotations

import numpy as np
import torch

from femx_torch.config import resolve_device
from femx_torch.examples.mosaic_repros import run
from femx_torch.gather import index_tensor, take_along_axis, take_rows

N_TAB = 16 * 1024  # table rows of the 1-D repro


def inputs(name: str):
    """(tab, idx) host arrays of repro `name`, exactly femx's."""
    rng = np.random.default_rng(0)
    if name == "take_values":
        return (rng.standard_normal(N_TAB).astype(np.float32),
                rng.integers(0, N_TAB, size=(8, 128)).astype(np.int32))
    if name == "take_rows_2d":
        return (rng.standard_normal((N_TAB // 128, 128)).astype(np.float32),
                rng.integers(0, N_TAB // 128, size=(8,)).astype(np.int32))
    if name == "take_along_lanes":
        return (rng.standard_normal((8, 128)).astype(np.float32),
                rng.integers(0, 128, size=(8, 128)).astype(np.int32))
    if name in ("take_along_sublanes", "dynamic_ref_rows"):
        shape = (8, 128) if name == "take_along_sublanes" else (8,)
        return (rng.standard_normal((512, 128)).astype(np.float32),
                rng.integers(0, 512, size=shape).astype(np.int32))
    raise KeyError(name)


def _on(name: str, device, axis_len=None):
    dev = resolve_device(device)
    tab, idx = inputs(name)
    n = tab.shape[0] if axis_len is None else axis_len
    return torch.as_tensor(tab, device=dev), index_tensor(idx, n, dev)


def repro_take_values(device=None):
    tab, idx = _on("take_values", device)
    return take_rows(tab, idx)


def repro_take_rows_2d(device=None):
    tab, idx = _on("take_rows_2d", device)
    return take_rows(tab, idx)


def repro_take_along_lanes(device=None):
    tab, idx = _on("take_along_lanes", device, axis_len=128)
    return take_along_axis(tab, idx, axis=1)


def repro_take_along_sublanes(device=None):
    tab, idx = _on("take_along_sublanes", device)
    return take_along_axis(tab, idx, axis=0)


def repro_dynamic_ref_rows(device=None):
    tab, idx = _on("dynamic_ref_rows", device)
    return take_rows(tab, idx)


REPROS = {
    "take_values_1d": repro_take_values,
    "take_rows_2d": repro_take_rows_2d,
    "take_along_lanes": repro_take_along_lanes,
    "take_along_sublanes": repro_take_along_sublanes,
    "dynamic_ref_rows_loop": repro_dynamic_ref_rows,
}


def expected(name: str) -> np.ndarray:
    """What each repro computes, from its inputs in numpy."""
    key = {"take_values_1d": "take_values", "dynamic_ref_rows_loop": "dynamic_ref_rows"}.get(
        name, name)
    tab, idx = inputs(key)
    if key == "take_along_lanes":
        return np.take_along_axis(tab, idx, axis=1)
    if key == "take_along_sublanes":
        return np.take_along_axis(tab, idx, axis=0)
    return tab[idx]


if __name__ == "__main__":
    for name, fn in REPROS.items():
        run(name, fn)
