"""The host side of every hand-written kernel launch: one ctypes call on the
tensor's device and current stream, its error code checked, the launch
counted.

A kernel library's C entry is bound once per (kernel, dtype) into an
``Entry``: the ctypes function with its argument types and the key its
launches are counted under. ``launch`` then does per call only what cannot
be cached:

- it reads the current stream on every call, as a raw handle
  (``torch._C._cuda_getCurrentRawStream``), because a CUDA graph capture
  makes another stream current; no ``torch.cuda.Stream`` object is built;
- it enters a device guard only when the tensor's device is not the
  current one;
- it raises on any nonzero code the C entry returns (``cudaGetLastError()``
  after the launch, or the entry's own code for a plan it refuses), and
  counts the launch only when the code is 0.

Nothing here runs at import: a CPU build of torch has neither getter, so
they are bound at the first launch (the CPU tests stub them).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Sequence

import torch

from femx_torch import build

# torch._C._cuda_getCurrentRawStream and torch._C._cuda_getDevice, bound at
# the first launch
_raw_stream = None
_current_device = None


def _bind_getters() -> None:
    global _raw_stream, _current_device
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _current_device = torch._C._cuda_getDevice


def current_stream(device_index: int) -> int:
    """The raw handle of the current stream of CUDA device `device_index`."""
    if _raw_stream is None:
        _bind_getters()
    return _raw_stream(device_index)


# shared memory on sm_90, the same for every kernel
MAX_DYNAMIC_SMEM = 232_448  # bytes a block may opt into
SM_SMEM = 233_472           # shared memory of one SM (228 KB)
BLOCK_RESERVED_SMEM = 1024  # CUDA's own share of each resident block


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of `threads` threads and `smem` bytes of dynamic shared memory
    that fit one SM (at least 1)."""
    return max(1, min(SM_SMEM // (smem + BLOCK_RESERVED_SMEM), 2048 // threads))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of CUDA device `device_index` (a kernel plan's input)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class Entry:
    """A C entry bound for launching: `fn` takes the kernel's arguments and
    the stream last, and returns 0 or an error code; its launches are
    counted in `counter[key]`."""

    __slots__ = ("name", "fn", "counter", "key")

    def __init__(self, name: str, fn, counter: collections.Counter, key: str):
        self.name, self.fn, self.counter, self.key = name, fn, counter, key


def bind(library: str, symbol: str, argtypes: Sequence, counter: collections.Counter,
         key: str) -> Entry:
    """Entry `symbol` of kernel library `library` (built at first use).
    Pointers and the stream go as c_void_p and 64-bit counts as c_int64:
    without argtypes ctypes would pass them as 32-bit ints and cut them."""
    fn = getattr(build.load(library), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Entry(library, fn, counter, key)


def launch(entry: Entry, device_index: int, *args) -> None:
    """Call `entry` with `args` and the current stream of CUDA device
    `device_index` (on that device); raise unless it returns 0, else count
    one launch."""
    if _raw_stream is None:
        _bind_getters()
    if device_index == _current_device():
        err = entry.fn(*args, _raw_stream(device_index))
    else:
        with torch.cuda.device(device_index):
            err = entry.fn(*args, _raw_stream(device_index))
    if err:
        raise RuntimeError(f"{entry.name} launch failed: error {err}")
    entry.counter[entry.key] += 1
