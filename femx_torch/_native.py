"""The native .msh tokenizer (port of femx/_native.py): native/fast_tokens.cpp
loaded through ctypes, with the numpy path for hosts without a compiler.

The library is built at first use with the flags of native/Makefile,

    g++ -O3 -fPIC -shared -std=c++17 -o build/femx_torch/libfemx_native-<hash>.so \\
        native/fast_tokens.cpp

into the port's git-ignored build directory (never into native/), the file
name carrying a hash of the source and flags so an edited source is
rebuilt. Without g++, or when the build or the load fails, parse_numbers
takes the numpy path, as femx does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from femx_torch.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "fast_tokens.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + repr(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfemx_native-{digest}.so"


def _build() -> Optional[Path]:
    """The built library's path, building it if needed; None when the host
    has no g++ or the build fails."""
    if not SOURCE.exists():
        return None
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.femx_count_tokens.restype = ctypes.c_long
    lib.femx_count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.femx_parse_doubles.restype = ctypes.c_long
    lib.femx_parse_doubles.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                       ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def parse_numbers(text: str) -> np.ndarray:
    """All whitespace-separated numbers in `text` as float64: the C++
    strtod path, else (or on a malformed token) numpy, which raises on a
    malformed token."""
    lib = _load()
    if lib is not None:
        raw = text.encode()
        n = lib.femx_count_tokens(raw, len(raw))
        out = np.empty(n, dtype=np.float64)
        got = lib.femx_parse_doubles(raw, len(raw),
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        if got >= 0:
            return out[:got]
    return np.array(text.split(), dtype=np.float64)
