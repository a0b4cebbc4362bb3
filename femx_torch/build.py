"""Build the port's hand-written CUDA kernels and load them with ctypes.

Every ``femx_torch/csrc/<name>.cu`` exposes a plain C interface and is built
at first use with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/femx_torch/lib<name>-<hash>.so <name>.cu

into ``build/femx_torch/`` at the root of the checkout. The file name carries
a hash of the source and flags, so an edited source is rebuilt and an
unchanged one is reused. Several sources build in parallel, one nvcc each.
Nothing here runs at import: the CPU test host has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "femx_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.PyDLL] = {}
# name -> (build seconds, nvcc/ptxas output) for kernels built by this process
BUILD_LOG: Dict[str, tuple] = {}


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    for cand in (cuda_home / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH); "
                       "the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named kernels (default: all) that are not built yet, all
    nvcc processes started together; return name -> library path. Raises
    RuntimeError with the compiler's output if any build fails."""
    names = kernel_names() if names is None else list(names)
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, time.perf_counter(),
                    subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = (time.perf_counter() - t0, out)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def kernel_resources(name: str) -> Dict[str, dict]:
    """What ptxas reported (-Xptxas -v) for each kernel entry of source
    `name` built by this process: mangled entry name -> registers per thread,
    static shared-memory bytes, spill bytes (stores + loads)."""
    out, entry = {}, None
    for line in BUILD_LOG.get(name, (0.0, ""))[1].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "static_smem": 0, "spill_bytes": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[entry]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[entry]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def load(name: str) -> ctypes.PyDLL:
    """The ctypes handle of kernel library `name`, built at first use. A
    PyDLL: its entries only enqueue a launch, so they keep the GIL, which
    saves a release and re-acquire per call."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.PyDLL(str(build([name])[name]))
    return _LIBS[name]
