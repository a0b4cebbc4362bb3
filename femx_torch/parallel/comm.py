"""Ranks and collectives of femx_torch.parallel: the counterpart of femx's
device mesh (femx/parallel/ops.py:37) and of its shard_map collectives.

femx runs one controller over a ``jax.sharding.Mesh``; here every rank is
a process (SPMD) that builds the same analysis and calls the same methods,
and the collectives are ``torch.distributed`` calls on the rank's device:

- ``psum`` -> ``all_reduce``; ``all_gather`` -> ``all_gather``;
  ``psum_scatter`` -> ``reduce_scatter``; ``axis_index`` -> ``rank()``;
- the plane exchanges femx does with ``lax.ppermute`` ("send to rank +- 1,
  the ends receive zeros"; femx/parallel/halo.py:160-183,
  femx/parallel/tg_sharded.py:288-335) -> ``exchange``: one ``all_gather``
  of every rank's two boundary blocks, from which each rank keeps its
  neighbours'.

Tracing (femx_torch.profiling): each collective of a group of two or more
ranks is a span, ``comm.all_reduce``, ``comm.all_gather`` or
``comm.exchange`` (its ``comm.all_gather`` inside), and adds the bytes of
the tensor this rank hands to it to the counter ``comm.bytes``. A
collective captured into a CUDA graph records no span, and its bytes go to
the capture's tally (profiling.tally), which the graph's owner counts again
at each replay.

Backend rule (``backend_for``): ``nccl`` when every rank has a CUDA device
of its own, ``gloo`` on the CPU or when the ranks outnumber the CUDA
devices (NCCL refuses two ranks on one GPU). gloo takes CUDA tensors for
all_reduce, all_gather and broadcast, but its send/recv hand a raw device
pointer to TCP, so no collective here uses send/recv; reduce_scatter is
an all_reduce and a slice under both backends.

``launch(fn, nprocs, *args)`` spawns the ranks (the "spawn" start method,
since the parent may hold CUDA), rendezvouses through a ``file://`` store
in a fresh temporary directory (no TCP port, so concurrent test workers
cannot collide), runs ``fn(*args)`` on every rank and returns rank 0's
result; a rank that fails or a run past its deadline kills every rank and
raises. Kernel launch counts are per process, so ``all_ranks=True``
returns every rank's result with its counts.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from femx_torch.profiling import count, span


@dataclasses.dataclass
class RankResult:
    """What one rank of a launch returned, and the kernel launches it made
    in all ({"<kernel>/<dtype>": count}, counted by the wrappers)."""

    rank: int
    result: Any
    launches: dict


def backend_for(nprocs: int, device) -> str:
    """gloo on the CPU or when the ranks outnumber the CUDA devices; nccl
    when every rank has a card of its own."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if nprocs <= torch.cuda.device_count() else "gloo"


def rank_device(rank: int, device) -> torch.device:
    """cuda:(rank % device_count) for a CUDA launch, else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _launch_counts() -> dict:
    from femx_torch import gather
    from femx_torch.elements import cell_matmul

    out = {f"structured_cell_matmul/{k}": v for k, v in cell_matmul.LAUNCHES.items()}
    out.update(gather.LAUNCHES)
    return out


def _rank_main(rank, fn, nprocs, tmpdir, device, backend, timeout, args):
    torch.set_num_threads(1)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmpdir}/rendezvous",
                            world_size=nprocs, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(*args)
        counts = _launch_counts()
        with open(os.path.join(tmpdir, f"rank{rank}.tmp"), "wb") as f:
            pickle.dump((out, counts), f)
        os.replace(os.path.join(tmpdir, f"rank{rank}.tmp"),
                   os.path.join(tmpdir, f"rank{rank}.pkl"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, *args, device="cuda", timeout: float = 600.0,
           all_ranks: bool = False):
    """Run fn(*args) on `nprocs` ranks, one process each, in a process
    group of that size; return rank 0's result (with all_ranks, a list of
    RankResult, one per rank: its result and its kernel launch counts).

    fn must be importable by name (a module-level function of femx_torch or
    of the running script) and return something picklable (host arrays,
    not CUDA tensors). device: "cuda" (each rank on cuda:(rank % count)) or
    "cpu"; the backend is `backend_for`'s. timeout (s): the deadline
    of the whole run and of every collective; past it, or when a rank
    fails, every rank is killed and RuntimeError is raised.

    The CUDA kernels are built here, once, before the ranks start, so the
    ranks do not race on the build directory."""
    import torch.multiprocessing as mp

    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch(device='cuda') needs CUDA; pass device='cpu'")
        from femx_torch import build

        build.build()
    backend = backend_for(nprocs, dev)
    tmpdir = tempfile.mkdtemp(prefix="femx_torch_ranks_")
    deadline = time.monotonic() + timeout
    try:
        ctx = mp.start_processes(_rank_main, nprocs=nprocs, join=False, start_method="spawn",
                                 args=(fn, nprocs, tmpdir, str(dev), backend, float(timeout),
                                       args))
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"launch: {nprocs} ranks of {fn.__name__} passed "
                                       f"their {timeout:.0f} s deadline")
        except BaseException:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
            raise
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmpdir, f"rank{r}.pkl"), "rb") as f:
                res, counts = pickle.load(f)
            out.append(RankResult(r, res, counts))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out if all_ranks else out[0].result


# -- the current rank ---------------------------------------------------------
def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def backend() -> Optional[str]:
    return dist.get_backend() if is_distributed() else None


def require_world(n: int) -> None:
    """Raise ValueError unless this process is a rank of an n-rank group."""
    if world_size() != n:
        raise ValueError(
            f"devices={n} needs a process group of {n} ranks (this process is in "
            f"{'one of ' + str(world_size()) if is_distributed() else 'none'}); start the "
            "ranks with femx_torch.parallel.launch(fn, n, ...), each running the same "
            "analysis, or python -m femx_torch solid --devices N")


# -- collectives --------------------------------------------------------------
def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum over ranks (femx's psum), in place; returns t."""
    if world_size() > 1:
        with span("comm.all_reduce"):
            count("comm.bytes", t.numel() * t.element_size())
            dist.all_reduce(t)
    return t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): every rank's t, in rank order."""
    n = world_size()
    if n == 1:
        return t[None].clone()
    t = t.contiguous()
    with span("comm.all_gather"):
        count("comm.bytes", t.numel() * t.element_size())
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
    return torch.stack(parts)


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """femx's psum_scatter(tiled=True): the sum over ranks of t (length a
    multiple of the world size), this rank's contiguous chunk of it."""
    n = world_size()
    if n == 1:
        return t.clone()
    chunk = t.shape[0] // n
    s = all_reduce(t.clone())
    r = rank()
    return s[r * chunk:(r + 1) * chunk].clone()


def exchange(to_below: torch.Tensor, to_above: torch.Tensor):
    """The two neighbour shifts of femx's ppermute pairs in one all_gather:
    returns (what rank - 1 sent up, what rank + 1 sent down); rank 0
    receives zeros from below, the last rank zeros from above. Both blocks
    have one shape and dtype."""
    n, r = world_size(), rank()
    if n == 1:
        return torch.zeros_like(to_above), torch.zeros_like(to_below)
    with span("comm.exchange"):
        g = all_gather(torch.stack([to_below, to_above]))
        from_below = g[r - 1, 1] if r > 0 else torch.zeros_like(to_above)
        from_above = g[r + 1, 0] if r + 1 < n else torch.zeros_like(to_below)
    return from_below, from_above


def dots(*pairs, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum over ranks of dot(a * weight, b) for each (a, b), in one
    all_reduce (femx's psum(vdot(a * w, b))): one entry per pair, so that
    with the ownership weight bound it is pcg's `dots` on rank-local
    vectors."""
    parts = [torch.dot(a if weight is None else a * weight, b) for a, b in pairs]
    return all_reduce(torch.stack(parts))
