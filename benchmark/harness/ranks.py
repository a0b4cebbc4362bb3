"""A cell whose configuration names `"devices": N` (N > 1): the N ranks of
femx_torch's `devices=N`, started as a user's are.

run.py hands such a cell to `run_ranks`, which starts the ranks with the
program's own `femx_torch.parallel.launch`, as `python -m femx_torch solid
--devices N` does: one process per rank on cuda:(rank % count), each with
one host thread, in a process group of the program's backend (nccl when
every rank has a card of its own, else gloo). Every rank runs the same
cell (`rank_main`: session.run_cell with a `World`) from the same seed,
so every rank draws the same requests:

- set-up ends when every rank is ready (a barrier), and `setup_s` counts
  from the parent's start, the spawn and the rendezvous included (the
  host's monotonic clock, which every process of the machine shares);
- rank 0 holds the window's clock: before each request it tells the other
  ranks whether to go on, over a gloo group of the harness's own, outside
  the request's latency, so every rank serves the same requests;
- a request that raises on any rank ends the run (the other ranks cannot
  go on alone), and an answer of an analysis that fell back to one device
  (its `solve_info["devices"]` is not N) counts as a failed request;
- the traced pass and the program trace send the same requests on every
  rank; rank 0 alone runs torch.profiler, the other ranks serve them bare
  (with the program's spans on in the program trace's first pass, as on
  rank 0, so that each rank's span totals are kept);
- each rank's peak (`max_memory_allocated`) and, when traced, its
  program-span totals are gathered: `run.ranks`, one record a rank, and
  `run.memory_peak_bytes` the fullest card's (the sum of the peaks of the
  ranks on it, an upper bound where ranks share a card);
- rank 0 reads the metrics and judges its own answers once the program's
  state is freed; no answer crosses a process boundary. The result line
  comes back to the parent, which prints it.

A rank that fails, or a run past its deadline (a set-up allowance, the
window, the traced pass's allowance when traced, and the judgement's),
ends every rank: run_ranks raises RanksFailed.
"""

from __future__ import annotations

import datetime
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

from harness.registry import BENCH_DIR, Registry

SETUP_ALLOWANCE_S = 150.0  # spawn, rendezvous, mesh, operators, warm-up
TRACE_ALLOWANCE_S = 120.0  # the traced requests and the program trace's passes
JUDGE_ALLOWANCE_S = 60.0  # the readers and the reference's judgement


class RanksFailed(RuntimeError):
    """A rank raised, or the ranks passed their deadline."""


def devices_of(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> int:
    """The ranks the cell's configuration names (1 without the key)."""
    reg = Registry(root, bench_dir)
    return int(reg.config(reg.workload(workload)["config"]).get("devices", 1))


def deadline_s(seconds: float, trace: bool) -> float:
    return SETUP_ALLOWANCE_S + float(seconds) + (TRACE_ALLOWANCE_S if trace else 0.0) \
        + JUDGE_ALLOWANCE_S


def run_ranks(root: Path, workload: str, seed: int, seconds: float, trace: bool, n: int,
              t_start: float, device: str = "cuda", bench_dir: Path = BENCH_DIR,
              fn=None, deadline: Optional[float] = None) -> List[dict]:
    """Run the cell on `n` ranks; every rank's record (`rank_main`'s), in
    rank order; rank 0's "line" is the result line. `fn` stands in for
    rank_main (a module-level function that calls it)."""
    from torch.multiprocessing import ProcessExitedException, ProcessRaisedException

    from femx_torch.parallel import launch

    deadline = deadline_s(seconds, trace) if deadline is None else float(deadline)
    try:
        out = launch(fn or rank_main, n, str(root), str(bench_dir), workload, int(seed),
                     float(seconds), bool(trace), float(t_start), device, deadline,
                     device=device, timeout=deadline, all_ranks=True)
    except (ProcessRaisedException, ProcessExitedException, RuntimeError) as e:
        # a rank raised or exited, or the deadline passed: launch has ended every rank
        raise RanksFailed(f"{n} ranks of {workload}: {e}") from e
    return [r.result for r in out]


def rank_main(root: str, bench_dir: str, workload: str, seed: int, seconds: float,
              trace: bool, t_start: float, device: str, deadline: float) -> dict:
    """One rank's run of the cell: {"rank", "line" (rank 0's result line,
    else None), "attempted", "devices" (solve_info["devices"] of each
    window answer's analysis), "forbidden" (the modules of
    session.forbidden_modules loaded in this rank)}."""
    from femx_torch.parallel import comm
    from harness.session import forbidden_modules, run_cell

    world = World(comm.rank_device(comm.rank(), device), t_start, deadline)
    line = run_cell(Path(root), workload, seed, seconds, trace, world.device, t_start,
                    bench_dir=Path(bench_dir), world=world)
    return {"rank": world.rank, "line": line, "attempted": world.attempted,
            "devices": world.devices_seen, "forbidden": forbidden_modules()}


class World:
    """The ranks of one run, as one rank sees them."""

    def __init__(self, device: torch.device, t_start: float, deadline: float):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.device = device
        self.t_start = t_start
        # the harness's own messages: small, on the host, whatever the program's backend
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=deadline))
        self.attempted = 0
        self.devices_seen: List[Optional[int]] = []

    @property
    def leads(self) -> bool:
        return self.rank == 0

    def go_on(self, flag: bool) -> bool:
        """Rank 0's flag, on every rank."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def window(self, run, seconds: float, stream, serve) -> None:
        """cells._window for N ranks: set-up ends at a barrier of every
        rank, rank 0's clock decides each request, and a request that
        raises ends the run."""
        dist.barrier(group=self.group)
        t0 = time.perf_counter()
        run.setup_s = t0 - self.t_start
        while self.go_on(time.perf_counter() - t0 < seconds):
            req = next(stream)
            run.attempted += 1
            ts = time.perf_counter()
            ans = serve(req)
            run.latencies.append(time.perf_counter() - ts)
            if self._on_every_rank(run, ans):
                run.answers.append(ans)
            else:
                run.failed += 1
        run.window_s = time.perf_counter() - t0
        self.attempted = run.attempted

    def _on_every_rank(self, run, ans) -> bool:
        """Whether the answer's analysis ran on the N ranks: a cases cell's
        is set-up's, an analyses cell's its own. The program falls back to
        one device without raising (solve_info["devices"] is then 1)."""
        info = run.analysis.solve_info if run.analysis is not None else ans.info
        got = info.get("devices")
        self.devices_seen.append(got)
        if got != self.size:
            print(f"rank {self.rank}: the analysis ran on {got} device(s), not {self.size}: "
                  "a failed request", file=sys.stderr)
        return got == self.size

    def profile(self, fn, device):
        """device.profile on rank 0; fn bare, with no summary, elsewhere."""
        if self.leads:
            from harness import device as dev_mod

            return dev_mod.profile(fn, device)
        return fn(), None

    def share_peaks(self, run) -> None:
        """Gather each rank's peak; run.ranks on every rank, and
        run.memory_peak_bytes the fullest card's."""
        recs = [None] * self.size
        dist.all_gather_object(recs, {"rank": self.rank, "device": str(self.device),
                                      "memory_peak_bytes": run.memory_peak_bytes},
                               group=self.group)
        run.ranks = recs
        by_card = {}
        for r in recs:
            if r["memory_peak_bytes"] is not None:
                by_card[r["device"]] = by_card.get(r["device"], 0) + r["memory_peak_bytes"]
        run.memory_peak_bytes = max(by_card.values()) if by_card else None

    def share_spans(self, run) -> None:
        """Take the program trace on every rank (the same requests), and
        gather each rank's span totals into run.ranks[r]["span_s"]
        ({span name: seconds}, or None without a trace)."""
        from harness import program_trace

        trace = program_trace.read(run)
        totals = None
        if trace is not None:
            totals = {n: sum(program_trace.durations(trace, n))
                      for n in {s["name"] for s in trace["spans"]}}
        got = [None] * self.size
        dist.all_gather_object(got, totals, group=self.group)
        for rec, t in zip(run.ranks, got):
            rec["span_s"] = t

    def cards(self, run) -> int:
        """The distinct cards the ranks ran on."""
        return len({r["device"] for r in run.ranks})
