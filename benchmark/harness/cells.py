"""The two kinds of cell: a closed loop of load cases on one analysed model
("cases"), and a closed loop of whole analyses, each a new model
("analyses").

Set-up builds the model from the configuration and the seed, and warms the
cell's own shapes with requests from the warm-up stream; the window then
sends one request at a time until `seconds` have passed, and the last
request started in it ends it. Every answer is kept on the host for the
reference to judge once the window has closed.
"""

from __future__ import annotations

import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

import reference
from harness import device as dev_mod
from harness import traffic


class Answer:
    """What the program answered to one request."""

    def __init__(self, loads, u, points, reactions=None, info=None):
        self.loads = loads
        self.u = u
        self.points = points
        self.reactions = reactions
        self.info = info or {}


class Run:
    """The record of one run: set-up, the window, the answers and, when
    traced, the spans and the trace's summary. The metric readers read it."""

    def __init__(self, config: dict, mix: dict, device: torch.device, trace: bool):
        self.config = config
        self.mix = mix
        self.device = device
        self.trace = trace
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.latencies: List[float] = []
        self.answers: List[Answer] = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes: Optional[int] = None
        self.spans: Dict[str, List[float]] = {}
        self.profile: Optional[dict] = None
        self.profiled_requests = 0
        self.analysis = None  # the analysis the cases run on (cases cells)
        self.probe_rhs = None  # a residual-shaped vector of that analysis
        self.take_trace = None  # sends the traced requests (set by the cell)
        self.world = None  # the ranks of a devices=N cell (harness.ranks.World)
        self.ranks = None  # with N ranks: one record a rank (its card, peak, span totals)

    @property
    def leads(self) -> bool:
        """This process profiles, reads the metrics and judges: the only
        one, or rank 0 of N."""
        return self.world is None or self.world.leads

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


def program_loads(loads: List[dict]) -> List[dict]:
    """The request in the program's force_data format."""
    return [{"force_x": p["fx"], "force_y": p["fy"], "force_z": p["fz"],
             "force_x_pstn": p["x"], "force_y_pstn": p["y"], "force_z_pstn": p["z"]}
            for p in loads]


class Model:
    """The configuration as the program runs it."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        import femx_torch  # noqa: F401  (the program; imported once set-up starts)

        self.config = config
        self.device = device
        self.dims = tuple(float(v) for v in config["box"]["dims_m"])
        self.mesh_size = float(config["mesh_size_m"])
        self.fix_points = [(s["x"], s["y"], s["z"]) for s in config["supports"]]
        self.fix_data = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
                         for x, y, z in self.fix_points]
        self.route = config["route"]
        self.relabel = None
        if self.route.get("relabel_nodes"):
            n = int(np.prod([2 * c + 1 for c in reference.box_cells(config)]))
            self.relabel = traffic.model_rng(seed).permutation(n)

    def mesh(self, force_points):
        from femx_torch.mesh import box_tet10, relabel_nodes

        mesh = box_tet10(*self.dims, self.mesh_size, force_points=force_points,
                         fix_points=self.fix_points)
        if self.route.get("relabel_nodes"):
            mesh = relabel_nodes(mesh, self.relabel)
        elif mesh.structured is None:
            raise ValueError("a load point moved a node: the box lost its lattice")
        return mesh

    def analysis(self, mesh, loads):
        from femx_torch import SolidReactionAnalysis

        s = self.config["solver"]
        return SolidReactionAnalysis(
            mesh, program_loads(loads), self.fix_data,
            E=self.config["material"]["E_pa"], v=self.config["material"]["nu"],
            dtype=np.dtype(s["dtype"]), cg_tol=float(s["cg_tol"]), solver=s["solver"],
            structured_apply=self.route.get("structured_apply"),
            unstructured_operator=self.route.get("unstructured_operator"),
            verbose=False, device=self.device, devices=self.config.get("devices"))


def _points(loads):
    return [(p["x"], p["y"], p["z"]) for p in loads]


def _window(run: Run, seconds: float, stream, serve) -> None:
    """The closed loop: serve(request) until `seconds` have passed."""
    if run.world is not None:
        return run.world.window(run, seconds, stream, serve)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        req = next(stream)
        run.attempted += 1
        ts = time.perf_counter()
        try:
            run.answers.append(serve(req))
        except Exception:  # a request that fails is counted, and the loop goes on
            run.failed += 1
            traceback.print_exc(file=sys.stderr)
        run.latencies.append(time.perf_counter() - ts)
    run.window_s = time.perf_counter() - t0


def _traced(run: Run, serve, seed: int) -> None:
    """Two more requests, both the same, kept as answers; the spans stay
    those of the window. The first runs without the profiler, and its span
    on the host clock, the card synchronized at both ends, is the traced
    window. The second runs under the profiler, whose trace gives the
    device's busy time, the kernels and `breakdown`; the profiler's own
    host work stretches that request, and its span is not the window."""
    spans = {k: list(v) for k, v in run.spans.items()}
    req = traffic.traced_request(seed, run.mix)
    dev_mod.sync(run.device)
    t0 = time.perf_counter()
    run.answers.append(serve(req))
    dev_mod.sync(run.device)
    window_s = time.perf_counter() - t0
    profile = dev_mod.profile if run.world is None else run.world.profile
    ans, run.profile = profile(lambda: serve(req), run.device)
    run.answers.append(ans)
    if run.profile is not None:
        run.profile["window_s"] = window_s
    run.spans = spans
    run.profiled_requests = 2


def run_cases(run: Run, seed: int, seconds: float, t_start: float) -> None:
    """A closed loop of load cases, one solve_cases([case]) each, on the
    model analysed in set-up."""
    cfg, mix = run.config, run.mix
    model = Model(cfg, seed, run.device)
    warm = traffic.warmup_requests(seed, mix, 2)
    mesh = model.mesh(traffic.load_points(mix))
    fa = model.analysis(mesh, warm[0])
    fa.run_simulation()
    fa.solve_cases([program_loads(warm[1])])
    dev_mod.sync(run.device)
    run.analysis = fa
    op = fa.operator
    to_int = getattr(op, "to_internal", lambda v: v)
    fg = fa.constraints.free_mask() * _load_vector(fa, warm[1])
    run.probe_rhs = torch.as_tensor(to_int(fg), dtype=torch.float64, device=run.device)

    def serve(req):
        U = fa.solve_cases([program_loads(req)])
        return Answer(req, U[0], fa.points, info=dict(fa.case_solve_info[0]))

    run.setup_s = time.perf_counter() - t_start
    _window(run, seconds, traffic.requests(seed, mix), serve)
    run.memory_peak_bytes = _memory_peak(run.device)
    run.take_trace = lambda: _traced(run, serve, seed)


def _load_vector(fa, loads) -> np.ndarray:
    from femx_torch import bc

    return bc.solid_point_loads(fa.mesh, program_loads(loads), fa.neumann_nodes)[0]


def run_analyses(run: Run, seed: int, seconds: float, t_start: float) -> None:
    """A closed loop of whole analyses: each request a new mesh with its
    load points, a new SolidReactionAnalysis, run_simulation, reactions.
    Traced, the analysis calls run_simulation's four methods in its order,
    with a span around each stage."""
    cfg, mix = run.config, run.mix
    model = Model(cfg, seed, run.device)

    def serve(req):
        t = time.perf_counter()
        mesh = model.mesh(_points(req))
        if not run.trace:
            fa = model.analysis(mesh, req)
            fa.run_simulation()
        else:
            run.span("mesh", time.perf_counter() - t)
            fa = model.analysis(mesh, req)
            dev_mod.sync(run.device)
            t = time.perf_counter()
            fa.assemble_stiffness_matrix()
            dev_mod.sync(run.device)
            run.span("assemble", time.perf_counter() - t)
            fa.apply_boundary_conditions()
            t = time.perf_counter()
            fa.solve()
            run.span("solve", time.perf_counter() - t)
            fa.print_reactions()
        return Answer(req, fa.u, fa.points, reactions=fa.reaction_forces,
                      info=dict(fa.solve_info))

    serve(traffic.warmup_requests(seed, mix, 1)[0])
    run.spans.clear()
    dev_mod.sync(run.device)
    run.setup_s = time.perf_counter() - t_start
    _window(run, seconds, traffic.requests(seed, mix), serve)
    run.memory_peak_bytes = _memory_peak(run.device)
    run.take_trace = lambda: _traced(run, serve, seed)


def _memory_peak(device: torch.device) -> Optional[int]:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else None


KINDS = {"cases": run_cases, "analyses": run_analyses}
