#!/usr/bin/env python3
"""The control of `correct`, and the faults it must catch.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

runs the cell as benchmark/run.py does, once per seed in one process, with
the program's float32 path in place of the float64 solve that the
configuration states: float32 CG on the float32 operator with the same
float32 preconditioner (femx_torch.solve.cg.pcg), and in whole analyses the
reactions from the float32 operator. It prints, per seed, each number
compared beside its limit; the control has to come out not correct. The
benchmark's own runs never run it.

The faults (`FAULTS`) break the timed path the same way, for the tests:
an answer returned unchanged from the CG's start, an answer altered where it
is produced, and a request that never gets its answer.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _f32_solve(fa, f_global):
    """u (global order, float64 host) of the float32 path for load f."""
    import torch

    from femx_torch.solve.cg import pcg

    op = fa.operator
    to_int = getattr(op, "to_internal", lambda v: v)
    to_glob = getattr(op, "to_global", lambda v: v)
    f = torch.as_tensor(to_int(f_global * fa.constraints.free_mask()), dtype=torch.float32,
                        device=fa.device)
    r = pcg(op.apply_constrained, f, M_inv_diag=fa._precond, tol=fa.cg_tol, maxiter=300)
    return r, to_glob(r.x.double().cpu().numpy())


@contextlib.contextmanager
def control():
    """The program's float32 path in place of its float64 solve."""
    import numpy as np
    import torch

    from femx_torch import SolidReactionAnalysis, bc

    solve, solve_cases = SolidReactionAnalysis.solve, SolidReactionAnalysis.solve_cases

    def solve32(self):
        solve(self)
        _, u = _f32_solve(self, self.f)
        op = self.operator
        to_int = getattr(op, "to_internal", lambda v: v)
        to_glob = getattr(op, "to_global", lambda v: v)
        u_int = torch.as_tensor(to_int(u), dtype=torch.float32, device=self.device)
        self.u = u
        self.reaction_forces = to_glob(op.apply(u_int).double().cpu().numpy())

    def cases32(self, force_cases, tol=None):
        us, infos = [], []
        for case in force_cases:
            f = bc.solid_point_loads(self.mesh, case, self.neumann_nodes)[0]
            r, u = _f32_solve(self, f)
            us.append(u)
            infos.append({"iterations": int(r.iterations), "residual": float(r.residual_norm),
                          "converged": bool(r.converged)})
        self.case_solve_info = infos
        return np.stack(us)

    SolidReactionAnalysis.solve, SolidReactionAnalysis.solve_cases = solve32, cases32
    try:
        yield
    finally:
        SolidReactionAnalysis.solve, SolidReactionAnalysis.solve_cases = solve, solve_cases


@contextlib.contextmanager
def _wrap_answers(change):
    """solve() and solve_cases() as the program has them, their answers
    passed through change(u) where they are produced."""
    import numpy as np

    from femx_torch import SolidReactionAnalysis

    solve, solve_cases = SolidReactionAnalysis.solve, SolidReactionAnalysis.solve_cases

    def solve_f(self):
        solve(self)
        self.u = change(self.u)

    def cases_f(self, force_cases, tol=None):
        return np.stack([change(u) for u in solve_cases(self, force_cases, tol)])

    SolidReactionAnalysis.solve, SolidReactionAnalysis.solve_cases = solve_f, cases_f
    try:
        yield
    finally:
        SolidReactionAnalysis.solve, SolidReactionAnalysis.solve_cases = solve, solve_cases


def unchanged():
    """The CG returns its starting state: every answer is zero."""
    return _wrap_answers(lambda u: 0.0 * u)


def altered():
    """One displacement of each answer is off by a tenth of the largest."""
    def change(u):
        u = u.copy()
        k = int(abs(u).argmax())
        u[k] += 0.1 * abs(u[k])
        return u
    return _wrap_answers(change)


@contextlib.contextmanager
def dropped():
    """Every second load case never gets its answer."""
    from femx_torch import SolidReactionAnalysis

    solve_cases = SolidReactionAnalysis.solve_cases
    calls = [0]

    def cases_f(self, force_cases, tol=None):
        calls[0] += 1
        if calls[0] % 2 == 0:
            raise RuntimeError("fault: this case's answer never comes")
        return solve_cases(self, force_cases, tol)

    SolidReactionAnalysis.solve_cases = cases_f
    try:
        yield
    finally:
        SolidReactionAnalysis.solve_cases = solve_cases


FAULTS = {"unchanged": unchanged, "altered": altered, "dropped": dropped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import run as bench_run

    bench_run.isolate()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    from harness.session import run_cell

    for seed in args.seeds:
        with control():
            res = run_cell(ROOT, args.workload, seed, args.seconds, False,
                           torch.device("cuda", 0), time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "compared": res["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
