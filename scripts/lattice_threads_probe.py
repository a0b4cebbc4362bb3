#!/usr/bin/env python3
"""How the host thread count that factors the lattice multigrid's coarse
inverse moves the unstructured devices=4 solve, on the card.

    python3 scripts/lattice_threads_probe.py [--ranks 4]

Writes chip_smoke.py's relabelled flagship file (a 0.4 x 0.4 x 1.6 box,
24x24x96 cells, 1,390,179 DOF, 1000 N tip load, the 4 corners of z=0
fixed) under build/lattice_threads_probe/ and solves it with
SolidReactionAnalysis(dtype=float32, cg_tol=1e-8), the TG operator with
the float32 lattice multigrid:

  single/<t>:  one device, the multigrid disk cache off, with t host
               threads (torch's default, then 1);
  ranks/off:   devices=<ranks>, the cache off (each rank factors the
               coarse inverse itself, on the one thread launch gives it);
  ranks/seeded: devices=<ranks>, the cache seeded by a one-device run on
               torch's default thread count, so every rank loads that
               hierarchy.

It prints one JSON line per run: iterations and short hashes of the
hierarchy's parts (omegas, every block-Jacobi inverse, the fine mask, the
coarse inverse), then removes its directory. It records; it asserts
nothing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "lattice_threads_probe")
E, NU = 2e11, 0.3


def _hash(a) -> str:
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:12]


def hierarchy_hashes(mg) -> dict:
    return {"omegas": [float(w) for w in mg.omegas],
            "binv": _hash(np.array([_hash(b) for lvl in mg.levels for b in lvl.binv])),
            "mask": _hash(mg.levels[0].op.free_mask_host),
            "coarse_inverse": _hash(mg._coarse_inv)}


def problem():
    corners = [(x, y, 0.0) for x in (0.0, 0.4) for y in (0.0, 0.4)]
    force = [{"force_x": 0.0, "force_y": -1000.0, "force_z": 0.0,
              "force_x_pstn": 0.2, "force_y_pstn": 0.4, "force_z_pstn": 1.6}]
    fix = [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
           for x, y, z in corners]
    return corners, force, fix


def solve(path, cache: str, devices=None) -> dict:
    """One analysis of the file; run in the parent or on every rank."""
    import femx_torch

    os.environ["FEMX_MG_CACHE"] = cache
    _, force, fix = problem()
    fa = femx_torch.SolidReactionAnalysis(path, force, fix, E=E, v=NU, dtype=np.float32,
                                          cg_tol=1e-8, devices=devices, verbose=False)
    fa.run_simulation(report=False)
    mg = fa._dist_solver.dmg.mg if devices else fa._precond.mg
    return {"iterations": fa.solve_info["iterations"], "method": fa.solve_info["method"],
            **hierarchy_hashes(mg)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import femx_torch
    from femx_torch.mesh import relabel_nodes, write_msh
    from femx_torch.parallel import launch

    corners, _, _ = problem()
    os.makedirs(WORK, exist_ok=True)
    try:
        mesh = femx_torch.box_tet10(0.4, 0.4, 1.6, mesh_size=1.6 / 96,
                                    force_points=[(0.2, 0.4, 1.6)], fix_points=corners)
        mesh = relabel_nodes(mesh, np.random.default_rng(0).permutation(mesh.num_nodes))
        path = os.path.join(WORK, "flagship_relabelled.msh")
        write_msh(path, mesh)
        default_threads = torch.get_num_threads()
        for t in (default_threads, 1):
            torch.set_num_threads(t)
            print(json.dumps({"run": f"single/{t}", **solve(path, "0")}), flush=True)
        torch.set_num_threads(default_threads)
        print(json.dumps({"run": "ranks/off", **launch(solve, args.ranks, path, "0",
                                                       args.ranks, timeout=600)}), flush=True)
        cache = os.path.join(WORK, "mg_cache")
        solve(path, cache)
        print(json.dumps({"run": "ranks/seeded", **launch(solve, args.ranks, path, cache,
                                                          args.ranks, timeout=600)}),
              flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
