#!/usr/bin/env python3
"""femx's float32 solve scheme against femx_torch's on the corner-fixed
flagship, on the card.

    python3 scripts/flagship_f32_schemes.py [--cells 24 24 96] [--device cuda]

Builds the flagship of chip_smoke.py (a 0.4 x 0.4 x 1.6 box, 24x24x96 cells,
1,390,179 DOF, 1000 N tip load, the 4 corners of z=0 fixed) and solves it
with the same float32 V-cycle in two ways:

  refined: femx's scheme (femx/analysis/solid.py:584-600): float32 CG with
           float64 refinement against the float32 cell matrix cast up
           (pcg_refined, refine_steps=8, inner tol 1e-5, true residual 1e-8);
  mixed:   femx_torch's scheme: float64 CG on the float64-assembled operator,
           preconditioned by the float32 V-cycle (pcg_mixed, tol 1e-8).

It prints one JSON line per scheme: iterations, relative residual, seconds,
and the reactions' equilibrium residual (applied + reactions, N) from the
float64-assembled operator and, for the refined scheme, from the cast-up
operator femx takes its reactions from. It records; it asserts nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, nargs=3, default=(24, 24, 96))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import femx_torch
    from femx_torch.assembly_structured import StructuredSolidOperator
    from femx_torch.solve.cg import pcg_mixed, pcg_refined
    from femx_torch.solve.multigrid import StructuredMultigrid

    E, NU, load = 2e11, 0.3, 1000.0
    nx, ny, nz = args.cells
    h = 0.4 / nx
    dims = (0.4, ny * h, nz * h)
    corners = [(x, y, 0.0) for x in (0.0, dims[0]) for y in (0.0, dims[1])]
    tip = (dims[0] / 2, dims[1], dims[2])
    mesh = femx_torch.box_tet10(*dims, mesh_size=h, force_points=[tip], fix_points=corners)
    fa = femx_torch.SolidReactionAnalysis(
        mesh, [{"force_x": 0.0, "force_y": -load, "force_z": 0.0, "force_x_pstn": tip[0],
                "force_y_pstn": tip[1], "force_z_pstn": tip[2]}],
        [{"pos_x": x, "pos_y": y, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
         for x, y, z in corners], E=E, v=NU, dtype=np.float32, verbose=False,
        device=args.device)
    fa.assemble_stiffness_matrix()
    fa.apply_boundary_conditions()
    mask = fa.constraints.free_mask()
    op = fa.operator.with_free_mask(fa.operator.to_internal(mask))
    mg = StructuredMultigrid(None, mesh.structured.n_cells, E, NU, mask, dtype=np.float32,
                             fine_op=op, spacing=mesh.structured.spacing, device=args.device)
    b = torch.as_tensor(op.to_internal(fa.f * mask), device=args.device)
    op_cast = op.astype(np.float64)
    op_f64 = StructuredSolidOperator.from_mesh(
        mesh, E, NU, dtype=np.float64, device=args.device).with_free_mask(op.free_mask_host)

    def equilibrium(x, K):
        r = op.to_global(K.apply(x).cpu().numpy())
        return (np.array([0.0, -load, 0.0]) + sum(
            r[3 * i["node_idx"]:3 * i["node_idx"] + 3] for i in fa.fixed_nodes_info)).tolist()

    def timed(fn):
        if args.device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if args.device != "cpu":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    t, ref = timed(lambda: pcg_refined(
        op.apply_constrained, b.float(), M_inv_diag=mg, tol=1e-5, refine_steps=8,
        A_residual=op_cast.apply_constrained, b_residual=b, outer_tol=1e-8))
    print(json.dumps({"scheme": "refined", "ndof": op.ndof, "iterations": ref.iterations,
                      "true_residual": ref.residual_norm, "converged": ref.converged,
                      "seconds": t, "equilibrium_f64_operator": equilibrium(ref.x, op_f64),
                      "equilibrium_cast_up_operator": equilibrium(ref.x, op_cast)}))
    t, mixed = timed(lambda: pcg_mixed(op_f64.apply_constrained, b, mg, tol=1e-8))
    print(json.dumps({"scheme": "mixed", "ndof": op.ndof, "iterations": mixed.iterations,
                      "residual": mixed.residual_norm, "converged": mixed.converged,
                      "seconds": t, "equilibrium_f64_operator": equilibrium(mixed.x, op_f64)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
