"""Shared by tests/test_torch_parallel_tracing.py,
tests/test_torch_dist_vcycle_graph.py and tests/test_torch_cuda.py (not a
test file): the small box they solve on two ranks, what one structured
solve hands the collectives, counted by hand from its shapes, and the two
analyses that run every route calling a DistributedMultigrid."""

import numpy as np

import femx_torch
from femx_torch.mesh import relabel_nodes

H = 0.05
CELLS = (8, 8, 8)  # 8 % (2 x 2) = 0 and 4 % (2 x 2) = 0: two distributed levels, no padding
F64, F32 = 8, 4


def case(fy):
    return [{"force_x": 0.0, "force_y": fy, "force_z": 300.0,
             "force_x_pstn": CELLS[0] * H / 2, "force_y_pstn": CELLS[1] * H,
             "force_z_pstn": CELLS[2] * H / 2}]


def traced_cases_args():
    """rank_checks.traced_cases' arguments: the box on two CPU ranks,
    float32, its four bottom corners fixed, and two load cases."""
    mesh = femx_torch.box_tet10_from_cells(CELLS, (H, H, H))
    fixes = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x in (0.0, CELLS[0] * H) for z in (0.0, CELLS[2] * H)]
    kw = dict(E=2e11, v=0.3, dtype=np.float32, cg_tol=1e-8, devices=2, device="cpu")
    return mesh, case(-1000.0), fixes, kw, [case(-2000.0), case(-500.0)]


def _plane(cells):
    """Entries of one xy plane of a level's nodes (3 components)."""
    return 3 * (2 * cells[0] + 1) * (2 * cells[1] + 1)


def bytes_of_one_solve(out, iterations):
    """What pcg, the halo applies, the V-cycle and the answer's gather
    hand the collectives in one structured solve, counted from the shapes:
    float64 CG (bb; r.r and r.z; p.Ap and the next r.r, r.z each iteration)
    and halo apply (one exchange of the first and the ghost planes each
    apply), the float32 V-cycle (per distributed level the two smoothing
    passes' and the residual's applies, then one exchange of the coarse
    level's first plane and half the fine odd plane; the hand-off's
    all_gather of this rank's coarse slab), and the all_gather of x."""
    calls = iterations + 1  # the start and each iteration: one apply and one V-cycle
    dots = F64 * (1 + 2 + 3 * iterations)
    fine = out["local_cells"][0]
    applies = calls * 2 * _plane(fine) * F64
    vcycle = 0
    levels = out["local_cells"]
    for k, cells in enumerate(levels):
        coarse = levels[k + 1] if k + 1 < len(levels) else (cells[0] // 2, cells[1] // 2,
                                                             cells[2] // 2)
        vcycle += (2 * out["n_smooth"] + 1) * 2 * _plane(cells) * F32
        vcycle += 2 * _plane(coarse) * F32
    last = levels[-1]
    handoff_nodes = (2 * (last[0] // 2) + 1) * (2 * (last[1] // 2) + 1) * (last[2] + 1)
    vcycle += 3 * handoff_nodes * F32
    ndof_local = 3 * (2 * fine[0] + 1) * (2 * fine[1] + 1) * (2 * fine[2] + 1)
    return dots + applies + calls * vcycle + ndof_local * F64


def routes_args(route, device, checkpoint_dir=None):
    """rank_checks.replayed_and_eager's arguments for one of the routes
    that call a DistributedMultigrid, on two ranks: "structured", the
    float32 devices=2 solve of a 4 x 4 x 8 box checkpointed in chunks of
    10, two load cases and modal with refine (its own hierarchy);
    "unstructured", a 4 x 4 x 16 box relabelled, above the dense route, in
    float64, and one load case (DistributedUnstructuredSolver's lattice
    coarse correction, which its solve, load cases and modal's inner
    solves call alike)."""
    cells = (4, 4, 8) if route == "structured" else (4, 4, 16)
    mesh = femx_torch.box_tet10_from_cells(cells, (H, H, H))
    fixes = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x in (0.0, cells[0] * H) for z in (0.0, cells[2] * H)]
    force = {"force_x": 0.0, "force_y": -500.0, "force_z": 0.0,
             "force_x_pstn": cells[0] * H / 2, "force_y_pstn": cells[1] * H,
             "force_z_pstn": cells[2] * H / 2}
    cases = [[force], [dict(force, force_x=200.0, force_y=0.0)]]
    kw = dict(E=2e11, v=0.3, cg_tol=1e-10, devices=2, device=device)
    if route == "structured":
        kw["dtype"] = np.float32
        return (mesh, [force], fixes, kw, cases, dict(n_modes=3, tol=1e-8, refine=True),
                checkpoint_dir)
    mesh = relabel_nodes(mesh, np.random.default_rng(7).permutation(mesh.num_nodes))
    return mesh, [force], fixes, kw, cases[1:], None, None


def check_routes(out, replayed):
    """Both passes of rank_checks.replayed_and_eager gave the same bits and
    iterations; the first replayed (every DistributedMultigrid captured at
    its second call and replayed from then on) or stayed eager. Returns
    the first pass's captures."""
    rep, eag = out["replayed"], out["eager"]
    assert rep["solve_info"]["devices"] == 2 and rep["solve_info"]["converged"]
    assert "cases" in eag and ("omega" in eag) == ("omega" in rep)
    for k in ("u", "reactions", "cases", "omega", "modes"):
        if k in eag:  # u and reactions where the second pass solved anew
            assert np.array_equal(rep[k], eag[k]), k

    def info(d):  # times left out; each pass checkpoints to a file of its own
        return {k: v for k, v in d.items() if k != "checkpoint" and not k.endswith("_s")}

    if "solve_info" in eag:
        assert info(rep["solve_info"]) == info(eag["solve_info"])
    assert [info(i) for i in rep["case_solve_info"]] == [info(i) for i in eag["case_solve_info"]]
    assert info(rep.get("modal_info", {})) == info(eag.get("modal_info", {}))
    c = out["counters"]
    calls = c["dmg.vcycle_calls"]
    assert calls > 0
    if not replayed:
        assert c == {"dmg.vcycle_calls": calls}
        return 0
    captures = c["dmg.graph_captures"]
    assert captures >= 1 and c["dmg.graph_replays"] == calls - captures
    return captures
