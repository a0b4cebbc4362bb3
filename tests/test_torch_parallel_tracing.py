"""The spans and counters of the multi-rank solid route
(femx_torch.profiling's names, documented there), on two gloo ranks on
the CPU: pcg_dist's cg.apply / cg.precond / cg.wait and cg.iterations, one
solid.case a load case, a dmg.level span for every distributed level, the
collectives' comm.bytes against a count by hand of what one solve hands
them, and with tracing off nothing recorded and the same answers, bit for
bit."""

from collections import Counter

import numpy as np
import pytest

import femx_torch
from femx_torch.parallel import launch, rank_checks

H = 0.05
CELLS = (8, 8, 8)  # 8 % (2 x 2) = 0 and 4 % (2 x 2) = 0: two distributed levels, no padding
TIMEOUT = 240.0
F64, F32 = 8, 4


def _case(fy):
    return [{"force_x": 0.0, "force_y": fy, "force_z": 300.0,
             "force_x_pstn": CELLS[0] * H / 2, "force_y_pstn": CELLS[1] * H,
             "force_z_pstn": CELLS[2] * H / 2}]


@pytest.fixture(scope="module")
def traced():
    mesh = femx_torch.box_tet10_from_cells(CELLS, (H, H, H))
    fixes = [{"pos_x": x, "pos_y": 0.0, "pos_z": z, "fix_x": 0, "fix_y": 0, "fix_z": 0}
             for x in (0.0, CELLS[0] * H) for z in (0.0, CELLS[2] * H)]
    kw = dict(E=2e11, v=0.3, dtype=np.float32, cg_tol=1e-8, devices=2, device="cpu")
    return launch(rank_checks.traced_cases, 2, mesh, _case(-1000.0), fixes, kw,
                  [_case(-2000.0), _case(-500.0)], device="cpu", timeout=TIMEOUT)


def _names(rec):
    return Counter(s["name"] for s in rec["spans"])


def _plane(cells):
    """Entries of one xy plane of a level's nodes (3 components)."""
    return 3 * (2 * cells[0] + 1) * (2 * cells[1] + 1)


def _bytes_of_one_solve(out, iterations):
    """What pcg_dist, the halo applies, the V-cycle and the answer's gather
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


def test_pcg_dist_spans_every_iteration_and_the_start(traced):
    names = _names(traced["on"])
    its = [i["iterations"] for i in traced["case_solve_info"]]
    assert all(i > 0 for i in its)
    for name in ("cg.apply", "cg.precond", "cg.wait"):
        assert names[name] == sum(its) + len(its), name
    assert traced["on"]["counters"]["cg.iterations"] == sum(its)
    assert traced["on"]["counters"]["dmg.vcycle_calls"] == sum(its) + len(its)


def test_one_solid_case_a_case_and_its_solve_inside(traced):
    spans = traced["on"]["spans"]
    by_id = {s["id"]: s for s in spans}
    names = _names(traced["on"])
    assert names["solid.case"] == names["solid.cg"] == 2
    assert names["dist.rhs"] == names["dist.gather"] == 2
    for s in spans:
        if s["name"] == "solid.cg":
            assert by_id[s["parent"]]["name"] == "solid.case"
        if s["name"] in ("dist.rhs", "dist.gather"):
            assert by_id[s["parent"]]["name"] == "solid.cg"
    # every span of a case is inside its solid.case
    cases = {s["id"] for s in spans if s["name"] == "solid.case"}
    assert all(s["request"] in {by_id[c]["request"] for c in cases} for s in spans)


def test_dmg_levels_every_distributed_level(traced):
    n_dist = traced["solve_info"]["distributed_levels"]
    assert n_dist == len(traced["local_cells"]) == 2
    calls = sum(i["iterations"] + 1 for i in traced["case_solve_info"])
    levels = Counter(s["attrs"]["level"] for s in traced["on"]["spans"]
                     if s["name"] == "dmg.level")
    assert levels == {k: calls for k in range(n_dist)}
    names = _names(traced["on"])
    assert names["dmg.handoff"] == calls
    assert names["halo.exchange"] > 0
    # the replicated levels run inside the hand-off, as the single-device V-cycle's
    by_id = {s["id"]: s for s in traced["on"]["spans"]}
    for s in traced["on"]["spans"]:
        if s["name"] == "mg.level" and by_id[s["parent"]]["name"] != "mg.level":
            assert by_id[s["parent"]]["name"] == "dmg.handoff"


def test_comm_bytes_match_a_count_by_hand(traced):
    want = sum(_bytes_of_one_solve(traced, i["iterations"])
               for i in traced["case_solve_info"])
    assert traced["on"]["counters"]["comm.bytes"] == want
    # an exchange is one all_gather, spanned inside it
    spans = traced["on"]["spans"]
    by_id = {s["id"]: s for s in spans}
    names = _names(traced["on"])
    inner = sum(1 for s in spans if s["name"] == "comm.all_gather"
                and by_id[s["parent"]]["name"] == "comm.exchange")
    assert inner == names["comm.exchange"] > 0
    # b.b, then r.r with r.z; each iteration p.Ap, then r.r with r.z
    assert names["comm.all_reduce"] == sum(2 + 2 * i["iterations"]
                                           for i in traced["case_solve_info"])


def test_tracing_off_records_nothing_and_changes_no_bit(traced):
    assert traced["off"] == {"spans": [], "counters": {}}
    assert np.array_equal(traced["u_off"], traced["u_on"])
