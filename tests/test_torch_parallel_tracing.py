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

from femx_torch.parallel import launch, rank_checks
from torch_parallel_counts import bytes_of_one_solve, traced_cases_args

TIMEOUT = 240.0


@pytest.fixture(scope="module")
def traced():
    return launch(rank_checks.traced_cases, 2, *traced_cases_args(), device="cpu",
                  timeout=TIMEOUT)


def _names(rec):
    return Counter(s["name"] for s in rec["spans"])


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
    want = sum(bytes_of_one_solve(traced, i["iterations"])
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
