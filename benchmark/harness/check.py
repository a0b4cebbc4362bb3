"""The comparison that decides `correct`: once the window has closed and
the program's state is freed, the plain reference (benchmark/reference.py)
works the model out again and judges every answer of the run; each number
compared is the worst over the answers, beside its limit.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

import reference


def judge(config: dict, answers, device: torch.device) -> Tuple[Dict[str, float], float, float]:
    """({number: worst value over the answers}, seconds the reference took,
    the largest relative gap between the program's own residual and the
    reference's reading of it)."""
    t0 = time.perf_counter()
    model = reference.BoxModel(config, device=device)
    worst: Dict[str, float] = {}
    gap = 0.0
    orders: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for a in answers:
        key = id(a.points)
        if key not in orders:  # the points array of one mesh, shared by its answers
            orders[key] = (a.points, model.order_of(np.asarray(a.points)))
        order = orders[key][1]
        u = model.to_reference(a.u, order)
        r = None if a.reactions is None else model.to_reference(a.reactions, order)
        got = model.judge(a.loads, u, r)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
        if a.info.get("residual"):
            gap = max(gap, abs(got["residual"] / a.info["residual"] - 1.0))
    return worst, time.perf_counter() - t0, gap


def compare(worst: Dict[str, float], limits: dict, expected: List[str]) -> Tuple[bool, dict]:
    """(every expected number at or under its limit, {name: {value, limit}});
    a number that is expected and missing (no answer came) fails."""
    out, ok = {}, True
    for name in expected:
        lim = float(limits[name]["limit"])
        val = worst.get(name)
        out[name] = {"value": val, "limit": lim}
        ok = ok and val is not None and val <= lim
    return ok, out
