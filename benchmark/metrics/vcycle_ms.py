"""vcycle_ms.*: one application of the analysis' preconditioner (the f32
V-cycle of StructuredMultigrid, or the LatticePreconditioner) to a
residual-shaped vector, after the window: host clock over 50 calls, the
card synchronized before the first and after the last. Reads the analysis'
private `_precond`; without it the metric reads nothing."""

import torch

from harness.device import host_ms


def read(run, reg, name):
    fa, r = run.analysis, run.probe_rhs
    pre = getattr(fa, "_precond", None)
    if pre is None or r is None or run.device.type != "cuda":
        return None
    r32 = r.to(torch.float32)
    return host_ms(lambda: pre(r32), run.device, 50)
