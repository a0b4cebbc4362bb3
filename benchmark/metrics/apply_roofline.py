"""apply_roofline.*: the roofline share of the float64 operator apply that
the CG runs once per iteration (`_op64.apply_constrained`): the least time
the card could take, the larger of the apply's operations over the FP64
tensor-core peak and its bytes over the memory peak (counted by
rooflines/<operator>.py, named by the configuration's route), over the
CUDA-event time of one apply (mean of 100 after 3 warm ones). Reads the
analysis' private `_op64`; without it the metric reads nothing."""

from harness.device import event_ms, peaks_for


def read(run, reg, name):
    fa, x = run.analysis, run.probe_rhs
    op = getattr(fa, "_op64", None)
    if op is None or x is None or run.device.type != "cuda":
        return None
    import torch

    ms = event_ms(lambda: op.apply_constrained(x), run.device, 100)
    flops, nbytes = reg.roofline(run.config["route"]["operator"]).count(run.config)
    peak = peaks_for(torch.cuda.get_device_name(run.device))
    bound_s = max(flops / (peak["fp64_tflops"] * 1e12), nbytes / (peak["tb_per_s"] * 1e12))
    return 100.0 * bound_s / (ms * 1e-3)
