"""kernels_per_case.*: kernels the device ran (copies and fills left out)
in the one case a traced run sends under the profiler."""


FROM_TRACE = True


def read(run, reg, name):
    if run.profile is None or run.mix["kind"] != "cases" or run.device.type != "cuda":
        return None
    return run.profile["kernels"]
