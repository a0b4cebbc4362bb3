"""peak_device_mib: torch.cuda.max_memory_allocated() over set-up and the
window, read as the window closes, in MiB."""


def read(run, reg, name):
    if run.memory_peak_bytes is None:
        return None
    return run.memory_peak_bytes / 2 ** 20
