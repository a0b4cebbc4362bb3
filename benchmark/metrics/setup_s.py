"""setup_s: process start to the first timed request (imports, CUDA
initialisation, mesh, operators, preconditioner, warm-up; in a checkout's
first run also the kernels' build). Host clock."""


def read(run, reg, name):
    return run.setup_s
