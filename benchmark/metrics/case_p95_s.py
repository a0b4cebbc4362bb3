"""case_p95_s: the 95th percentile (linear between order statistics) of
the latencies of all load cases sent in the window. Host clock, each case
from its call to its answer on the host."""

import numpy as np


def read(run, reg, name):
    if run.mix["kind"] != "cases" or not run.latencies:
        return None
    return float(np.percentile(run.latencies, 95))
