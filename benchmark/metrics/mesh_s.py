"""mesh_s.*: mean seconds of the mesh generator (box_tet10, with the node
relabelling where the route takes it) per analysis of a traced window; host clock in
the benchmark's own span."""

from harness.readers import mean_span


def read(run, reg, name):
    return mean_span(run, "mesh")
