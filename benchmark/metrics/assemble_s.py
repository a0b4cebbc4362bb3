"""assemble_s.*: mean seconds of assemble_stiffness_matrix() per analysis
of a traced window, the card synchronized at both ends of the span."""

from harness.readers import mean_span


def read(run, reg, name):
    return mean_span(run, "assemble")
