"""Host self time of the program's `launch` spans (the per-tile renderer's
forward and its backward: operand layout, outputs and scratch, the launch)
in the fit's traced window, ms per completed step."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_op(run, "launch")
