"""Host self time of the program's `launch` spans (the buckets' renderers,
forward and backward: operand layout, outputs and scratch, the launch) in
the dense fit's traced window, ms per completed step."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_op(run, "launch")
