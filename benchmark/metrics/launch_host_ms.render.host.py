"""Host self time of the program's `launch` span (the per-tile renderer's
forward: operand layout, output, the launch) in the cube orbit's traced
window, ms per completed frame."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_op(run, "launch")
