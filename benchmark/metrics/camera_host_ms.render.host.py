"""Host self time of the program's `camera` span in the cube orbit's traced
window, ms per completed frame."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_op(run, "camera")
