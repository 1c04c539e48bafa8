"""Host self time of the program's `optimizer` span (Adam over the 50k
Gaussians) in the dense fit's traced window, ms per completed step."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_op(run, "optimizer")
