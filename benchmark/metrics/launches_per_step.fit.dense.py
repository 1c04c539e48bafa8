"""The program's kernel launches (ops/kernels.py counters) over the dense
fit's window, per completed step."""

from benchmark import readers


def read(run):
    return readers.launches_per_op(run)
