"""The backward's least time over the device time of csrc/chunked.cu's
backward kernels, in the fit's traced window, %."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "bwd")
