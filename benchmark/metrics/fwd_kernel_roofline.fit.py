"""The forward-with-T's least time over the device time of csrc/chunked.cu's
fwd_kernel launches, in the fit's traced window, %."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "fwd")
