"""The dense fit's saved-T backward: its least time over the device time of
csrc/chunked.cu's backward kernels in the traced window, %. The dense
bucket's launch (kernel 8, sgrt_chunked_bwd_t) takes all but a few ms of
it; the sparse bucket's (kernel 3) shares the kernels' names and is
counted in both the work and the time."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "bwd")
