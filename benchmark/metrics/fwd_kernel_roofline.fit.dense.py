"""The dense fit's forward-with-T: its least time over the device time of
csrc/chunked.cu's fwd_kernel launches in the traced window, %. The dense
bucket's launch (kernel 6, sgrt_chunked_fwd_t) takes all but a few ms of
it; the sparse bucket's (kernel 2 at 32 rows) shares the kernel's name and
is counted in both the work and the time."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "fwd")
