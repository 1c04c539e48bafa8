"""The dense fit step's floor FLOPs (forward-with-T and backward of both
buckets, benchmark/work.py) over the traced window, as a share of the FP32
peak, %."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run)
