"""torch.cuda.max_memory_allocated over the dense fit's window, after
reset_peak_memory_stats, GiB: the saved T of the dense bucket and its
backward's scratch at their peak."""

from benchmark import readers


def read(run):
    return readers.peak_gib(run)
