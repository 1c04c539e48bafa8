"""torch.cuda.max_memory_allocated over the fit's window, after
reset_peak_memory_stats, GiB."""

from benchmark import readers


def read(run):
    return readers.peak_gib(run)
