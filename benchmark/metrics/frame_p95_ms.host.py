"""95th percentile of the window's frames, each from its call to its image on
the host, ms."""

from benchmark import readers


def read(run):
    return readers.p95_ms(run)
