"""Share of the dense fit's traced window in which no operation ran on the
device, %."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
