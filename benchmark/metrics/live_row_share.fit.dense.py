"""Live rows over rows gathered by the program's gathers (both buckets) in
the dense fit's traced window, %."""

from benchmark import spans


def read(run):
    return spans.live_row_pct(run)
