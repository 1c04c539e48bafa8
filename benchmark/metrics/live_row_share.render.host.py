"""Live rows over rows gathered by the program's gather in the cube orbit's
traced window, %."""

from benchmark import spans


def read(run):
    return spans.live_row_pct(run)
