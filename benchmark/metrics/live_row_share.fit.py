"""Live rows over rows gathered by the program's gathers in the fit's traced
window, %."""

from benchmark import spans


def read(run):
    return spans.live_row_pct(run)
