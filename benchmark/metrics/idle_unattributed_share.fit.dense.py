"""Share of the dense fit's traced idle time whose gap begins with no
program span open, %."""

from benchmark import spans


def read(run):
    return spans.unattributed_idle_pct(run)
