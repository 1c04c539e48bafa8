"""What the metric readers under benchmark/metrics/ compute, from a run's
host-clock record, its trace and the work counted from its inputs
(benchmark/work.py). A reader that finds nothing to read returns None."""

from __future__ import annotations

import numpy as np

from benchmark import work


def rays_per_s(run):
    """All rays of the window's completed operations over its wall time."""
    rec = run.record
    if not rec["completed"] or rec["window_s"] <= 0:
        return None
    return rec["rays"] / rec["window_s"]


def p95_ms(run):
    """The 95th percentile of the operations' host-clock latencies, in ms."""
    lat = run.record.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3


def _total(run, parts):
    total = work.Work()
    for op in run.work or ():
        for part in parts:
            if part in op:
                total = total + op[part]
    return total


def mfu_pct(run, parts=("fwd", "bwd")):
    """The traced operations' floor FLOPs over the traced window's wall
    time, as a share of the card's FP32 peak, in %."""
    if run.trace is None or not run.work:
        return None
    return work.flops_share_pct(_total(run, parts), run.trace.window_s)


def roofline_pct(run, part):
    """The least time of the traced operations' `part` work over the
    device time of that part's kernels, in %."""
    if run.trace is None or not run.work or not run.trace.group_s.get(part):
        return None
    return work.share_pct(_total(run, (part,)), run.trace.group_s[part])


def launches_per_op(run):
    if run.launches is None or not run.record["completed"]:
        return None
    return run.launches / run.record["completed"]


def idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.trace.idle_share()


def peak_gib(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30
