"""What the benchmark takes from the program's trace module
(sgrt_tpu_torch.utils.trace): the names of its spans and its row counter.
The only module of the benchmark besides benchmark/program.py and the
drivers that imports the program. A program without that module (an older
tree) gives None, so the metrics that read it are left out."""

from __future__ import annotations


def _trace():
    try:
        from sgrt_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def span_names() -> tuple[str, ...] | None:
    """The program's span names, one a layer."""
    trace = _trace()
    return None if trace is None else tuple(trace.SPANS)


def rows() -> tuple[int, int] | None:
    """(rows gathered, live rows) the program counted while a profiler
    recorded: in a run, the traced window's alone."""
    trace = _trace()
    return None if trace is None else trace.rows()
