"""The program's spans in a traced window: each span's host self time, and
the idle time of the device that begins with no program span open.

A span's self time is its duration less the union of the spans of the
program and of the harness that lie inside it, on any thread: the autograd
engine runs a CUDA backward's functions on a device thread of its own
while the caller waits. Torch's own annotations (Optimizer.step#Adam.step)
are not children. The idle gaps are those of benchmark/profiling.py's
summarize(): the stretches of the `window` span in which no kernel, copy
or fill runs on the device. A gap is unattributed when no program span is
open on any thread where it begins.

The harness hands a reader the trace's summary, which keeps no span. The
torch profiler of the traced window is still alive in the harness's
run_cell (its local `tracer`) while it calls the readers, so layer_times()
takes the events from there: the frame that holds the very run the reader
was given. A trace saves once, so the events are read from the profiler's
results rather than from a second export.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys

from torch.autograd import DeviceType

from benchmark import program_trace
from benchmark.profiling import DEVICE_CATS, WINDOW_SPAN, _labeller

# the spans the harness and its drivers open (benchmark/harness.py,
# benchmark/drivers/*.py)
HARNESS_SPANS = (WINDOW_SPAN, "camera_rays", "step_call", "work_snapshot", "sync",
                 "frame_call", "image_to_host")
SPAN_CAT = "user_annotation"


@dataclasses.dataclass
class SpanTimes:
    self_s: dict           # program span name → host self time in the window, s
    count: dict            # program span name → spans in the window
    idle_s: float          # the device's idle time in the window
    unattributed_s: float  # of it, gaps that begin with no program span open


def _window(evs):
    for e in evs:
        if e.get("cat") == SPAN_CAT and e.get("name") == WINDOW_SPAN:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise RuntimeError("the trace holds no window span")


def _gaps(evs, w0, w1):
    """The window's stretches with nothing on the device, in order."""
    dev = sorted((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                 for e in evs if e.get("cat") in DEVICE_CATS)
    gaps, cur = [], w0
    for a, b in dev:
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def _covered(kids, starts, a, b, own):
    """The length of [a, b] that the spans in kids lying inside it cover."""
    total, cur_a, cur_b = 0.0, None, None
    for i in range(bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)):
        ka, kb, k = kids[i]
        if k == own or kb > b:
            continue
        if cur_a is None or ka > cur_b:
            if cur_a is not None:
                total += cur_b - cur_a
            cur_a, cur_b = ka, kb
        else:
            cur_b = max(cur_b, kb)
    if cur_a is not None:
        total += cur_b - cur_a
    return total


def span_times(trace: dict, program) -> SpanTimes:
    """The SpanTimes of a chrome trace (as torch.profiler exports it) for
    the program's span names `program`."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    w0, w1 = _window(evs)
    program = set(program)
    children = program | set(HARNESS_SPANS)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid"), i)
             for i, e in enumerate(evs) if e.get("cat") == SPAN_CAT
             and e.get("name") in children and w0 <= float(e["ts"]) <= w1]
    kids = sorted((a, b, i) for a, b, _, _, i in spans)
    starts = [a for a, _, _ in kids]
    self_s, count = {}, {}
    for a, b, name, _, i in spans:
        if name in program:
            self_s[name] = self_s.get(name, 0.0) + (b - a) - _covered(kids, starts, a, b, i)
            count[name] = count.get(name, 0) + 1
    open_at = _labeller([s[:4] for s in spans if s[2] in program])
    idle = unattributed = 0.0
    for a, b in _gaps(evs, w0, w1):
        idle += b - a
        if open_at(a) is None:
            unattributed += b - a
    us = 1e-6
    return SpanTimes({k: v * us for k, v in self_s.items()}, count, idle * us,
                     unattributed * us)


def _category(e):
    """A profiler event's category in the chrome trace's words, or None
    (host operations): a span of the host, or the device's activity, which
    every kernel, copy and fill is alike to the busy time."""
    if e.device_type() == DeviceType.CPU:
        return SPAN_CAT if e.is_user_annotation() else None
    return None if e.is_user_annotation() else "kernel"


def profiler_events(prof) -> dict:
    """A finished torch.profiler's spans and device activity in the form of
    its chrome trace: ts and dur in us, one clock for host and device, ts
    from the first event's start (ns since the epoch exceed a float's
    precision)."""
    evs = [(e, cat) for e in prof.profiler.kineto_results.events()
           if (cat := _category(e)) is not None]
    t0 = min((e.start_ns() for e, _ in evs), default=0)
    return {"traceEvents": [{"ph": "X", "cat": cat, "name": e.name(),
                             "ts": (e.start_ns() - t0) / 1e3, "dur": e.duration_ns() / 1e3,
                             "tid": e.start_thread_id()} for e, cat in evs]}


def _profiler_of(run):
    """The profiler of run's traced window: run_cell's `tracer`, in the
    frame that holds this run."""
    frame = sys._getframe(1)
    while frame is not None:
        prof = getattr(frame.f_locals.get("tracer"), "prof", None)
        if prof is not None and frame.f_locals.get("run") is run:
            return prof
        frame = frame.f_back
    return None


_last: list = [None, None]   # (run, its SpanTimes): the readers of one run share it


def layer_times(run) -> SpanTimes | None:
    """The SpanTimes of a traced run, or None: no trace, a program without
    spans, no program span in the window, or events whose idle time is not
    the summary's (by 1% of the window)."""
    if _last[0] is run:
        return _last[1]
    names = program_trace.span_names()
    prof = _profiler_of(run) if run.trace is not None and names else None
    times = None
    if prof is not None:
        times = span_times(profiler_events(prof), names)
        # the events must show the summary's idle time, or they are misread
        idle = run.trace.window_s - run.trace.busy_s
        if not times.count or abs(times.idle_s - idle) > 0.01 * run.trace.window_s:
            times = None
    _last[:] = [run, times]
    return times


def host_ms_per_op(run, name):
    """Host self time of the program's span `name` over the traced window,
    ms per completed step or frame."""
    times = layer_times(run)
    if times is None or not times.count.get(name) or not run.record["completed"]:
        return None
    return 1e3 * times.self_s[name] / run.record["completed"]


def unattributed_idle_pct(run):
    """The idle time whose gap begins with no program span open, as a share
    of all the traced window's idle time, %."""
    times = layer_times(run)
    if times is None or times.idle_s <= 0:
        return None
    return 100.0 * times.unattributed_s / times.idle_s


def live_row_pct(run):
    """Live rows over rows gathered in the traced window, %."""
    got = program_trace.rows() if run.trace is not None else None
    if not got or not got[0]:
        return None
    return 100.0 * got[1] / got[0]
