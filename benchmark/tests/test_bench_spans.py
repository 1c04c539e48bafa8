"""benchmark/spans.py: the program spans' self times and the unattributed
idle time of a trace, the events read from a finished profiler, and the
metrics that read them in a traced run on the CPU."""

import json
import re
import time

import pytest
import torch
from bench_helpers import ROOT, tiny_root  # noqa: F401

from benchmark import profiling, spans

PROGRAM = ("camera", "tiling", "gather", "launch", "backward", "optimizer", "untile")


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def _synthetic():
    """A fit step's trace in us: the program's spans inside the harness's
    step_call, a launch span on the autograd thread (tid 2) inside
    backward, Adam's own annotation inside optimizer, and device work that
    leaves six gaps, two of them begun with no program span open."""
    ua = "user_annotation"
    evs = [_x(ua, "window", 0, 1000), _x(ua, "step_call", 0, 900),
           _x(ua, "tiling", 10, 100), _x(ua, "gather", 120, 50),
           _x(ua, "launch", 180, 80), _x(ua, "backward", 300, 400),
           _x(ua, "launch", 400, 200, tid=2), _x(ua, "optimizer", 710, 90),
           _x(ua, "Optimizer.step#Adam.step", 720, 70),
           _x("cpu_op", "aten::mul", 20, 30), _x("cpu_op", "aten::cat", 130, 10)]
    evs += [_x("kernel", f"k{i}", a, b - a, tid=7)
            for i, (a, b) in enumerate([(50, 60), (200, 250), (450, 550), (750, 760)])]
    evs.append(_x("gpu_memcpy", "Memcpy DtoH", 840, 10, tid=7))
    return {"traceEvents": evs + [{"ph": "M", "name": "process_name"}]}


def test_self_times_and_unattributed_idle_of_a_synthetic_trace():
    got = spans.span_times(_synthetic(), PROGRAM)
    us = 1e-6
    # launch: 80 on the main thread + 200 on the autograd thread; backward
    # less the launch span inside it on the other thread; optimizer keeps
    # Adam's own annotation
    want = {"tiling": 100, "gather": 50, "launch": 280, "backward": 200, "optimizer": 90}
    assert got.self_s == pytest.approx({k: v * us for k, v in want.items()})
    assert got.count == {"tiling": 1, "gather": 1, "launch": 2, "backward": 1, "optimizer": 1}
    # gaps (0,50) and (850,1000) begin outside every program span
    assert got.idle_s == pytest.approx(820 * us)
    assert got.unattributed_s == pytest.approx(200 * us)


def test_summarize_reads_the_same_trace_as_before():
    """The harness's summary of the trace is what it was, and its idle time
    is the one span_times splits."""
    trace = _synthetic()
    s = profiling.summarize(trace)
    assert s.window_s == pytest.approx(1e-3) and s.busy_s == pytest.approx(180e-6)
    assert s.group_s == {"fwd": 0.0, "bwd": 0.0}
    assert dict(s.device_ops) == pytest.approx({"k0": 10e-6, "k1": 50e-6, "k2": 100e-6,
                                                "k3": 10e-6, "Memcpy DtoH": 10e-6})
    # each gap under the innermost span open where it begins, on any thread
    assert dict(s.idle_gaps) == pytest.approx({
        "step_call": 200e-6, "tiling": 140e-6, "launch": 400e-6,
        "Optimizer.step#Adam.step": 80e-6})
    assert spans.span_times(trace, PROGRAM).idle_s == pytest.approx(s.window_s - s.busy_s)


def test_the_harness_spans_are_the_ones_its_drivers_open():
    opened = {profiling.WINDOW_SPAN}
    for path in (ROOT / "benchmark/drivers").glob("*.py"):
        opened |= set(re.findall(r'span\("([^"]+)"\)', path.read_text()))
    assert opened == set(spans.HARNESS_SPANS)


def test_the_profilers_events_read_as_its_chrome_trace(tmp_path):
    """profiler_events() of a finished CPU profile gives the span times of
    the chrome trace the same profile exports."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("window"):
            with record_function("tiling"):
                torch.ones(64).cumsum(0)
            with record_function("gather"):
                torch.arange(64).index_select(0, torch.arange(8))
    events = spans.profiler_events(prof)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    exported = json.loads((tmp_path / "t.json").read_text())
    a, b = spans.span_times(events, PROGRAM), spans.span_times(exported, PROGRAM)
    assert a.count == b.count == {"tiling": 1, "gather": 1}
    assert a.self_s == pytest.approx(b.self_s, abs=2e-9)
    assert a.idle_s == pytest.approx(b.idle_s, abs=2e-9)


NEW = {"tiny.fit": ("tiling_host_ms.fit", "gather_host_ms.fit", "launch_host_ms.fit",
                    "backward_host_ms.fit", "optimizer_host_ms.fit", "live_row_share.fit",
                    "idle_unattributed_share.fit"),
       "tiny.orbit": ("camera_host_ms.render.host", "tiling_host_ms.render.host",
                      "gather_host_ms.render.host", "launch_host_ms.render.host",
                      "live_row_share.render.host", "idle_unattributed_share.render.host")}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reports_the_span_metrics(tiny_root, cell):  # noqa: F811
    """On the CPU (no device activity: the whole window is one idle gap,
    begun before any program span)."""
    wl_path = tiny_root / f"benchmark/workloads/{cell}.json"
    wl = json.loads(wl_path.read_text())
    wl["trace_seconds"] = 0.2
    wl_path.write_text(json.dumps(wl))
    from benchmark.harness import run_cell
    from sgrt_tpu_torch.utils import trace

    trace.reset_rows()
    result, _ = run_cell(tiny_root, cell, 3, 0.2, True, "cpu", time.perf_counter())
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"] and set(NEW[cell]) <= set(got)
    per_op = result["window"]["seconds"][-1] * 1e3 / result["window"]["completed"][-1]
    host = [got[m] for m in NEW[cell] if "_host_ms." in m]
    assert all(v > 0 for v in host) and sum(host) <= per_op
    live = got[NEW[cell][-2]]
    assert 0 < live <= 100
    assert got[NEW[cell][-1]] == pytest.approx(100.0)


def test_the_readers_give_nothing_for_a_program_without_spans(monkeypatch):
    """A tree whose program has no trace module (the parent of this
    benchmark's span metrics): every new reader returns None."""
    from benchmark import program_trace
    from benchmark.harness import Run

    monkeypatch.setattr(program_trace, "_trace", lambda: None)
    run = Run(spec=None, setup_s=0.0, record={"completed": 3},
              trace=profiling.TraceSummary(1.0, 0.5, {}, [], []))
    assert spans.layer_times(run) is None
    assert spans.host_ms_per_op(run, "tiling") is None
    assert spans.unattributed_idle_pct(run) is None
    assert spans.live_row_pct(run) is None
