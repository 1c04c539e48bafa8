"""The benchmark's harness: one run of one cell, driven by data.

A cell named in BENCHMARK.json's `workloads` has its own file,
benchmark/workloads/<cell>.json, which names its driver
(benchmark/drivers/<driver>.py), the driver's parameters and the limits of
its check; its configuration is the file BENCHMARK.json's `configs` entry
names. Every metric, end to end or per layer, is read by its own reader,
benchmark/metrics/<metric>.py, a function read(run) → float or None
(nothing to read: the metric is left out of the result). So a cell, a
configuration or a metric is added by adding files and entries; no file is
edited.

A run: set-up (the cell's driver module builds its scene from the seed, the
program's step or frame, and warms up), the window (that module's loop,
timed on the host clock; with --trace 1 under torch.profiler, inside a
`window` span, after an untraced window where a per-layer metric is read
from the host clock), then, once the windows have closed and the peak
memory is read, the program's state is freed and the module's correctness
check holds what the windows produced against the plain reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import time
from pathlib import Path
from typing import Callable

import torch

from benchmark import checks
from benchmark.profiling import WINDOW_SPAN, TraceSummary, Tracer, card_readings


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, prefix: str):
    """The module of a file found by name (names may hold dots)."""
    name = prefix + "_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Spec:
    """A cell as the files give it."""
    root: Path            # the checkout's root (BENCHMARK.json's folder)
    bench: dict           # BENCHMARK.json
    cell: dict            # its `workloads` entry
    workload: dict        # benchmark/workloads/<cell>.json
    config: dict          # the configuration's file

    @property
    def folder(self) -> Path:
        return self.root / "benchmark"

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.cell["name"] in m["workloads"]]

    def per_layer(self) -> list[dict]:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def load_spec(root: Path, cell_name: str) -> Spec:
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    workload = load_json(root / "benchmark" / "workloads" / f"{cell_name}.json")
    return Spec(root, bench, cell, workload, config)


@dataclasses.dataclass
class Context:
    """What a driver is given."""
    spec: Spec
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    span: Callable
    t0: float = 0.0                  # the process's start, host clock
    marks: dict = dataclasses.field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Note the end of a phase of set-up, in s since the process began."""
        self.marks[phase] = time.perf_counter() - self.t0

    @property
    def params(self) -> dict:
        return self.spec.workload["params"]

    @property
    def config(self) -> dict:
        return self.spec.config


@dataclasses.dataclass
class Run:
    """What a metric reader is given."""
    spec: Spec
    setup_s: float
    record: dict                     # the driver's window: ops, rays, window_s, ...
    trace: TraceSummary | None = None
    work: list | None = None         # per completed op of the traced window: {part: Work}
    launches: int | None = None      # the program's kernel launches over the window
    window_peak_bytes: int | None = None


def _span_factory(trace: bool):
    if not trace:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_process_start: float) -> tuple[dict, list[str]]:
    """One run of a cell → (the result's object, the check's lines).

    A traced run whose per-layer metrics include one of the host clock
    first runs an untraced window of `seconds`, as a --trace 0 run does,
    and reads those metrics from it: the profiler slows the host. The
    traced window follows, and the other metrics are read from it."""
    device = torch.device(device)
    spec = load_spec(root, cell_name)
    driver = load_module(spec.folder / "drivers" / f"{spec.workload['driver']}.py",
                         "bench_driver")
    wanted = spec.per_layer() if trace else spec.end_to_end()
    host_window = trace and any(m["source"] == "host_clock" for m in wanted)
    window_s = seconds
    if trace and "trace_seconds" in spec.workload:
        window_s = min(seconds, float(spec.workload["trace_seconds"]))
    ctx = Context(spec, int(seed), float(window_s), bool(trace), device,
                  _span_factory(trace), t_process_start)
    ctx.mark("imports")
    cell = driver.make(ctx)
    _sync(device)
    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    records = []
    if host_window:
        records.append(cell.window(dataclasses.replace(
            ctx, seconds=float(seconds), trace=False, span=_span_factory(False))))
    cell.reset_counters()
    tracer = Tracer() if trace else contextlib.nullcontext()
    with tracer:
        t_traced = time.perf_counter()
        with ctx.span(WINDOW_SPAN):
            record = cell.window(ctx)
    if not host_window:
        t_window = t_traced
    records.append(record)
    setup_s = t_window - t_process_start
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run = Run(spec, setup_s, record, window_peak_bytes=window_peak,
              launches=cell.launches())
    host_run = dataclasses.replace(run, record=records[0])
    if trace:
        run.trace = tracer.summary()
        run.work = cell.work(record)
    cell.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = cell.check()
    check_s = time.perf_counter() - t_check
    correct, compared = checks.judge(numbers, spec.workload["limits"])

    metrics = {}
    for m in wanted:
        reader = load_module(spec.folder / "metrics" / f"{m['name']}.py", "bench_metric")
        value = reader.read(host_run if m["source"] == "host_clock" else run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": int(spec.cell["chips"]),
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": bool(correct),
              "attempted": sum(int(r["attempted"]) for r in records),
              "failed": sum(int(r["failed"]) for r in records),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["setup_phases_s"] = ctx.marks
    result["window"] = {"completed": [r["completed"] for r in records],
                        "seconds": [r["window_s"] for r in records],
                        "capacity": getattr(cell, "cap", None),
                        "buckets": list(getattr(cell, "buckets", None) or []) or None}
    lat = records[0].get("latencies_s") or []
    if len(lat) > 1:
        q = statistics.quantiles(lat, n=4)
        result["window"]["latency_ms"] = [1e3 * v for v in (min(lat), *q, max(lat))]
    result["check_s"] = check_s
    if on_card:
        result["card"] = card_readings()
    result["checks"] = compared
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in compared.items()]
    return result, lines
