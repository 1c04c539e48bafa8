"""Reading the device: torch.profiler over the traced window, and
nvidia-smi's readings of the card.

The traced window is a `window` span of the harness. Device time is the
union of the kernels', copies' and fills' intervals inside it (one stream:
the port launches on the current stream only), busy over the window's wall
time; the idle gaps between them are labelled by the harness span and the
innermost host operation open when each began. Kernels of csrc/chunked.cu
are grouped by what they do: the forward (fwd_kernel), the backward
(bwd_p_kernel, bwd_q_kernel, bwd_rows_kernel, bwd_ddirs_kernel,
plane_rows_kernel); ordered_block_sums, which sums both sides' block
partials, goes with the group of the kernel before it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import tempfile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
WINDOW_SPAN = "window"
GROUPS = {"fwd_kernel": "fwd", "bwd_p_kernel": "bwd", "bwd_q_kernel": "bwd",
          "bwd_rows_kernel": "bwd", "bwd_ddirs_kernel": "bwd", "plane_rows_kernel": "bwd"}
FOLLOWER = "ordered_block_sums"
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without namespaces, return type and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:100]


def base_name(name: str) -> str:
    return re.split(r"[<(]", short_name(name), maxsplit=1)[0].strip()


class TraceSummary:
    """What the per-layer readers take from the trace."""

    def __init__(self, window_s, busy_s, group_s, device_ops, idle_gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.group_s = group_s          # {"fwd": s, "bwd": s}
        self.device_ops = device_ops    # [[name, s], ...]
        self.idle_gaps = idle_gaps      # [[label, s], ...]

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _innermost_open(stacks, t):
    """The innermost interval open at t over the per-thread stacks."""
    best = None
    for stack in stacks.values():
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack and stack[-1][0] <= t and (best is None or stack[-1][0] > best[0]):
            best = stack[-1]
    return best


def _labeller(events):
    """A function t → the innermost event open at t, for t increasing."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    stacks, pos = {}, [0]

    def at(t):
        while pos[0] < len(events) and events[pos[0]][0] <= t:
            e = events[pos[0]]
            stack = stacks.setdefault(e[3], [])
            while stack and stack[-1][1] < e[0]:
                stack.pop()
            stack.append(e)
            pos[0] += 1
        return _innermost_open(stacks, t)

    return at


def summarize(trace: dict) -> TraceSummary:
    """The TraceSummary of a chrome trace exported by torch.profiler."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in evs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    dev = []
    for e in evs:
        if e.get("cat") in DEVICE_CATS:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, e.get("name", "")))
    dev.sort()
    busy, gaps, cur_a, cur_b = 0.0, [], None, w0
    for a, b, _ in dev:
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    gaps.append((cur_b, w1))

    by_name, group_s, group = {}, {"fwd": 0.0, "bwd": 0.0}, None
    for a, b, name in dev:
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + (b - a)
        base = base_name(name)
        if base in GROUPS:
            group = GROUPS[base]
            group_s[group] += b - a
        elif base == FOLLOWER and group is not None:
            group_s[group] += b - a

    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid"))
             for e in evs if e.get("cat") == "user_annotation" and e.get("name") != WINDOW_SPAN]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid"))
           for e in evs if e.get("cat") == "cpu_op"]
    span_at, op_at = _labeller(spans), _labeller(ops)
    idle = {}
    for a, b in gaps:
        if b <= a:
            continue
        s, o = span_at(a), op_at(a)
        label = (s[2] if s else "no_span") + ("/" + o[2] if o else "")
        idle[label] = idle.get(label, 0.0) + (b - a)
    us = 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary((w1 - w0) * us, busy * us, {k: v * us for k, v in group_s.items()},
                        [[k, v * us] for k, v in top_ops], [[k, v * us] for k, v in top_idle])


class Tracer:
    """torch.profiler over CPU and CUDA activity; summary() after exit."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def summary(self) -> TraceSummary:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = json.load(fh)
        finally:
            os.unlink(path)
        return summarize(trace)


SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.max.sm",
              "temperature.gpu")


def card_readings() -> dict:
    """nvidia-smi's readings of the first card, or {} where it cannot run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=" + ",".join(SMI_FIELDS),
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if out.returncode != 0 or not out.stdout.strip():
        return {}
    vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(SMI_FIELDS, vals))
