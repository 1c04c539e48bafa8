"""The port's spans and its row counter, on the torch profiler's clock.

span(name) opens torch.profiler.record_function(name) while a torch
profiler is recording, and is one shared no-op context otherwise: a
recording profiler is the only switch (no flag, no environment variable),
so a run without one pays a bool read and an empty `with`. Inside a
profiler the spans land in its trace beside the CUDA activity they launch,
on the same clock, so an idle gap of the device can be put down to the
layer the host was in. Wrap any entry point in torch.profiler.profile to
see them.

SPANS, one name a layer:

    camera     the orbit camera and its rays (the per-frame uploads)
    tiling     membership, counts and compaction (tile_indices,
               bucketed_tile_indices); the rays' and targets' tile layout
    gather     the packed scene and the per-tile index_select
    launch     a per-tile renderer's forward and its autograd backward:
               operand layout, output and scratch, the kernel's launch
               (the plain versions on the CPU). Not "kernel": torch's
               chrome-trace export drops a span of that name
    backward   torch.autograd.grad of a train step: the engine, the loss's
               backward, the gather's transpose
    optimizer  the gradients handed to the optimizer and its step
    untile     the bucket scatter into tile order and the image assembly

The row counter, at the gather: rows gathered (every index, the padding
included) and live rows (indices other than the dummy row N). Both count
only while a profiler is recording. Live rows add up on the device with no
sync; rows() reads both, reset_rows() zeroes them.

The saved-T counter, where a differentiable kernel launch picks its
backward (the fused and chunked routes, isotropic and anisotropic): the
bytes of the T residual saved for the backward, the launches that saved T
and those that recompute it. It counts only while a profiler is recording;
saved_t() reads it, and reset_rows() zeroes it with the row counter.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

SPANS = ("camera", "tiling", "gather", "launch", "backward", "optimizer", "untile")

_OFF = contextlib.nullcontext()
_gathered = 0
_live: dict = {}          # device → 0-d int64 tensor of live rows
_saved_t = [0, 0, 0]      # bytes of T saved, launches saving T, launches recomputing


def span(name: str):
    """record_function(name) while a profiler records, else a no-op."""
    return record_function(name) if _profiler._is_profiler_enabled else _OFF


def count_rows(idx: torch.Tensor, n: int) -> None:
    """Count a gather's rows: idx the per-tile indices into a scene of n
    Gaussians, n the dummy row."""
    global _gathered
    if not _profiler._is_profiler_enabled:
        return
    _gathered += idx.numel()
    live = torch.sum(idx != n)
    acc = _live.get(idx.device)
    _live[idx.device] = live if acc is None else acc + live


def rows() -> tuple[int, int]:
    """(rows gathered, live rows) since the last reset; waits for the
    devices that hold live counts."""
    return _gathered, sum(int(v) for v in _live.values())


def count_saved_t(nbytes: int, saved: bool) -> None:
    """Count a differentiable launch's backward route: T of nbytes saved
    for it (saved) or recomputed by it."""
    if not _profiler._is_profiler_enabled:
        return
    if saved:
        _saved_t[0] += nbytes
        _saved_t[1] += 1
    else:
        _saved_t[2] += 1


def saved_t() -> tuple[int, int, int]:
    """(bytes of T saved, launches that saved T, launches that recompute
    it) since the last reset."""
    return tuple(_saved_t)


def reset_rows() -> None:
    """Zero the row counter and the saved-T counter."""
    global _gathered
    _gathered = 0
    _live.clear()
    _saved_t[:] = [0, 0, 0]
