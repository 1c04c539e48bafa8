"""The port's spans and row counter (sgrt_tpu_torch.utils.trace) on the CPU:
nothing recorded and nothing counted without a profiler; under
torch.profiler each layer's span where the work happens, and the gather's
rows counted against tile_indices' own counts."""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sgrt_tpu_torch.models.gaussians import grid_scene
from sgrt_tpu_torch.ops.frame import orbit_camera, render_orbit_frame
from sgrt_tpu_torch.ops.scheduler import BucketConfig
from sgrt_tpu_torch.ops.tiling import gather_tiles, tile_indices
from sgrt_tpu_torch.parallel.fit import adam, init_state, make_frame_train_step
from sgrt_tpu_torch.utils import trace

KW = dict(width=32, height=32, tiles=4, capacity=32)
BUCKETS = BucketConfig(4, 32, 16)


@pytest.fixture(scope="module")
def setup():
    """(scene, camera, rays, target image) of a 32x32 frame of grid_scene(4)."""
    scene = grid_scene(4, device="cpu")
    cam = orbit_camera(0.0, -4.0, 1.0, 32, 32, device="cpu")
    o, dirs = cam.rays()
    with torch.no_grad():
        target = render_orbit_frame(scene, 0.0, backend="kernel", **KW)[0]
    moved = type(scene)(scene.mu + 0.03, scene.sigma, scene.magnitude, scene.albedo)
    return moved, cam, (o, dirs), target


def _step(setup):
    scene, cam, (o, dirs), target = setup
    step = make_frame_train_step(**KW)
    step(init_state(scene, adam(1e-3)), cam.view_matrix, o, dirs, target)


def _frame(setup, bucket_cfg=None):
    with torch.no_grad():
        render_orbit_frame(setup[0], 20.0, backend="kernel", bucket_cfg=bucket_cfg, **KW)


CALLS = {"step": _step, "frame": _frame,
         "bucketed_frame": lambda s: _frame(s, BUCKETS)}


def _recorded(call, setup):
    """The user annotations a call records under a CPU profiler → {name: n}."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(setup)
    return collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                               if e.is_user_annotation())


@pytest.mark.parametrize("call", sorted(CALLS))
def test_no_profiler_records_nothing_and_counts_nothing(setup, monkeypatch, call):
    def refuse(name):
        raise AssertionError(f"span {name!r} opened with no profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    trace.reset_rows()
    CALLS[call](setup)
    assert trace.rows() == (0, 0)


@pytest.mark.parametrize("call,want", [
    # tiling twice a step: the tile indices, then the rays' and target's layout
    ("step", {"tiling": 2, "gather": 1, "launch": 2, "backward": 1, "optimizer": 1}),
    ("frame", {"camera": 1, "tiling": 2, "gather": 1, "launch": 1, "untile": 1}),
    ("bucketed_frame", {"camera": 1, "tiling": 2, "gather": 2, "launch": 2, "untile": 2})])
def test_a_profiler_records_each_layer_where_its_work_is(setup, call, want):
    got = _recorded(CALLS[call], setup)
    program = {k: v for k, v in got.items() if k in trace.SPANS}
    assert program == want
    # every other annotation is torch's own (Optimizer.step#Adam.step)
    assert all("#" in k for k in set(got) - set(program)), got


def test_rows_count_the_gather_under_a_profiler(setup):
    scene, cam = setup[0], setup[1]
    idx, counts = tile_indices(scene, cam.view_matrix, 4, 8)
    assert int(counts.max()) > 8          # some tiles overflow: live is a min
    trace.reset_rows()
    with profile(activities=[ProfilerActivity.CPU]):
        gather_tiles(scene, idx)
    assert trace.rows() == (16 * 8, int(torch.clamp(counts, max=8).sum()))
    gather_tiles(scene, idx)              # no profiler: not counted
    assert trace.rows() == (16 * 8, int(torch.clamp(counts, max=8).sum()))
    trace.reset_rows()
    assert trace.rows() == (0, 0)


@pytest.mark.parametrize("call,per_gather", [("step", [(16, 32)]),
                                             ("bucketed_frame", [(4, 32), (12, 16)])])
def test_rows_of_a_call_are_tiles_by_capacity(setup, call, per_gather):
    trace.reset_rows()
    _recorded(CALLS[call], setup)
    gathered, live = trace.rows()
    assert gathered == sum(t * c for t, c in per_gather)
    assert 0 < live <= gathered


@pytest.mark.parametrize("call", ["step", "bucketed_frame"])
def test_every_span_reaches_the_exported_chrome_trace(setup, call, tmp_path):
    """The names survive torch's chrome-trace export (it drops a span
    named "kernel")."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        CALLS[call](setup)
    recorded = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                   if e.is_user_annotation() and e.name() in trace.SPANS)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    exported = collections.Counter(
        e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
        if e.get("cat") == "user_annotation" and e.get("name") in trace.SPANS)
    assert exported == recorded and len(recorded) >= 5


def _render_route(route, save_t):
    """One differentiable launch of B 2, N 256, R 8 rows through `route`."""
    from sgrt_tpu_torch.ops.cuda_render import render_batched

    g = torch.Generator().manual_seed(3)
    oc = torch.randn((2, 256, 3), generator=g).add_(torch.tensor([0.0, 0.0, 4.0]))
    sigma, mag = torch.full((2, 256), 0.3), torch.ones((2, 256))
    alb = torch.rand((2, 256, 3), generator=g)
    d = torch.randn((2, 3, 8), generator=g)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    args = [t.requires_grad_() for t in (oc, sigma, mag, alb)] + [d]
    counts = torch.full((2,), 40, dtype=torch.int32)
    return render_batched(*args, counts, ck=128 if route == "chunked" else None, save_t=save_t)


@pytest.mark.parametrize("route", ["fused", "chunked"])
def test_saved_t_counts_the_residual_under_a_profiler(route):
    """A launch that saves T counts its 20 B N R bytes, one that recomputes
    counts a launch, only while a profiler records; reset_rows zeroes the
    saved-T counter with the row counter."""
    trace.reset_rows()
    _render_route(route, None)
    assert trace.saved_t() == (0, 0, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        _render_route(route, None)       # 20 B N R bytes fit the budget: saved
        _render_route(route, False)
        with torch.no_grad():
            _render_route(route, None)   # no backward to come: not counted
    assert trace.saved_t() == (20 * 2 * 256 * 8, 1, 1)
    trace.reset_rows()
    assert trace.saved_t() == (0, 0, 0) and trace.rows() == (0, 0)


def test_saved_t_of_a_step_is_its_launch(setup):
    """The frame step's one launch, 16 tiles of 64 rays at capacity 32,
    saves its T."""
    trace.reset_rows()
    _recorded(CALLS["step"], setup)
    assert trace.saved_t() == (20 * 16 * 32 * 64, 1, 0)
