"""Port parity: the bucketed tile scheduler (sgrt_tpu_torch.ops.scheduler,
device="cpu") against sgrt_tpu.ops.scheduler, Pallas in interpret mode.

Off the card both cost models are the JAX package's static decision
constants, so the two packages must make the same bucket decisions and
build the same index lists. Rendered colors: atol 2e-5 (the JAX package's
kernel tolerance; sigma = 0.3 here, where float32 rounding of the Gaussian
exponent stays below 1e-6 relative); gradients 5e-5 of each field's max
|value| (tests/test_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.gaussians import GaussianScene as JScene, grid_scene as j_grid
from sgrt_tpu.ops import scheduler as js
from sgrt_tpu.ops.frame import orbit_camera as j_orbit
from sgrt_tpu.ops.render import _tile_rays as j_tile_rays
from sgrt_tpu_torch.models.gaussians import GaussianScene, scene_from_numpy
from sgrt_tpu_torch.ops import scheduler as ts
from sgrt_tpu_torch.ops.frame import probe_buckets as t_probe_buckets

FIELDS = ("mu", "sigma", "magnitude", "albedo")


def _port(scene):
    return scene_from_numpy(*(np.asarray(getattr(scene, f)) for f in FIELDS), device="cpu")


def _cloud(n=600, seed=0):
    """Points on the cube surface, the smoke scene's shape at a small size,
    as Gaussians by the obj rule."""
    from sgrt_tpu.models.gaussians import scene_from_vertices

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts /= np.maximum(np.abs(pts).max(axis=1, keepdims=True), 1e-6)
    return scene_from_vertices(pts)


@pytest.mark.parametrize("scene_name,tiles,multiple_of", [
    ("grid8", 4, 1), ("cloud", (8, 4), 1), ("cloud", 8, 2), ("cloud", 8, 1)])
def test_probe_bucket_config_matches_jax(scene_name, tiles, multiple_of):
    from sgrt_tpu.ops.frame import probe_buckets as j_probe_buckets

    scene = j_grid(8) if scene_name == "grid8" else _cloud()
    angles = [0.0, 30.0, 45.0]
    want = j_probe_buckets(scene, angles, -4.0, 1.0, tiles, margin=1.3,
                           multiple_of=multiple_of)
    got = t_probe_buckets(_port(scene), angles, -4.0, 1.0, tiles, margin=1.3,
                          multiple_of=multiple_of)
    assert isinstance(got, ts.BucketConfig)
    assert tuple(got) == tuple(want)


def test_cost_model_off_the_card_is_the_static_one():
    got = ts.calibrate_cost_model("cpu")
    assert got == js.calibrate_cost_model() and got["measured"] is False
    counts = np.array([40, 31, 9, 0, 17])
    for cap in (32, 64, 300):
        assert ts._quantized_work_erf(counts, cap, 128) == js._quantized_work_erf(counts, cap,
                                                                                 128)
        assert ts._launch_time_s(counts, cap, 128, got) == pytest.approx(
            js._launch_time_s(counts, cap, 128, got), rel=1e-12)
    assert ts.BucketConfig(3, 30, 10).round_to(16, 8) == tuple(
        js.BucketConfig(3, 30, 10).round_to(16, 8))


@pytest.mark.parametrize("interleave", [1, 2])
def test_bucketed_tile_indices_match(interleave):
    scene = _cloud(seed=1)
    view = j_orbit(30.0, -4.0, 1.0, 8, 8).view_matrix
    want = js.bucketed_tile_indices(scene, view, 8, js.BucketConfig(8, 96, 48),
                                    interleave=interleave)
    got = ts.bucketed_tile_indices(_port(scene), torch.from_numpy(np.array(view)), 8,
                                   ts.BucketConfig(8, 96, 48), interleave=interleave)
    for name, g, w in zip(("dense_ids", "idx_dense", "sparse_ids", "idx_sparse", "counts"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.fixture(scope="module")
def bucketed_case():
    scene = j_grid(4, sigma=0.3, magnitude=2.0)
    cam = j_orbit(20.0, -4.0, 1.0, 32, 32)
    o, dirs = cam.rays()
    d = j_tile_rays(dirs, 32, 32, 4)
    g = np.random.default_rng(2).normal(size=d.shape).astype(np.float32)
    cfg = (4, 16, 8)

    def loss(s):
        colors, counts, overflow = js.render_tiles_bucketed(s, cam.view_matrix, o, d,
                                                            js.BucketConfig(*cfg), tiles=4)
        return jnp.sum(colors * g), (colors, overflow)

    (_, (colors, overflow)), grads = jax.value_and_grad(loss, has_aux=True)(scene)
    return scene, (cam.view_matrix, o, d), g, cfg, colors, overflow, grads


def test_render_tiles_bucketed_matches_jax(bucketed_case):
    scene, inputs, g, cfg, j_colors, j_overflow, j_grads = bucketed_case
    leaves = {f: t.requires_grad_(True) for f, t in zip(FIELDS, (
        getattr(_port(scene), f) for f in FIELDS))}
    view, o, d = (torch.from_numpy(np.array(x)) for x in inputs)
    colors, counts, overflow = ts.render_tiles_bucketed(
        GaussianScene(**leaves), view, o, d, ts.BucketConfig(*cfg), tiles=4)
    assert int(overflow) == int(j_overflow) == 0
    np.testing.assert_allclose(colors.detach().numpy(), np.asarray(j_colors), atol=2e-5)
    assert colors.detach().abs().max() > 0.05
    (colors * torch.from_numpy(g)).sum().backward()
    for f in FIELDS:
        want = np.asarray(getattr(j_grads, f))
        np.testing.assert_allclose(leaves[f].grad.numpy(), want,
                                   atol=5e-5 * np.abs(want).max(), err_msg=f)


def test_bucketed_single_launch_matches_two_buckets(bucketed_case):
    """n_dense = 0 (one launch at one capacity) renders the same frame as
    the two-bucket split."""
    scene, inputs, _, cfg, j_colors, _, _ = bucketed_case
    view, o, d = (torch.from_numpy(np.array(x)) for x in inputs)
    one, _, ovf = ts.render_tiles_bucketed(_port(scene), view, o, d,
                                           ts.BucketConfig(0, 16, 16), tiles=4)
    assert int(ovf) == 0
    np.testing.assert_allclose(one.numpy(), np.asarray(j_colors), atol=2e-5)


def test_bucket_overflow_counted():
    scene = JScene(*(jnp.asarray(a) for a in (
        np.random.default_rng(0).normal(0, 0.05, (40, 3)).astype(np.float32),
        np.full(40, 0.1, np.float32), np.ones(40, np.float32),
        np.full((40, 3), 0.5, np.float32))))
    cam = j_orbit(0.0, -4.0, 1.0, 16, 16)
    o, dirs = cam.rays()
    d = j_tile_rays(dirs, 16, 16, 2)
    _, _, want = js.render_tiles_bucketed(scene, cam.view_matrix, o, d,
                                          js.BucketConfig(1, 16, 8), tiles=2)
    _, _, got = ts.render_tiles_bucketed(
        _port(scene), *(torch.from_numpy(np.array(x)) for x in (cam.view_matrix, o, d)),
        ts.BucketConfig(1, 16, 8), tiles=2)
    assert int(got) == int(want) > 0
