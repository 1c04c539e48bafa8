"""Port parity: whole frames of sgrt_tpu_torch.ops.frame (device="cpu")
against sgrt_tpu.ops.frame, on the setup of tests/test_pallas.py:243-252
(grid_scene(8), 64^2, 4x4 tiles, capacity 64, angle 23).

Tolerance, derived: the Gaussian exponent -(|oc|^2 - mb^2) / (2 sigma^2)
subtracts two numbers near d^2 (camera distance d ~ 4-5, so |oc|^2 < 32,
float32 ulp 1.9e-6). Two float32 evaluations that round mb or |oc|^2 one
step apart (Pallas takes mb from a dot, the port from ordered products)
differ there by up to 2 ulp / (2 sigma^2) = 4.9e-4 relative at
sigma = 1/16; at the frame's peak color 0.079 that is 3.8e-5. Twice that,
8e-5, is the tolerance (under 1/40 of one 8-bit level). The JAX package's
own Pallas-vs-XLA frame test shares XLA's rounding and holds 2e-5.
"""

import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.gaussians import grid_scene as j_grid
from sgrt_tpu.ops import frame as jf
from sgrt_tpu_torch.models.gaussians import scene_from_numpy
from sgrt_tpu_torch.ops import frame as tf

FIELDS = ("mu", "sigma", "magnitude", "albedo")
ATOL = 8e-5
KW = dict(width=64, height=64, tiles=4, capacity=64)


@pytest.fixture(scope="module")
def scenes():
    js = j_grid(8)
    ts = scene_from_numpy(*(np.asarray(getattr(js, f)) for f in FIELDS), device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def jax_pallas_frame(scenes):
    img, ovf = jf.render_orbit_frame(scenes[0], 23.0, backend="pallas", **KW)
    return np.asarray(img), int(ovf)


def test_tiled_kernel_route_matches_pallas(scenes, jax_pallas_frame):
    img, ovf = tf.render_orbit_frame(scenes[1], 23.0, backend="kernel", **KW)
    assert img.shape == (64, 64, 3) and img.dtype == torch.float32
    assert int(ovf) == jax_pallas_frame[1] == 0
    np.testing.assert_allclose(img.numpy(), jax_pallas_frame[0], atol=ATOL)
    assert img.max() > 0.05


def test_tiled_torch_route_matches_xla(scenes):
    j, _ = jf.render_orbit_frame(scenes[0], 23.0, backend="xla", **KW)
    t, ovf = tf.render_orbit_frame(scenes[1], 23.0, backend="torch", **KW)
    assert int(ovf) == 0
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_kernel_and_torch_routes_agree(scenes):
    a, _ = tf.render_orbit_frame(scenes[1], 23.0, backend="kernel", **KW)
    b, _ = tf.render_orbit_frame(scenes[1], 23.0, backend="torch", **KW)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


@pytest.mark.parametrize("backend,jbackend", [("kernel", "pallas"), ("torch", "xla")])
def test_untiled_route_matches(scenes, backend, jbackend):
    kw = dict(width=16, height=12, use_tiling=False)
    j, _ = jf.render_orbit_frame(scenes[0], 10.0, backend=jbackend, **kw)
    t, ovf = tf.render_orbit_frame(scenes[1], 10.0, backend=backend, **kw)
    assert t.shape == (12, 16, 3) and int(ovf) == 0
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_rectangular_tiles_match(scenes):
    kw = dict(width=32, height=16, tiles=(4, 2), capacity=40)
    j, _ = jf.render_orbit_frame(scenes[0], 300.0, backend="pallas", **kw)
    t, _ = tf.render_orbit_frame(scenes[1], 300.0, backend="kernel", **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_overflow_counter_matches(scenes):
    kw = dict(width=32, height=32, tiles=2, capacity=8)
    _, jo = jf.render_orbit_frame(scenes[0], 0.0, backend="pallas", **kw)
    _, to = tf.render_orbit_frame(scenes[1], 0.0, backend="kernel", **kw)
    assert int(to) == int(jo) > 0


def test_probe_capacity_matches(scenes):
    angles = [0.0, 30.0, 45.0, 60.0, 90.0]
    for tiles in (4, (8, 4)):
        assert tf.probe_capacity(scenes[1], angles, -4.0, 1.0, tiles) == \
            jf.probe_capacity(scenes[0], angles, -4.0, 1.0, tiles)


def test_render_orbit_frames_matches_per_frame(scenes):
    kw = dict(width=16, height=16, tiles=2, capacity=64, backend="kernel")
    imgs, ovf = tf.render_orbit_frames(scenes[1], [0.0, 40.0], **kw)
    assert imgs.shape == (2, 16, 16, 3) and int(ovf) == 0
    one, _ = tf.render_orbit_frame(scenes[1], 40.0, **kw)
    np.testing.assert_array_equal(imgs[1].numpy(), one.numpy())


@pytest.mark.parametrize("buckets", [(4, 64, 32), (0, 64, 64)])
def test_bucketed_frame_matches_pallas(scenes, buckets):
    from sgrt_tpu.ops.scheduler import BucketConfig as JBucket
    from sgrt_tpu_torch.ops.scheduler import BucketConfig

    j, jo = jf.render_orbit_frame(scenes[0], 23.0, backend="pallas",
                                  bucket_cfg=JBucket(*buckets), **KW)
    t, to = tf.render_orbit_frame(scenes[1], 23.0, backend="kernel",
                                  bucket_cfg=BucketConfig(*buckets), **KW)
    assert int(to) == int(jo) == 0
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_unported_options_raise(scenes):
    """Bucketed scheduling is ported (test_bucketed_frame_matches_pallas);
    a backend the port does not have still raises."""
    with pytest.raises(ValueError, match="backend"):
        tf.render_orbit_frame(scenes[1], 0.0, backend="pallas", **KW)


def _sphere(n):
    """scripts/large_n.py's sphere scene: n seeded points on the unit
    sphere, sigma 0.05, magnitude 1, albedo 0.5 v + 0.5."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v, np.full(n, 0.05, np.float32), np.ones(n, np.float32), 0.5 * v + 0.5


@pytest.mark.parametrize("start,size,min_rays", [
    ((2, 2), 256, 32), ((4, 4), 64, 32), ((2, 2), 64, 256), ((16, 32), 512, 32)])
def test_auto_tile_grid_matches_jax(start, size, min_rays):
    """The same grid and capacity as the JAX package's rule on a dense
    20k-Gaussian sphere: refinement until the fused ceiling (256^2 from
    2x2: (16, 16)), the stop at 128-ray tiles under the chunked ceiling
    (64^2 from 4x4: (8, 4)), the min_rays_per_tile stop (64^2 from 2x2 at
    256 rays: (4, 4)), and a start that already fits (512^2 from 16x32)."""
    import jax.numpy as jnp
    from sgrt_tpu.models.gaussians import GaussianScene as JScene

    fields = _sphere(20_000)
    js = JScene(*map(jnp.asarray, fields))
    ts = scene_from_numpy(*fields, device="cpu")
    kw = dict(start=start, margin=1.2, width=size, height=size, min_rays_per_tile=min_rays)
    want = jf.auto_tile_grid(js, [30.0], -4.0, 1.0, **kw)
    got = tf.auto_tile_grid(ts, [30.0], -4.0, 1.0, **kw)
    assert got == (tuple(want[0]), int(want[1]))
