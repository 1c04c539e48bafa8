"""Port parity: the oracle (ops.reference) and the plain fused renderer
(ops.render) of sgrt_tpu_torch against sgrt_tpu.

Tolerance: float32 renders of a scene seen from a distance d have an
inherent error of about |color| * ulp(d^2) / sigma^2, because the Gaussian
exponent -(|oc|^2 - mb^2) / (2 sigma^2) subtracts two numbers near d^2, and
two float32 evaluations that round mb differently differ by that much.
The scenes here sit at d <= 3 with sigma >= 0.15, which keeps the bound
under 1e-6 relative; atol 2e-5 holds the renders' other rounding.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.camera import Camera as JCamera
from sgrt_tpu.models.gaussians import make_scene
from sgrt_tpu.ops import reference as jref
from sgrt_tpu_torch.models.camera import Camera as TCamera
from sgrt_tpu_torch.models.gaussians import scene_from_numpy
from sgrt_tpu_torch.ops import reference as tref

jr = importlib.import_module("sgrt_tpu.ops.render")
tr = importlib.import_module("sgrt_tpu_torch.ops.render")


def _scene_np(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        mu=(rng.uniform(-0.8, 0.8, (n, 3)) + [0.0, 0.0, 1.0]).astype(np.float32),
        sigma=rng.uniform(0.15, 0.4, n).astype(np.float32),
        magnitude=rng.uniform(0.2, 1.5, n).astype(np.float32),
        albedo=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def setup():
    s = _scene_np()
    js = make_scene(**s)
    ts = scene_from_numpy(**s, device="cpu")
    jc = JCamera.create(position=(0.0, 0.0, -2.0), width=8, height=8)
    tc = TCamera.create(position=(0.0, 0.0, -2.0), width=8, height=8, device="cpu")
    jo, jd = jc.rays()
    to, td = tc.rays()
    return js, ts, jo, jd, to, td


def test_transmittance_density_match(setup):
    js, ts, jo, jd, to, td = setup
    for i in (0, 27, 63):
        for s in (0.5, 2.0, 3.5):
            np.testing.assert_allclose(
                float(jref.transmittance(jo, jd[i], s, js)),
                float(tref.transmittance(to, td[i], s, ts)), rtol=2e-6)
    np.testing.assert_allclose(
        float(jref.transmittance_step(jo, jd[5], 3.0, 0.05, js)),
        float(tref.transmittance_step(to, td[5], 3.0, 0.05, ts)), rtol=2e-6)
    pt = [0.1, 0.2, 1.0]
    np.testing.assert_allclose(float(jref.density(pt, js)),
                               float(tref.density(pt, ts)), rtol=2e-6)


def test_reference_render_matches(setup):
    js, ts, jo, jd, to, td = setup
    j = np.asarray(jref.render_rays_reference(jo, jd, js, chunk=16))
    t = tref.render_rays_reference(to, td, ts, chunk=16).numpy()
    np.testing.assert_allclose(t, j, atol=2e-5)
    np.testing.assert_allclose(tref.radiance(to, td[9], ts).numpy(), j[9], atol=2e-5)


@pytest.mark.parametrize("erf_name,exp_name", [("exact", "exact"), ("as5", "exact"),
                                               ("as3", "fast"), ("spline", "spline")])
def test_plain_fused_render_matches(setup, erf_name, exp_name):
    js, ts, jo, jd, to, td = setup
    j = np.asarray(jr.render_rays_impl(jo, jd, js, q_block=16, ray_block=48,
                                       erf_name=erf_name, exp_name=exp_name))
    t = tr.render_rays_impl(to, td, ts, q_block=16, ray_block=48,
                            erf_name=erf_name, exp_name=exp_name).numpy()
    np.testing.assert_allclose(t, j, atol=2e-5)


def test_plain_fused_render_matches_oracle(setup):
    """Within the port: the simplified fused formulation equals the literal
    quadrature (the JAX package's test_render contract)."""
    js, ts, jo, jd, to, td = setup
    fused = tr.render_rays_impl(to, td, ts, q_block=8, ray_block=32).numpy()
    oracle = tref.render_rays_reference(to, td, ts).numpy()
    np.testing.assert_allclose(fused, oracle, atol=2e-5)


def test_full_frame_render_matches(setup):
    js, ts, *_ = setup
    jc = JCamera.create(position=(0.3, 0.0, -2.0), yaw=-85.0, width=12, height=8)
    tc = TCamera.create(position=(0.3, 0.0, -2.0), yaw=-85.0, width=12, height=8,
                        device="cpu")
    j = np.asarray(jr.render(js, jc, q_block=8))
    t = tr.render(ts, tc, q_block=8)
    assert t.shape == (8, 12, 3)
    np.testing.assert_allclose(t.numpy(), j, atol=2e-5)


def test_plain_render_is_differentiable(setup):
    js, ts, jo, jd, to, td = setup
    mu = ts.mu.clone().requires_grad_(True)
    t = tr.render_rays_impl(to, td, ts.replace(mu=mu), q_block=8, ray_block=64)
    t.square().sum().backward()
    assert torch.isfinite(mu.grad).all() and mu.grad.abs().max() > 0


@pytest.mark.parametrize("tiles,h,w", [(2, 8, 8), ((4, 2), 8, 16), ((2, 4), 16, 8)])
def test_tile_untile_match(tiles, h, w):
    rng = np.random.default_rng(1)
    d = rng.normal(size=(h * w, 3)).astype(np.float32)
    jt = np.asarray(jr._tile_rays(jnp.asarray(d), h, w, tiles))
    tt = tr._tile_rays(torch.from_numpy(d), h, w, tiles)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(
        tr._untile_image(tt, h, w, tiles).numpy(),
        np.asarray(jr._untile_image(jnp.asarray(jt), h, w, tiles)))
    np.testing.assert_array_equal(tr._untile_image(tt, h, w, tiles).numpy(),
                                  d.reshape(h, w, 3))


# --- render_tiled (the tiled, culled plain render) and the plain renderer's
# gradients, mirrors of tests/test_tiling.py:110-128 and
# tests/test_render.py:61-90; 8e-5 is the port's frame-parity bound
# (tests/test_torch_frame.py)

def _random_scene_np(seed=7, n=40):
    """tests/test_tiling.py's random_scene."""
    rng = np.random.default_rng(seed)
    return dict(mu=rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 2.5]),
                sigma=rng.uniform(0.05, 0.4, n), magnitude=rng.uniform(0.2, 2.0, n),
                albedo=rng.uniform(0, 1, (n, 3)))


def test_tiled_render_matches_untiled():
    from sgrt_tpu_torch.models.gaussians import grid_scene

    scene = grid_scene(4, device="cpu")
    cam = TCamera.create(position=(0.0, 0.0, -4.0), width=32, height=32, device="cpu")
    full = tr.render(scene, cam, q_block=16, ray_block=256)
    tiled = tr.render_tiled(scene, cam, tiles=4, q_block=16, tile_batch=4)
    assert tiled.shape == (32, 32, 3)
    # culling may drop contributions under 1/255 (the 3.3 sigma bound)
    assert float((full - tiled).abs().max()) < 2.0 / 255.0
    assert float(tiled.max()) > 0.05


def test_capacity_overflow_raises():
    from sgrt_tpu_torch.ops.tiling import max_tile_count

    scene = scene_from_numpy(**_random_scene_np(), device="cpu")
    cam = TCamera.create(position=(0.0, 0.0, -4.0), width=32, height=32, device="cpu")
    assert max_tile_count(scene, cam.view_matrix, 2) > 2
    with pytest.raises(ValueError, match="overflow"):
        tr.render_tiled(scene, cam, tiles=2, capacity=2, q_block=2, tile_batch=4)
    img = tr.render_tiled(scene, cam, tiles=2, capacity=2, q_block=2, check_overflow=False)
    assert img.shape == (32, 32, 3)
    with pytest.raises(ValueError, match="not divisible"):
        tr.render_tiled(scene, TCamera.create(width=30, height=32, device="cpu"), tiles=4)


@pytest.mark.parametrize("tiles,capacity", [((4, 2), None), (4, 20)])
def test_render_tiled_matches_jax(tiles, capacity):
    s = _random_scene_np()
    js = make_scene(**s)
    ts = scene_from_numpy(**s, device="cpu")
    jc = JCamera.create(position=(0.2, 0.1, -4.0), width=32, height=16)
    tc = TCamera.create(position=(0.2, 0.1, -4.0), width=32, height=16, device="cpu")
    j = np.asarray(jr.render_tiled(js, jc, tiles=tiles, capacity=capacity, q_block=16,
                                   tile_batch=4))
    t = tr.render_tiled(ts, tc, tiles=tiles, capacity=capacity, q_block=16, tile_batch=4)
    np.testing.assert_allclose(t.numpy(), j, atol=8e-5)
    assert float(t.max()) > 0.05


def test_render_rays_gradients_match_oracle():
    """The plain renderer's gradients against autograd of the oracle
    (ops.reference), every scene field, at tests/test_render.py's bounds."""
    rng = np.random.default_rng(0)           # tests/test_render.py's random_scene
    s = dict(mu=rng.uniform(-1, 1, (24, 3)) + np.array([0, 0, 2.0]),
             sigma=rng.uniform(0.1, 0.5, 24), magnitude=rng.uniform(0.2, 2.0, 24),
             albedo=rng.uniform(0, 1, (24, 3)))
    rng = np.random.default_rng(3)
    d = rng.normal(size=(8, 3)) * 0.15 + np.array([0, 0, 1.0])
    dirs = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    o = torch.zeros(3)

    def grads(loss_of):
        scene = scene_from_numpy(**s, device="cpu")
        leaves = [getattr(scene, f).requires_grad_(True)
                  for f in ("mu", "sigma", "magnitude", "albedo")]
        loss_of(scene).backward()
        return [x.grad.numpy() for x in leaves]

    fast = grads(lambda sc: torch.sum(tr.render_rays_impl(o, dirs, sc, q_block=8,
                                                          ray_block=8) ** 2))
    oracle = grads(lambda sc: torch.sum(tref.render_rays_reference(o, dirs, sc, chunk=8) ** 2))
    for a, b in zip(fast, oracle):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-4)
    assert max(float(np.abs(g).max()) for g in fast) > 1e-3


def test_origin_gradient_finite_with_ray_padding():
    """render_rays_impl pads 256 live rays to a 2048-ray block; the dead
    rays (unit direction) must not poison the shared origin's gradient."""
    from sgrt_tpu_torch.models.gaussians import grid_scene

    scene = grid_scene(3, device="cpu")
    cam = TCamera.create(position=(0.0, 0.0, -4.0), width=16, height=16, device="cpu")
    o, dirs = cam.rays()
    o = o.clone().requires_grad_(True)
    torch.sum(tr.render_rays_impl(o, dirs, scene, q_block=16, ray_block=2048)).backward()
    assert torch.isfinite(o.grad).all() and float(o.grad.abs().max()) > 0
