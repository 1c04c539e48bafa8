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
