"""Port mirror of tests/test_img_error.py: end-to-end image error of every
approximation stack (the reference's img-error test, src/volumetric-ray-
tracer/tests/img-error.cpp:27-60) on sgrt_tpu_torch, and the u32 pixel
packing (sgrt_tpu_torch.ops.packing) against sgrt_tpu.ops.packing.

The 16x16-Gaussian grid scene (sigma 1/4, magnitude 3) at 32x32, rendered
by the port's oracle (ops.reference) and by each stack through the fused
kernels' plain versions (the CPU side of the kernels, ops.cuda_kernel) and
the torch route (ops.render), with the JAX test's cases and MSE bounds.

Each stack's image is also held against the JAX package's
(render_rays_pallas_impl in interpret mode) within the float32 floor of
the Watch-list: the Gaussian exponent -(|oc|^2 - mb^2) / (2 sigma^2)
cancels |oc|^2 (25 to 27 here, ulp 1.9e-6) against mb^2, so two float32
evaluations that round mb or |oc|^2 one step apart differ by up to
2 ulp / (2 sigma^2) = 3.1e-5 of a color; the tolerance is twice that times
the oracle image's peak (the approximations are the same float32 formulas
on both sides, tests/test_torch_approx.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.camera import Camera as JCamera
from sgrt_tpu.models.gaussians import grid_scene as j_grid
from sgrt_tpu.ops import packing as jpack
from sgrt_tpu.ops.pallas_kernel import render_rays_pallas_impl
from sgrt_tpu_torch.models.camera import Camera
from sgrt_tpu_torch.models.gaussians import grid_scene
from sgrt_tpu_torch.ops import packing
from sgrt_tpu_torch.ops.cuda_render import render_rays
from sgrt_tpu_torch.ops.reference import render_rays_reference
from sgrt_tpu_torch.ops.render import render_rays_impl

FLOOR = 2 * 2 * 2.0 ** -19 / (2 * 0.25 ** 2)   # 2 x 2 ulp(|oc|^2 in [16, 32)) / (2 sigma^2)


@pytest.fixture(scope="module")
def oracle():
    # img-error scene (img-error.cpp:18-26) at the JAX test's 32x32
    scene = grid_scene(16, sigma=0.25, magnitude=3.0, device="cpu")
    cam = Camera.create(position=(0.0, 0.0, -4.0), width=32, height=32, device="cpu")
    o, dirs = cam.rays()
    ref = render_rays_reference(o, dirs, scene).numpy()
    return scene, o, dirs, ref


@pytest.fixture(scope="module")
def jax_oracle():
    scene = j_grid(16, sigma=0.25, magnitude=3.0)
    o, dirs = JCamera.create(position=(0.0, 0.0, -4.0), width=32, height=32).rays()
    return scene, o, dirs


def _kernel_image(oracle, erf_name, exp_name="exact"):
    scene, o, dirs, _ = oracle
    return render_rays(o, dirs, scene, erf_name=erf_name, exp_name=exp_name).numpy()


def _matches_jax(img, ref, jax_oracle, erf_name, exp_name):
    want = np.asarray(render_rays_pallas_impl(*jax_oracle[1:], jax_oracle[0],
                                              erf_name=erf_name, exp_name=exp_name,
                                              interpret=True))
    np.testing.assert_allclose(img, want, atol=FLOOR * np.abs(ref).max())


@pytest.mark.parametrize(
    "erf_name,mse_bound",
    [
        ("as5", 1e-10),   # f32-exact erf → numerical noise only
        ("as3", 1e-8),    # reference production stack (2.5e-5 erf error)
        ("spline_mirror", 1e-8),
        ("taylor", 1e-2),  # clamped at ±2 — visibly lossy, like the reference
    ],
)
def test_image_mse_per_stack(oracle, jax_oracle, erf_name, mse_bound):
    img = _kernel_image(oracle, erf_name)
    ref = oracle[3]
    mse = float(np.mean((img - ref) ** 2))
    assert mse <= mse_bound, f"{erf_name}: MSE {mse:.3e} > {mse_bound:.0e}"
    _matches_jax(img, ref, jax_oracle, erf_name, "exact")


@pytest.mark.parametrize(
    "erf_name,exp_name,mse_bound",
    [
        ("as3", "fast", 1e-4),    # the reference's "MINE" stack
        ("as5", "fast", 1e-4),    # fast_exp dominates the error (~3% rel)
        ("as5", "spline", 1e-6),
    ],
)
def test_image_mse_exp_stacks(oracle, jax_oracle, erf_name, exp_name, mse_bound):
    """The exp axis end to end: the transmittance exponential runs the
    chosen approximation in the kernels' plain versions."""
    img = _kernel_image(oracle, erf_name, exp_name)
    ref = oracle[3]
    mse = float(np.mean((img - ref) ** 2))
    assert mse <= mse_bound, f"{erf_name}+{exp_name}: MSE {mse:.3e} > {mse_bound:.0e}"
    assert float(np.abs(img).max()) > 0.01
    _matches_jax(img, ref, jax_oracle, erf_name, exp_name)


@pytest.mark.parametrize(
    "erf_name,exp_name,mse_bound",
    [
        ("exact", "exact", 1e-10),  # fused-vs-oracle numerical noise only
        ("as5", "exact", 1e-10),
        ("as3", "exact", 1e-8),
        ("as3", "fast", 1e-4),      # the reference's "MINE" stack
        ("taylor", "exact", 1e-2),
    ],
)
def test_torch_route_mse_per_stack(oracle, erf_name, exp_name, mse_bound):
    """The approximation axis on the torch route (ops.render, the XLA
    backend's counterpart): --erf/--exp act there too, in the same
    accuracy order as the kernels."""
    scene, o, dirs, ref = oracle
    img = render_rays_impl(o, dirs, scene, erf_name=erf_name, exp_name=exp_name).numpy()
    mse = float(np.mean((img - ref) ** 2))
    assert mse <= mse_bound, f"{erf_name}+{exp_name}: MSE {mse:.3e}"
    assert float(np.abs(img).max()) > 0.01


def test_torch_route_approx_changes_image(oracle):
    """A lossy stack on the torch route changes the pixels (no silent
    fallback to the exact functions)."""
    scene, o, dirs, _ = oracle
    exact = render_rays_impl(o, dirs, scene).numpy()
    lossy = render_rays_impl(o, dirs, scene, erf_name="taylor", exp_name="fast").numpy()
    assert float(np.mean((exact - lossy) ** 2)) > 1e-8


def test_exp_stack_differentiable(oracle):
    """Gradients flow through the approximated-exp render (the backward
    recomputes T with the same exp)."""
    scene, o, dirs, ref = oracle
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in ("mu", "sigma", "magnitude", "albedo")}
    img = render_rays(o, dirs, scene.replace(**leaves), erf_name="as3", exp_name="fast")
    torch.mean((img - torch.from_numpy(ref)) ** 2).backward()
    for f, t in leaves.items():
        g = t.grad.numpy()
        assert np.all(np.isfinite(g)), f
        assert np.abs(g).max() > 0, f


def test_u32_packing_matches_reference_quantization(oracle):
    """Pixel packing follows rt.h:239-243: clamp by min(x, 1), *255,
    truncate, alpha 0xFF, BGRA order."""
    img = oracle[3].reshape(32, 32, 3)
    packed = packing.pack_u32(torch.from_numpy(img))
    assert packed.dtype == torch.uint32
    p = packed.to(torch.int64).numpy()
    r = np.minimum(np.clip(img[..., 0], 0, None), 1.0)
    np.testing.assert_array_equal((p >> 16) & 0xFF, (r * 255.0).astype(np.uint32))
    np.testing.assert_array_equal(p >> 24, 0xFF)


@pytest.mark.parametrize("alpha_from_w", [False, True])
def test_u32_packing_matches_jax(alpha_from_w):
    """pack_u32 bit-equal to the JAX package's on colors below 0, inside
    [0, 1], above 1 and on the 8-bit steps; unpack_u32 gives the JAX
    package's floats and packs back to the same pixels."""
    rng = np.random.default_rng(11)
    img = rng.uniform(-0.3, 1.3, (17, 13, 4)).astype(np.float32)
    img[0, :, :] = np.arange(13, dtype=np.float32)[:, None] / 255.0
    want = np.asarray(jpack.pack_u32(jnp.asarray(img), alpha_from_w=alpha_from_w))
    got = packing.pack_u32(torch.from_numpy(img), alpha_from_w=alpha_from_w)
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))
    rgba = packing.unpack_u32(got)
    assert rgba.dtype == torch.float32 and rgba.shape == (17, 13, 4)
    np.testing.assert_array_equal(rgba.numpy(), np.asarray(jpack.unpack_u32(jnp.asarray(want))))
    back = packing.pack_u32(rgba, alpha_from_w=True)
    np.testing.assert_array_equal(back.to(torch.int64).numpy(), want.astype(np.int64))


def test_unpack_u32_round_trips_every_level():
    """Every 8-bit level of every channel survives unpack and pack."""
    v = np.arange(256, dtype=np.int64)
    p = torch.from_numpy((v[::-1] << 24) | (v << 16) | ((255 - v) << 8) | (v // 2)).to(torch.uint32)
    again = packing.pack_u32(packing.unpack_u32(p), alpha_from_w=True)
    assert again.dtype == torch.uint32
    assert torch.equal(again.to(torch.int64), p.to(torch.int64))
    assert jax.numpy.array_equal(jpack.pack_u32(jnp.asarray(packing.unpack_u32(p).numpy()),
                                                alpha_from_w=True),
                                 jnp.asarray(p.to(torch.int64).numpy().astype(np.uint32)))
