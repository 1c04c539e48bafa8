"""Port parity: the fused forward (sgrt_tpu_torch.ops.cuda_kernel) against
the JAX package's Pallas fused forward, run in interpret mode on the CPU.

On CPU tensors the kernel wrapper runs the kernel's plain version, which
is what is held against Pallas here; the CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).

Inputs sit at distance <= 3.5 from the origin with sigma >= 0.05, where
float32 rounding of the Gaussian exponent stays below 1e-6 relative; atol
2e-5 is the JAX package's own kernel tolerance (tests/test_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.gaussians import grid_scene as j_grid
from sgrt_tpu.ops import pallas_chunked as jpc
from sgrt_tpu.ops import pallas_kernel as jpk
from sgrt_tpu.ops.frame import orbit_camera as j_orbit_camera
from sgrt_tpu.ops.render import _tile_rays as j_tile_rays
from sgrt_tpu.ops.tiling import gather_tiles as j_gather, tile_indices as j_indices
from sgrt_tpu_torch.models.gaussians import scene_from_numpy
from sgrt_tpu_torch.ops import cuda_chunked as tpc
from sgrt_tpu_torch.ops import cuda_kernel as tk
from sgrt_tpu_torch.ops import cuda_render as cr

FIELDS = ("mu", "sigma", "magnitude", "albedo")


def _fused_inputs(b=3, n=64, r=128, counts=(64, 17, 0), seed=0, garbage=False):
    """oc, sigma, mag, albedo, dirs_t, counts as numpy; rows past each count
    are the inert dummies tiling produces (or garbage, if asked)."""
    rng = np.random.default_rng(seed)
    oc = (rng.uniform(-1, 1, (b, n, 3)) + [0.0, 0.0, 2.5]).astype(np.float32)
    sig = rng.uniform(0.05, 0.2, (b, n)).astype(np.float32)
    mag = rng.uniform(0.1, 0.5, (b, n)).astype(np.float32)
    alb = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3, r)) * np.array([0.3, 0.3, 1.0])[None, :, None]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cnt = np.asarray(counts, np.int32)
    dead = np.arange(n)[None, :] >= np.minimum(cnt, n)[:, None]
    fill = (np.nan, 0.0, 1e30, 7.0) if garbage else (-0.0, 1.0, 0.0, 0.0)
    oc[dead] = fill[0] if garbage else 0.0
    sig[dead], mag[dead], alb[dead] = fill[1], fill[2], fill[3]
    return oc, sig, mag, alb, d, cnt


def _jax_fused(args, **kw):
    return np.asarray(jpk.render_fused(*(jnp.asarray(a) for a in args), **kw))


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("exact", "exact"),
                                               ("as3", "fast")])
def test_plain_matches_pallas_render_fused(erf_name, exp_name):
    args = _fused_inputs()
    j = _jax_fused(args, pb=8, qb=16, erf_name=erf_name, exp_name=exp_name)
    t = cr.render_batched(*_torch(args), pb=8, qb=16, erf_name=erf_name,
                          exp_name=exp_name).numpy()
    assert t.shape == (3, 3, 128)
    np.testing.assert_allclose(t, j, atol=2e-5)
    assert np.all(t[2] == 0.0)          # count 0: nothing live
    assert np.abs(t[1]).max() > 1e-3    # count 17: a partial tile renders


def test_counts_clamped_and_dead_rows_never_read():
    """Rows past the count are never live, whatever they hold; counts
    above N clamp to N."""
    ref = tk.fused_forward_plain(*_torch(_fused_inputs()))
    junk = tk.fused_forward_plain(*_torch(_fused_inputs(garbage=True)))
    np.testing.assert_array_equal(junk.numpy(), ref.numpy())
    args = _fused_inputs(counts=(64, 64, 64))
    big = list(_torch(args))
    big[5] = torch.tensor([64, 1000, 64], dtype=torch.int32)
    np.testing.assert_array_equal(cr.render_batched(*big).numpy(),
                                  cr.render_batched(*_torch(args)).numpy())


def test_plain_q_blocking_does_not_change_result():
    args = _torch(_fused_inputs())
    whole = tk.fused_forward_plain(*args)
    blocked = tk.fused_forward_plain(*args, max_block_elems=64 * 128 * 3)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), atol=1e-6)


def test_plain_forward_tile_is_independent_of_its_call():
    """A tile's colors are the same bits alone, in any batch and under any
    block budget: the batched orbit's per-frame equality rests on it.
    Counts 64, 17, 0 and 5, 40, 33 give calls of 64, 48 and 16 rows."""
    a, b = _torch(_fused_inputs()), _torch(_fused_inputs(counts=(5, 40, 33), seed=1))
    colors = [tk.fused_forward_plain(*x) for x in (a, b)]
    for i in range(3):
        alone = tk.fused_forward_plain(*(t[i:i + 1] for t in b))
        np.testing.assert_array_equal(alone[0].numpy(), colors[1][i].numpy())
    stacked = tk.fused_forward_plain(*(torch.cat([u, v.flip(0)]) for u, v in zip(a, b)),
                                     max_block_elems=64 * 16 * 128 * 2)
    np.testing.assert_array_equal(stacked[:3].numpy(), colors[0].numpy())
    np.testing.assert_array_equal(stacked[3:].flip(0).numpy(), colors[1].numpy())


def test_wrapper_on_cpu_runs_plain_without_counting():
    before = tk.FUSED_FWD.launches
    args = _torch(_fused_inputs())
    out = tk.fused_forward(*args)
    np.testing.assert_array_equal(out.numpy(), tk.fused_forward_plain(*args).numpy())
    assert tk.FUSED_FWD.launches == before


def test_wrapper_checks_inputs():
    args = _torch(_fused_inputs())
    bad_dtype = list(args)
    bad_dtype[5] = bad_dtype[5].long()
    with pytest.raises(ValueError, match="dtype"):
        tk.fused_forward(*bad_dtype)
    bad_shape = list(args)
    bad_shape[1] = bad_shape[1][:, :5]
    with pytest.raises(ValueError, match="shape"):
        tk.fused_forward(*bad_shape)
    with pytest.raises(ValueError, match="not divisible"):
        cr.render_batched(*args, pb=24)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.fused_forward(*(a.to("meta") for a in args))


def test_plain_gradients_match_pallas_vjp():
    """The plain version is differentiable by autograd on the CPU and its
    gradients equal the Pallas kernel's analytic VJP."""
    args = _fused_inputs(b=2, n=16, r=32, counts=(16, 9))
    g = np.random.default_rng(1).normal(size=(2, 3, 32)).astype(np.float32)

    def jloss(oc, sig, mag, alb, d):
        out = jpk.render_fused(oc, sig, mag, alb, d, jnp.asarray(args[5]), pb=8, qb=8)
        return jnp.sum(out * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args[:5]))
    targs = [t.requires_grad_(True) for t in _torch(args[:5])]
    out = tk.fused_forward_plain(*targs, torch.from_numpy(args[5]))
    (out * torch.from_numpy(g)).sum().backward()
    for name, jgr, t in zip(("oc", "sigma", "mag", "albedo", "dirs"), jgrads, targs):
        jgr = np.asarray(jgr)
        scale = np.abs(jgr).max()
        np.testing.assert_allclose(t.grad.numpy(), jgr, atol=1e-4 * scale,
                                   err_msg=name)


def _port(js):
    return scene_from_numpy(*(np.asarray(getattr(js, f)) for f in FIELDS), device="cpu")


def test_render_tiles_fused_matches_pallas():
    """The per-tile front door at one chunk against the Pallas tiles."""
    js = j_grid(4)
    cam = j_orbit_camera(20.0, -4.0, 1.0, 32, 32)
    o, dirs = cam.rays()
    idx, counts = j_indices(js, cam.view_matrix, 2, 16)
    d = j_tile_rays(dirs, 32, 32, 2)
    j = np.asarray(jpk.render_tiles_pallas(j_gather(js, idx), o, d, counts))
    from sgrt_tpu_torch.ops.tiling import gather_tiles
    tiled = gather_tiles(_port(js), torch.tensor(np.asarray(idx)))
    t = cr.render_tiles(tiled, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
                        torch.tensor(np.asarray(counts)))
    assert t.shape == (4, 256, 3)
    np.testing.assert_allclose(t.numpy(), j, atol=2e-5)


@pytest.mark.parametrize("n_rays", [100, 256])
def test_render_rays_fused_impl_matches_pallas(n_rays):
    """Flat ray batch as one tile; 100 rays pad to the 128-ray block with
    unit directions."""
    js = j_grid(4, sigma=0.25, magnitude=2.0)
    cam = j_orbit_camera(15.0, -3.0, 1.0, 16, 16)
    o, dirs = cam.rays()
    dirs = dirs[:n_rays]
    j = np.asarray(jpk.render_rays_pallas_impl(o, dirs, js))
    t = cr.render_rays(torch.tensor(np.asarray(o)), torch.tensor(np.asarray(dirs)), _port(js))
    assert t.shape == (n_rays, 3)
    np.testing.assert_allclose(t.numpy(), j, atol=2e-5)


@pytest.mark.parametrize("geometry,capacity,padded", [
    *(("iso", c, p) for c, p in ((1, 16), (17, 32), (64, 64), (250, 256), (257, 288),
                                 (1359, 1376), (4096, 4096))),
    *(("aniso", c, p) for c, p in ((20, 32), (300, 320), (6144, 6144)))])
def test_tile_renderer_padding_matches(geometry, capacity, padded):
    """The one router, for either row geometry, against the JAX package's
    router of that geometry: up to the ceiling of one chunk
    (MAX_BWD_CAPACITY; MAX_BWD_CAPACITY_ANISO) the capacity padded to
    lcm(pb, qb), pb/qb overrides included; above it chunk_plan's padded
    capacity, whose render refuses a padded capacity past
    MAX_CHUNKED_CAPACITY."""
    from sgrt_tpu.ops import pallas_aniso as jpa
    from sgrt_tpu.ops.pallas_chunked_aniso import tile_renderer_aniso_for

    geo, j_route, j_ceiling = {
        "iso": (cr.ISO, jpc.tile_renderer_for, jpk.MAX_BWD_CAPACITY),
        "aniso": (cr.ANISO, tile_renderer_aniso_for, jpa.MAX_BWD_CAPACITY_ANISO)}[geometry]
    assert geo.ceiling() == j_ceiling
    assert tpc.tile_renderer_for(capacity, geometry=geo)[0] == padded == j_route(capacity)[0]
    assert tpc.tile_renderer_for(capacity, geometry=geo, pb=16, qb=48)[0] == \
        j_route(capacity, pb=16, qb=48)[0]
    above = j_ceiling + 1
    assert (tpc.tile_renderer_for(above, geometry=geo)[0] == j_route(above)[0]
            == tpc.chunk_plan(above)[0])
    cap_top, render_top = tpc.tile_renderer_for(tpc.MAX_CHUNKED_CAPACITY + 1, geometry=geo)
    z = torch.zeros
    shape = torch.ones((1, cap_top) if geo is cr.ISO else (1, cap_top, 3))
    tiled = geo.scene(z(1, cap_top, 3), shape, z(1, cap_top), z(1, cap_top, 3))
    with pytest.raises(ValueError, match="MAX_CHUNKED_CAPACITY"):
        render_top(tiled, z(3), z(1, 8, 3), torch.ones(1, dtype=torch.int32))


def test_tile_renderer_refuses_above_monolithic_ceiling(monkeypatch):
    """Above the monolithic ceiling the fused kernels are refused: the
    route is the chunked one, at chunk_plan's padded capacity."""
    assert tpc.MAX_MONOLITHIC_CAPACITY == jpk.MAX_BWD_CAPACITY

    def spy(*a, ck=None, **k):
        if ck is None:
            pytest.fail("fused route above the ceiling")
        return "chunked"

    monkeypatch.setattr(cr, "render_tiles", spy)
    cap, fn = tpc.tile_renderer_for(tpc.MAX_MONOLITHIC_CAPACITY + 1)
    assert cap == tpc.chunk_plan(tpc.MAX_MONOLITHIC_CAPACITY + 1)[0]
    assert fn(None, None, None, None) == "chunked"
    assert tpc.chunk_plan(10000) == jpc.chunk_plan(10000)


def test_tile_renderer_passes_block_overrides(monkeypatch):
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return torch.zeros(1)

    monkeypatch.setattr(cr, "render_tiles", spy)
    _, fn = tpc.tile_renderer_for(100, pb=16, qb=32, rb=64)
    fn(None, None, None, None)
    assert (seen["pb"], seen["qb"], seen["rb"], seen["ck"]) == (16, 32, 64, None)


def test_constants_match():
    assert tk.K_TAPS == jpk.K_TAPS
    np.testing.assert_allclose(tk.K_WEIGHTS, jpk.K_WEIGHTS, rtol=0)
    for n in (8, 256, 257, 4096):
        assert tk._block_sizes(n) == jpk._block_sizes(n)
    assert tk._kernel_erf_name("exact") == "as5"
