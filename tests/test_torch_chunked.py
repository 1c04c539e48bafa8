"""Port parity: the Gaussian-axis chunked renderer (sgrt_tpu_torch.ops.
cuda_chunked, its plain versions on the CPU) against sgrt_tpu.ops.
pallas_chunked, Pallas in interpret mode, at tests/test_chunked.py's sizes:
grid_scene(16) padded to 384 rows, 3 chunks of 128, R = 256 rays in two ray
blocks of 128.

Both packages get the same numpy inputs. Tolerances are the JAX package's
own (tests/test_chunked.py): 2e-5 absolute for colors, 5e-5 of each
field's max |value| for gradients. The scene sits 4 units from the camera
with sigma = 0.25, so the float32 conditioning of the exponent (|oc|^2
cancelled against mb^2, tests/test_torch_frame.py) is 2 ulp(25) /
(2 sigma^2) = 6e-5 relative on a color of at most ~0.1: ~6e-6, inside 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.camera import Camera as JCamera
from sgrt_tpu.models.gaussians import GaussianScene as JScene
from sgrt_tpu.models.gaussians import grid_scene as j_grid
from sgrt_tpu.models.gaussians import pad_scene as j_pad
from sgrt_tpu.ops import pallas_chunked as jpc
from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops import cuda_chunked as tc
from sgrt_tpu_torch.ops import kernels
from sgrt_tpu_torch.ops import cuda_render as cr

GRAD_NAMES = ("oc", "sigma", "mag", "albedo", "dirs")
KW = dict(ck=128, pb=8, qb=16)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    """(live count, numpy oc (384,3), sigma, mag, albedo (padded), dirs
    (256,3), origin)."""
    base = j_grid(16, sigma=0.25, magnitude=3.0)          # 256 live
    cam = JCamera.create(position=(0.0, 0.0, -4.0), width=32, height=8)
    o, dirs = cam.rays()                                  # R = 256
    sp = j_pad(base, 384)                                 # 3 chunks of 128
    arrs = [np.asarray(a) for a in (sp.mu - o[None, :], sp.sigma, sp.magnitude, sp.albedo,
                                    dirs)]
    return base.n, *arrs, np.asarray(o)


def _jax_render(oc, sig, mag, alb, dirs, counts, **kw):
    return jpc.render_fused_chunked(oc[None], sig[None], mag[None], alb[None], dirs.T[None],
                                    jnp.asarray(counts, jnp.int32), interpret=True,
                                    **KW, **kw)[0].T


def _port_render(oc, sig, mag, alb, dirs, counts, **kw):
    return cr.render_batched(oc[None], sig[None], mag[None], alb[None], dirs.T[None].contiguous(),
                             torch.tensor(counts, dtype=torch.int32), **KW, **kw)[0].T


def test_chunked_forward_matches_jax(setup):
    n, oc, sig, mag, alb, dirs, _ = setup
    want = np.asarray(_jax_render(*map(jnp.asarray, (oc, sig, mag, alb, dirs)), [n]))
    before = [k.launches for k in kernels.KERNELS]
    got = _port_render(*map(_t, (oc, sig, mag, alb, dirs)), [n])
    assert [k.launches for k in kernels.KERNELS] == before   # CPU: the plain version
    assert got.shape == (256, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert float(got.abs().max()) > 0.01


@pytest.fixture(scope="module")
def jax_grads(setup):
    n, oc, sig, mag, alb, dirs, _ = setup

    def loss(*a):
        return jnp.sum(_jax_render(*a, [n], save_t=False) ** 2)

    g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (oc, sig, mag, alb, dirs)))
    return [np.asarray(x) for x in g]


@pytest.mark.parametrize("save_t", [True, False])
def test_chunked_gradients_match_jax(setup, jax_grads, save_t):
    """Both schedules, saved-T and recompute, against the JAX chunked op's
    gradients; padding rows get exactly zero."""
    n, *arrs, _ = setup
    leaves = [_t(a).requires_grad_(True) for a in arrs]
    torch.sum(_port_render(*leaves, [n], save_t=save_t) ** 2).backward()
    for name, leaf, want in zip(GRAD_NAMES, leaves, jax_grads):
        got = leaf.grad.numpy()
        assert np.isfinite(got).all(), name
        if name != "dirs":
            assert np.all(got[n:] == 0), f"{name}: padding gradients are not zero"
        scale = max(np.abs(want).max(), 1e-8)
        np.testing.assert_allclose(got / scale, want / scale, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("erf_name", ["taylor", "spline_mirror"])
def test_chunked_vjp_without_pair_matches_jax(setup, erf_name):
    """Under an erf without an (erf, gauss) pair, both schedules of the
    chunked op against the JAX chunked op's gradients (its backward takes
    T, base included, from the named erf and the cotangents' erf values
    and erf' from as5's pair: the one VJP of every route)."""
    n, *arrs, _ = setup

    def loss(*a):
        return jnp.sum(_jax_render(*a, [n], save_t=False, erf_name=erf_name) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))
    for save_t in (True, False):
        leaves = [_t(a).requires_grad_(True) for a in arrs]
        torch.sum(_port_render(*leaves, [n], save_t=save_t, erf_name=erf_name) ** 2).backward()
        for name, leaf, w in zip(GRAD_NAMES, leaves, want):
            w = np.asarray(w)
            scale = max(np.abs(w).max(), 1e-8)
            np.testing.assert_allclose(leaf.grad.numpy() / scale, w / scale, atol=5e-5,
                                       err_msg=f"{name}, save_t={save_t}")


def test_chunked_batch_counts_and_dead_chunks(setup):
    """Counts (256, 20, 0): a tile with two live chunks, one whose only live
    chunk is partly live, and a dead tile. Colors match the JAX package's;
    the dead tile and every row past a count get exactly zero colors and
    gradients."""
    n, oc, sig, mag, alb, dirs, o = setup
    counts = [256, 20, 0]
    short = [np.concatenate([a[:20], np.broadcast_to(p, (364,) + a.shape[1:])])
             for a, p in ((oc, -o), (sig, 1.0), (mag, 0.0), (alb, 0.0))]
    inert = [np.broadcast_to(p, a.shape).copy() for a, p in
             ((oc, -o), (sig, 1.0), (mag, 0.0), (alb, 0.0))]
    fields = [np.stack(f).astype(np.float32) for f in zip((oc, sig, mag, alb), short, inert)]
    dirs_t = np.ascontiguousarray(np.tile(dirs.T[None], (3, 1, 1)))
    want = np.asarray(jpc.render_fused_chunked(*map(jnp.asarray, fields), jnp.asarray(dirs_t),
                                               jnp.asarray(counts, jnp.int32), interpret=True,
                                               **KW))
    leaves = [_t(a).requires_grad_(True) for a in (*fields, dirs_t)]
    got = cr.render_batched(*leaves, torch.tensor(counts, dtype=torch.int32), **KW)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    assert torch.all(got[2] == 0)
    torch.sum(got ** 2).backward()
    for name, leaf in zip(GRAD_NAMES, leaves):
        assert torch.all(leaf.grad[2] == 0), name
        if name != "dirs":
            assert torch.all(leaf.grad[1, 20:] == 0) and torch.all(leaf.grad[0, 256:] == 0), name


def test_render_tiles_chunked_matches_fused(setup):
    """The per-tile front door chunked against itself at one chunk and the
    JAX package's chunked one, on tiles that fit both."""
    n, oc, sig, mag, alb, dirs, o = setup
    mu = oc + o
    tiled_np = [np.tile(a[None], (4,) + (1,) * a.ndim) for a in (mu, sig, mag, alb)]
    d = np.tile(dirs[None, :64], (4, 1, 1))
    counts = [256, 256, 32, 0]
    tiled = GaussianScene(*map(_t, tiled_np))
    cnt = torch.tensor(counts, dtype=torch.int32)
    ch = cr.render_tiles(tiled, _t(o), _t(d), cnt, **KW)
    fused = cr.render_tiles(tiled, _t(o), _t(d), cnt, pb=8, qb=16)
    jch = jpc.render_tiles_chunked(JScene(*map(jnp.asarray, tiled_np)), jnp.asarray(o),
                                   jnp.asarray(d), jnp.asarray(counts, jnp.int32),
                                   interpret=True, **KW)
    assert ch.shape == (4, 64, 3)
    np.testing.assert_allclose(ch.numpy(), fused.numpy(), atol=1e-6)
    np.testing.assert_allclose(ch.numpy(), np.asarray(jch), atol=2e-5)


@pytest.mark.parametrize("geometry", ["iso", "aniso"])
@pytest.mark.parametrize("over", [False, True])
def test_chunked_route_picks_saved_t_by_budget(geometry, over, monkeypatch):
    """save_t=None saves T when its 20 B N R bytes fit
    SAVE_T_CHUNKED_MAX_BYTES (the forward-with-T runs and the backward gets
    T) and recomputes above it, by one rule for both row geometries."""
    from sgrt_tpu_torch.ops import cuda_chunked_aniso as tca

    iso = geometry == "iso"
    geo, mod, sfx = (cr.ISO, tc, "") if iso else (cr.ANISO, tca, "_aniso")
    rng = np.random.default_rng(8 if iso else 7)
    b, n, r = 2, 256, 64
    oc = _t(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32) + np.float32([0, 0, 4]))
    shape = _t(rng.uniform(0.2, 0.5, (b, n)).astype(np.float32) if iso else
               rng.uniform(4, 25, (b, n, 3)).astype(np.float32))
    mag, alb = _t(rng.uniform(0.5, 1, (b, n)).astype(np.float32)), _t(
        rng.uniform(0, 1, (b, n, 3)).astype(np.float32))
    d = rng.normal(size=(b, 3, r)).astype(np.float32) * np.float32([0.2, 0.2, 1])[None, :, None]
    dirs = _t(d / np.linalg.norm(d, axis=1, keepdims=True))
    nbytes = 20 * b * n * r
    monkeypatch.setattr(tc, "SAVE_T_CHUNKED_MAX_BYTES", nbytes - 1 if over else nbytes)
    calls = []
    for name in (f"chunked_forward{sfx}", f"chunked_forward_t{sfx}", f"chunked_backward{sfx}"):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, len(a) > 7 and a[7] is not None))
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    leaves = [x.requires_grad_(True) for x in (oc, shape, mag, alb, dirs)]
    counts = torch.tensor([n, 100], dtype=torch.int32)
    cr.render_batched(*leaves, counts, geometry=geo, ck=128, qb=16).sum().backward()
    want = ([(f"chunked_forward{sfx}", False), (f"chunked_backward{sfx}", False)] if over else
            [(f"chunked_forward_t{sfx}", False), (f"chunked_backward{sfx}", True)])
    assert calls == want
    assert all(torch.isfinite(x.grad).all() for x in leaves)


@pytest.mark.parametrize("geometry,capacity", [
    *(("iso", c) for c in (4097, 5000, 5248, 12000, 65536)),
    *(("aniso", c) for c in (6145, 11008, 65536))])
def test_tile_renderer_routes_chunked_above_wall(geometry, capacity, monkeypatch):
    """Above the row geometry's ceiling of one chunk (MAX_MONOLITHIC_CAPACITY;
    MAX_BWD_CAPACITY_ANISO, 6144) the chunked route renders at the JAX
    package's padded capacity (11008: 6 chunks of 1920, the 50k-Gaussian
    anisotropic scene's), and pb/qb/rb reach it (the JAX package drops them
    there)."""
    from sgrt_tpu.ops import pallas_chunked_aniso as jpca

    geo, j_route = ((cr.ISO, jpc.tile_renderer_for) if geometry == "iso" else
                    (cr.ANISO, jpca.tile_renderer_aniso_for))
    assert tc.MAX_CHUNKED_CAPACITY == jpc.MAX_CHUNKED_CAPACITY
    cap, fn = tc.tile_renderer_for(capacity, geometry=geo, pb=16, qb=32, rb=64)
    assert cap == j_route(capacity)[0] == tc.chunk_plan(capacity)[0]
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return torch.zeros(1)

    monkeypatch.setattr(cr, "render_tiles", spy)
    fn(None, None, None, None)
    assert (seen["pb"], seen["qb"], seen["rb"], seen["ck"]) == (16, 32, 64,
                                                                 tc.chunk_plan(capacity)[1])
    if capacity == 11008:
        assert tc.chunk_plan(capacity) == (11520, 1920)


def test_chunk_plan_and_contract():
    for cap in (1, 100, 2048, 2049, 4097, 5000, 5248, 12000, 65536):
        assert tc.chunk_plan(cap) == jpc.chunk_plan(cap)
    assert tc.chunk_plan(5248) == (5376, 1792)
    z = torch.zeros
    args = (z(1, 384, 3), z(1, 384), z(1, 384), z(1, 384, 3), z(1, 3, 8),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="chunks"):
        tc.chunked_forward(*args, ck=256)
    with pytest.raises(ValueError, match="MAX_CHUNKED_CAPACITY"):
        cr.render_batched(z(1, 65536 + 128, 3), z(1, 65536 + 128), z(1, 65536 + 128),
                          z(1, 65536 + 128, 3), z(1, 3, 8), ck=128)


def test_check_bwd_capacity_raises_above_chunked_ceiling():
    from sgrt_tpu.parallel.fit import _check_bwd_capacity as j_check
    from sgrt_tpu_torch.ops.scheduler import BucketConfig
    from sgrt_tpu_torch.parallel.fit import _check_bwd_capacity

    top = tc.MAX_CHUNKED_CAPACITY
    with pytest.raises(ValueError, match="chunked"):
        _check_bwd_capacity(top + 1, None, "kernel")
    with pytest.raises(ValueError, match="chunked"):
        j_check(top + 1, None, "pallas")
    with pytest.raises(ValueError, match="chunked"):
        _check_bwd_capacity(64, BucketConfig(4, top + 1, 64), "kernel")
    _check_bwd_capacity(top, None, "kernel")          # no raise, as the JAX package
    j_check(top, None, "pallas")
    _check_bwd_capacity(top + 1, None, "torch")       # the plain route has no ceiling
