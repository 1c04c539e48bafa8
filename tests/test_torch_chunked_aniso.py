"""Port parity: the chunked anisotropic renderer (sgrt_tpu_torch.ops.
cuda_chunked_aniso, its plain versions on the CPU), its routing and the
anisotropic steps above the monolithic wall, against sgrt_tpu.ops.
pallas_chunked_aniso (Pallas in interpret mode) and sgrt_tpu.parallel.fit,
mirroring tests/test_chunked_aniso.py: 200 seeded Gaussians padded to 384
rows, 3 chunks of 128, R = 256 rays in two ray blocks of 128.

Both packages get the same numpy inputs. Tolerances, derived as in
tests/test_torch_aniso_kernel.py: the exponent -(C - Bt mb)/2 with C ~
|oc|^2 / scale^2 is rounded differently by the two packages (MXU dots and
rsqrt against ordered sums, an IEEE square root and division), so co and
everything after it may differ by C_max 2^-24 relative; colors and
gradients are held at 4 C_max 2^-24 of their scale (4.4e-4 here: C_max
1.9e3, |oc| <= 5.2, scale >= 0.1). Steps: losses rtol 1e-3 against the
JAX package (the isotropic port's tolerance, tests/test_torch_fit.py), and
the slab step
against the port's single step at tests/test_chunked_aniso.py's own
rtol 1e-6 (loss) and rtol 1e-5, atol 1e-7 (updated fields).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.camera import Camera as JCamera
from sgrt_tpu.models.gaussians import grid_scene as j_grid
from sgrt_tpu.ops import anisotropic as jan
from sgrt_tpu.ops import pallas_chunked_aniso as jpca
from sgrt_tpu.ops.frame import orbit_camera as j_orbit
from sgrt_tpu_torch.models.gaussians import grid_scene
from sgrt_tpu_torch.ops import anisotropic as an
from sgrt_tpu_torch.ops import cuda_chunked as tc
from sgrt_tpu_torch.ops import cuda_chunked_aniso as tca
from sgrt_tpu_torch.ops import cuda_render as cr
from sgrt_tpu_torch.ops import kernels
from sgrt_tpu_torch.ops.cuda_aniso import MAX_BWD_CAPACITY_ANISO
from sgrt_tpu_torch.ops.frame import orbit_camera

jfit = importlib.import_module("sgrt_tpu.parallel.fit")
tfit = importlib.import_module("sgrt_tpu_torch.parallel.fit")

FIELDS = ("mu", "scale", "magnitude", "albedo")
KW = dict(ck=128, pb=8, qb=16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tol(oc, invd) -> float:
    """4 C_max 2^-24 (module doc)."""
    c = np.sum(np.asarray(oc, np.float64) ** 2 * np.asarray(invd), axis=-1)
    return 4.0 * float(c.max()) * 2.0 ** -24


@pytest.fixture(scope="module")
def setup():
    """(live count, numpy mu, scale, magnitude, albedo padded to 384 rows,
    dirs (256, 3), origin (3,)): tests/test_chunked_aniso.py's scene."""
    rng = np.random.default_rng(3)
    n_live = 200
    scene = jan.AnisoScene(
        mu=jnp.asarray(rng.uniform(-1, 1, (n_live, 3)), jnp.float32),
        scale=jnp.asarray(rng.uniform(0.1, 0.5, (n_live, 3)), jnp.float32),
        magnitude=jnp.asarray(rng.uniform(0.5, 2.0, (n_live,)), jnp.float32),
        albedo=jnp.asarray(rng.uniform(0, 1, (n_live, 3)), jnp.float32))
    cam = JCamera.create(position=(0.0, 0.0, -4.0), width=32, height=8)
    o, dirs = cam.rays()                           # R = 256, 2 ray blocks
    sp = jan.pad_scene_aniso(scene, 384)           # 3 chunks of 128
    return (n_live, *(np.asarray(getattr(sp, f)) for f in FIELDS), np.asarray(dirs),
            np.asarray(o))


def _jax_chunked(o, mu, scale, mag, alb, dirs, counts):
    oc = mu - o[None, :]
    invd = 1.0 / (scale * scale)
    return jpca.render_fused_chunked_aniso(oc[None], invd[None], mag[None], alb[None],
                                           dirs.T[None], counts, interpret=True, **KW)[0].T


def _port_chunked(o, mu, scale, mag, alb, dirs, counts):
    oc = mu - o[None, :]
    invd = 1.0 / (scale * scale)
    return cr.render_batched(oc[None], invd[None], mag[None], alb[None],
                             dirs.T[None].contiguous(), counts, geometry=cr.ANISO, **KW)[0].T


def _scene_tol(setup):
    n, mu, scale, _, _, _, o = setup
    return _tol(mu[:n] - o, 1.0 / scale[:n] ** 2)


def test_chunked_aniso_forward_matches_jax(setup):
    n, mu, scale, mag, alb, dirs, o = setup
    want = np.asarray(_jax_chunked(*map(jnp.asarray, (o, mu, scale, mag, alb, dirs)),
                                   jnp.asarray([n], jnp.int32)))
    before = [k.launches for k in kernels.KERNELS]
    got = _port_chunked(*map(_t, (o, mu, scale, mag, alb, dirs)),
                        torch.tensor([n], dtype=torch.int32))
    assert [k.launches for k in kernels.KERNELS] == before   # CPU: the plain version
    assert got.shape == (256, 3) and float(got.abs().max()) > 0.01
    tol = _scene_tol(setup)
    assert tol < 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=tol * float(np.abs(want).max()))


def test_chunked_aniso_gradients_match_jax(setup):
    """Gradients with respect to mu, scale (through invd = scale^-2),
    magnitude, albedo and the rays against jax.grad of the JAX package's
    chunked op; padding rows get exactly zero."""
    n, mu, scale, mag, alb, dirs, o = setup
    jo, counts = jnp.asarray(o), jnp.asarray([n], jnp.int32)

    def loss(*a):
        return jnp.sum(_jax_chunked(jo, *a, counts) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (mu, scale, mag, alb,
                                                                       dirs)))
    leaves = [_t(a).requires_grad_(True) for a in (mu, scale, mag, alb, dirs)]
    torch.sum(_port_chunked(_t(o), *leaves, torch.tensor([n], dtype=torch.int32)) ** 2).backward()
    tol = _scene_tol(setup)
    for name, leaf, w in zip(("mu", "scale", "magnitude", "albedo", "dirs"), leaves, want):
        got, w = leaf.grad.numpy(), np.asarray(w)
        assert np.isfinite(got).all(), name
        if name != "dirs":
            assert np.all(got[n:] == 0), f"{name}: padding gradients are not zero"
        sc = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(got / sc, w / sc, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def jax_value_and_grads(setup):
    """sum(colors^2) of the JAX package's chunked op on the setup scene and
    its gradients with respect to mu, scale, magnitude, albedo and dirs."""
    n, mu, scale, mag, alb, dirs, o = setup
    jo, counts = jnp.asarray(o), jnp.asarray([n], jnp.int32)

    def loss(*a):
        return jnp.sum(_jax_chunked(jo, *a, counts) ** 2)

    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (mu, scale, mag, alb, dirs)))
    return float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("save_t", [True, False])
def test_chunked_aniso_schedules_match_jax(setup, jax_value_and_grads, save_t, monkeypatch):
    """The route's two schedules, T saved by the forward (the card's default
    under the budget) and T recomputed by the backward, give the JAX
    package's chunked op's loss and gradients (the JAX package recomputes;
    tolerance 4 C_max 2^-24 of each output's scale, the module doc's), and
    the backward is called with T exactly when it is saved."""
    n, mu, scale, mag, alb, dirs, o = setup
    seen = []
    backward = tca.chunked_backward_aniso

    def spy(*a, **kw):
        seen.append(a[7] is not None)
        return backward(*a, **kw)

    monkeypatch.setattr(tca, "chunked_backward_aniso", spy)
    leaves = [_t(a).requires_grad_(True) for a in (mu, scale, mag, alb, dirs)]
    oc = leaves[0] - _t(o)[None, :]
    invd = 1.0 / (leaves[1] * leaves[1])
    colors = cr.render_batched(
        oc[None], invd[None], leaves[2][None], leaves[3][None], leaves[4].T[None].contiguous(),
        torch.tensor([n], dtype=torch.int32), geometry=cr.ANISO, save_t=save_t, **KW)
    loss = torch.sum(colors ** 2)
    loss.backward()
    assert seen == [save_t]
    tol = _scene_tol(setup)
    want_loss, want = jax_value_and_grads
    assert abs(float(loss.detach()) - want_loss) <= tol * abs(want_loss)
    for name, leaf, w in zip(("mu", "scale", "magnitude", "albedo", "dirs"), leaves, want):
        got = leaf.grad.numpy()
        assert np.isfinite(got).all(), name
        if name != "dirs":
            assert np.all(got[n:] == 0), f"{name}: padding gradients are not zero"
        sc = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(got / sc, w / sc, atol=tol, err_msg=name)


def _routing_tiles():
    """tests/test_chunked_aniso.py's two 128-row tiles (counts 128, 50),
    with the rows past a count the inert dummies tiling produces (mu 0,
    scale 1, magnitude 0, albedo 0: the Pallas kernels sum every row of a
    chunk into base, the port's contract ignores rows past the count)."""
    rng = np.random.default_rng(0)
    t2, k = 2, 128
    tiled = [rng.uniform(-1, 1, (t2, k, 3)), rng.uniform(0.1, 0.4, (t2, k, 3)),
             rng.uniform(0.5, 1.5, (t2, k)), rng.uniform(0, 1, (t2, k, 3))]
    tiled = [a.astype(np.float32) for a in tiled]
    for a, fill in zip(tiled, (0.0, 1.0, 0.0, 0.0)):
        a[1, 50:] = fill
    d = rng.normal(size=(t2, 128, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.array([0.0, 0.0, -4.0], np.float32)
    return tiled, d, o, np.array([k, 50], np.int32)


def _pad_rows(arrays, cap):
    fills = (0.0, 1.0, 0.0, 0.0)
    return [np.concatenate([a, np.full((a.shape[0], cap - a.shape[1]) + a.shape[2:], f,
                                       np.float32)], 1) for a, f in zip(arrays, fills)]


def test_aniso_renderer_routing():
    """tile_renderer_for routes anisotropic tiles above
    MAX_BWD_CAPACITY_ANISO to the chunked anisotropic kernels at the JAX
    package's padded capacity; both
    routes agree on tiles that fit both (the JAX test's rtol 1e-5, atol
    1e-6: the same plain arithmetic on the CPU), and the chunked route
    agrees with the JAX package's."""
    cap_lo, render_lo = tc.tile_renderer_for(128, geometry=cr.ANISO)
    cap_hi, render_hi = tc.tile_renderer_for(MAX_BWD_CAPACITY_ANISO + 1, geometry=cr.ANISO)
    assert cap_lo == jpca.tile_renderer_aniso_for(128)[0]
    assert cap_hi == jpca.tile_renderer_aniso_for(MAX_BWD_CAPACITY_ANISO + 1)[0] == 6656
    tiled, d, o, counts = _routing_tiles()
    tiled_hi = _pad_rows(tiled, cap_hi)
    lo = render_lo(an.AnisoScene(*map(_t, tiled)), _t(o), _t(d), _t(counts))
    hi = render_hi(an.AnisoScene(*map(_t, tiled_hi)), _t(o), _t(d), _t(counts))
    np.testing.assert_allclose(hi.numpy(), lo.numpy(), rtol=1e-5, atol=1e-6)
    j_hi = jpca.tile_renderer_aniso_for(MAX_BWD_CAPACITY_ANISO + 1)[1](
        jan.AnisoScene(*map(jnp.asarray, tiled_hi)), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(counts))
    tol = _tol(tiled[0] - o, 1.0 / tiled[1] ** 2)
    np.testing.assert_allclose(hi.numpy(), np.asarray(j_hi),
                               atol=tol * float(np.abs(np.asarray(j_hi)).max()))


def _stretched_grid(g: int):
    """grid_scene(g, sigma 0.3, magnitude 2) with scales x (1.4, 0.8, 1.0),
    as numpy (mu, scale, magnitude, albedo)."""
    s = j_grid(g, sigma=0.3, magnitude=2.0)
    scale = np.asarray(s.sigma)[:, None] * np.array([1.4, 0.8, 1.0], np.float32)
    return [np.asarray(s.mu), scale.astype(np.float32), np.asarray(s.magnitude),
            np.asarray(s.albedo)]


def test_aniso_step_routes_to_chunked_above_wall():
    """make_aniso_frame_train_step above the monolithic wall builds, takes
    the chunked anisotropic route and descends under Adam, with the JAX
    package's losses."""
    fields = _stretched_grid(3)
    kw = dict(width=16, height=16, tiles=2, capacity=MAX_BWD_CAPACITY_ANISO + 1)
    jcam = j_orbit(0.0, -4.0, 1.0, 16, 16)
    jo, jdirs = jcam.rays()
    jstep = jfit.make_aniso_frame_train_step(optax.adam(1e-2), **kw)
    jst = jfit.init_state(jan.AnisoScene(*map(jnp.asarray, fields)), optax.adam(1e-2))
    cam = orbit_camera(0.0, -4.0, 1.0, 16, 16, device="cpu")
    o, dirs = cam.rays()
    step = tfit.make_aniso_frame_train_step(**kw)
    st = tfit.init_state(an.aniso_scene_from_numpy(*fields, device="cpu"), tfit.adam(1e-2))
    jl, tl = [], []
    for _ in range(4):
        jst, loss, ovf = jstep(jst, jcam.view_matrix, jo, jdirs, jnp.zeros((16, 16, 3)))
        assert int(ovf) == 0
        jl.append(float(loss))
        st, loss, ovf = step(st, cam.view_matrix, o, dirs, torch.zeros(16, 16, 3))
        assert int(ovf) == 0
        tl.append(float(loss))
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


@pytest.fixture(scope="module")
def slab_setup():
    """The stretched 4x4 grid, a 32^2 view and the reference: one SGD step
    of the JAX package's and of the port's single anisotropic step at
    tests/test_chunked_aniso.py's capacity 16."""
    fields = _stretched_grid(4)
    common = dict(width=32, height=32, tiles=4, capacity=16)
    jcam = j_orbit(0.0, -4.0, 1.0, 32, 32)
    jo, jdirs = jcam.rays()
    jst = jfit.init_state(jan.AnisoScene(*map(jnp.asarray, fields)), optax.sgd(1e-2))
    jst, jl, jovf = jfit.make_aniso_frame_train_step(optax.sgd(1e-2), **common)(
        jst, jcam.view_matrix, jo, jdirs, jnp.zeros((32, 32, 3)))
    cam = orbit_camera(0.0, -4.0, 1.0, 32, 32, device="cpu")
    o, dirs = cam.rays()
    opt = functools.partial(torch.optim.SGD, lr=1e-2)
    st = tfit.init_state(an.aniso_scene_from_numpy(*fields, device="cpu"), opt)
    st, tl, tovf = tfit.make_aniso_frame_train_step(**common)(st, cam.view_matrix, o, dirs,
                                                               torch.zeros(32, 32, 3))
    assert int(jovf) == int(tovf) == 0
    return fields, opt, (cam.view_matrix, o, dirs), (float(jl), jst.scene), (float(tl), st.scene)


@pytest.mark.parametrize("capacity", [16, MAX_BWD_CAPACITY_ANISO + 1])
def test_aniso_slab_step_matches_single(slab_setup, capacity):
    """make_slab_frame_train_step(aniso=True), on the fused route (16) and
    on the chunked one (6145), matches the single anisotropic step under
    SGD: the port's at tests/test_chunked_aniso.py's tolerances, the JAX
    package's at the loss's rtol 1e-3 and the fields' atol 1e-6."""
    fields, opt, (view, o, dirs), (jl, jscene), (tl, tscene) = slab_setup
    slab = tfit.make_slab_frame_train_step(width=32, height=32, tiles=4, capacity=capacity,
                                           slab_tiles=4, aniso=True)
    st = tfit.init_state(an.aniso_scene_from_numpy(*fields, device="cpu"), opt)
    st, loss, ovf = slab(st, view, o, dirs, torch.zeros(32, 32, 3))
    assert int(ovf) == 0 and st.step == 1
    np.testing.assert_allclose(float(loss), tl, rtol=1e-6)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-3)
    for f in FIELDS:
        got = getattr(st.scene, f).numpy()
        np.testing.assert_allclose(got, getattr(tscene, f).numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=f)
        np.testing.assert_allclose(got, np.asarray(getattr(jscene, f)), atol=1e-6, err_msg=f)
