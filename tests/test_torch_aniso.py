"""Port parity: anisotropic scenes (sgrt_tpu_torch.ops.anisotropic, the
aniso train step and checkpoints, device="cpu") against the JAX package's
sgrt_tpu.ops.anisotropic and make_aniso_frame_train_step, Pallas in
interpret mode, on tests/test_aniso.py's scene (8 seeded Gaussians, 16^2
frames) and a stretched 4x4 grid (32^2, 4x4 tiles).

Both sides get the same numpy inputs. Tolerances, derived: the exponent
of cbar, -(C - B^2/A)/2 with C ~ |o - mu|^2 / scale^2, cancels two numbers
of size C, which the two packages round differently (XLA dots against the
port's matrix products or ordered sums), so a color may differ by about
C_max 2^-24 relative. Images are held at 4 C_max 2^-24 of their scale (a
factor 2 for the two roundings, 2 for accumulation): 1.6e-4 on the JAX
test scene (C_max 2.6e3 at scale >= 0.08), 8e-4 on the stretched grid
(C_max 1.2e4 at scale 0.0875). Losses: rtol 1e-3, the isotropic port's
tolerance (tests/test_torch_fit.py). Updated scenes after one SGD step:
the gradient differences times the step, atol 1e-6.
"""

import dataclasses
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
from sgrt_tpu.ops.frame import orbit_camera as j_orbit
from sgrt_tpu.ops.scheduler import BucketConfig as JBucket
from sgrt_tpu_torch.models.camera import Camera
from sgrt_tpu_torch.models.gaussians import grid_scene
from sgrt_tpu_torch.ops import anisotropic as an
from sgrt_tpu_torch.ops.frame import orbit_camera
from sgrt_tpu_torch.ops.render import render_rays_impl
from sgrt_tpu_torch.ops.scheduler import BucketConfig
from sgrt_tpu_torch.utils.checkpoint import make_manager, restore_fit, save_fit

jfit = importlib.import_module("sgrt_tpu.parallel.fit")
tfit = importlib.import_module("sgrt_tpu_torch.parallel.fit")

FIELDS = ("mu", "scale", "magnitude", "albedo")
MULT = (1.6, 0.7, 1.0)


def _scene_np():
    """tests/test_aniso.py's scene."""
    rng = np.random.default_rng(7)
    n = 8
    mu = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    mu[:, 2] = rng.uniform(0.5, 1.5, n)
    return (mu, rng.uniform(0.08, 0.4, (n, 3)).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32))


def _grid_np():
    """grid_scene(4) with per-axis scales sigma * MULT."""
    g = j_grid(4)
    return (np.asarray(g.mu), np.asarray(g.sigma)[:, None] * np.float32(MULT),
            np.asarray(g.magnitude), np.asarray(g.albedo))


def _both(fields):
    return (jan.AnisoScene(*(jnp.asarray(f) for f in fields)),
            an.aniso_scene_from_numpy(*fields, device="cpu"))


def _tol(fields, o) -> float:
    """4 C_max 2^-24 (module doc)."""
    mu, scale = fields[0].astype(np.float64), fields[1].astype(np.float64)
    return 4.0 * float(np.max(np.sum((mu - np.asarray(o)) ** 2 / scale ** 2, -1))) * 2.0 ** -24


def _close(got, want, tol, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _cams(size=16):
    jc = JCamera.create(position=(0.0, 0.0, -2.5), width=size, height=size)
    tc = Camera.create(position=(0.0, 0.0, -2.5), width=size, height=size, device="cpu")
    return jc, tc


def test_oracle_matches_jax_oracle():
    """Transmittance (closed form and Riemann sum) and the literal 5-tap
    radiance oracle, one ray, against the JAX package's."""
    fields = _scene_np()
    js, ts = _both(fields)
    o = np.array([0.1, -0.2, -2.5], np.float32)
    n = np.array([0.05, 0.02, 1.0], np.float32)
    n /= np.linalg.norm(n)
    jo, jn, to, tn = jnp.asarray(o), jnp.asarray(n), torch.from_numpy(o), torch.from_numpy(n)
    tol = _tol(fields, o)
    for s in (1.0, 2.5, 4.0):
        _close(an.transmittance_aniso(to, tn, s, ts), jan.transmittance_aniso(jo, jn, s, js),
               tol, f"T({s})")
        closed = float(an.transmittance_aniso(to, tn, s, ts))
        assert abs(closed - float(an.transmittance_step_aniso(to, tn, s, 1e-3, ts))) < 2e-3
    _close(an.radiance_aniso(to, tn, ts), jan.radiance_aniso(jo, jn, js), tol, "radiance")
    x = torch.tensor([0.1, 0.2, 1.0])
    _close(ts.pdf(x), js.pdf(jnp.asarray(x.numpy())), 1e-6, "pdf")


def test_isotropic_embedding_matches_isotropic_renderer():
    """scale = (sigma, sigma, sigma) reproduces the port's isotropic plain
    renderer (tests/test_aniso.py's tolerance)."""
    iso = grid_scene(3, device="cpu")
    _, cam = _cams()
    o, dirs = cam.rays()
    a = render_rays_impl(o, dirs, iso, q_block=16, ray_block=64)
    b = an.render_rays_aniso_impl(o, dirs, an.from_isotropic(iso), q_block=16, ray_block=64)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-6)
    proxy = an.iso_proxy(an.from_isotropic(iso))
    assert torch.equal(proxy.sigma, iso.sigma)


def test_plain_render_and_oracle_match_jax():
    """render_rays_aniso_impl against the JAX package's, and against the
    port's own literal oracle ray by ray."""
    fields = _scene_np()
    js, ts = _both(fields)
    jc, tc = _cams()
    jo, jd = jc.rays()
    o, dirs = tc.rays()
    tol = _tol(fields, o.numpy())
    got = an.render_rays_aniso_impl(o, dirs, ts, q_block=8, ray_block=64)
    _close(got, jan.render_rays_aniso_impl(jo, jd, js, q_block=8, ray_block=64), tol)
    oracle = torch.stack([an.radiance_aniso(o, n, ts) for n in dirs[::17]])
    _close(got[::17], oracle, 1e-4, "oracle")


@pytest.mark.parametrize("backend,jbackend,bucketed", [
    ("torch", "xla", False), ("kernel", "pallas", False), ("kernel", "pallas", True),
])
def test_render_tiled_aniso_matches_jax(backend, jbackend, bucketed):
    """render_tiled_aniso on the port's torch and kernel (plain) backends
    against the JAX package's xla and pallas backends, single-capacity and
    bucketed, on the stretched grid at 32^2 in 4x4 tiles (30 degrees)."""
    fields = _grid_np()
    js, ts = _both(fields)
    jcam = j_orbit(30.0, -4.0, 1.0, 32, 32)
    tcam = orbit_camera(30.0, -4.0, 1.0, 32, 32, device="cpu")
    kw = dict(tiles=4, capacity=16)
    want, jo = jan.render_tiled_aniso(js, jcam, backend=jbackend,
                                      bucket_cfg=JBucket(4, 16, 8) if bucketed else None, **kw)
    got, to = an.render_tiled_aniso(ts, tcam, backend=backend,
                                    bucket_cfg=BucketConfig(4, 16, 8) if bucketed else None, **kw)
    assert int(to) == int(jo) == 0
    _close(got, want, _tol(fields, tcam.position.numpy()))
    assert float(got.max()) > 0.05


def test_gather_tiles_aniso_dummy_and_rows():
    fields = _grid_np()
    ts = an.aniso_scene_from_numpy(*fields, device="cpu")
    idx = torch.tensor([[3, 16, 0], [16, 16, 15]], dtype=torch.int32)
    tiled = an.gather_tiles_aniso(ts, idx)
    assert tiled.mu.shape == (2, 3, 3) and tiled.magnitude.shape == (2, 3)
    assert torch.equal(tiled.scale[0, 0], ts.scale[3]) and torch.equal(tiled.albedo[1, 2],
                                                                      ts.albedo[15])
    assert (tiled.scale[0, 1] == 1).all() and tiled.magnitude[1, 0] == 0
    padded = an.pad_scene_aniso(ts, 24)
    assert padded.n == 24 and (padded.scale[16:] == 1).all() and (padded.magnitude[16:] == 0).all()


@pytest.fixture(scope="module")
def step_setup():
    """The stretched grid's target at 20 degrees, the start scene with its
    scales x1.1, as numpy for both packages."""
    truth = _grid_np()
    jcam = j_orbit(20.0, -4.0, 1.0, 32, 32)
    o, dirs = jcam.rays()
    target, _ = jan.render_tiled_aniso(_both(truth)[0], jcam, tiles=4, capacity=16,
                                       backend="pallas")
    start = (truth[0], truth[1] * np.float32(1.1), truth[2], truth[3])
    j_in = (jcam.view_matrix, o, dirs, target)
    return start, j_in, tuple(torch.from_numpy(np.array(x)) for x in j_in)


@pytest.mark.parametrize("bucketed", [False, True])
def test_aniso_train_step_matches_jax(step_setup, bucketed):
    """One SGD step of make_aniso_frame_train_step, single-capacity and
    bucketed, against the JAX package's step from the same scene: the
    loss and the updated scene (the gradients times the step)."""
    import functools

    start, j_in, t_in = step_setup
    js, ts = _both(start)
    kw = dict(width=32, height=32, tiles=4, capacity=16)
    jb, tb = (JBucket(4, 16, 8), BucketConfig(4, 16, 8)) if bucketed else (None, None)
    jstep = jfit.make_aniso_frame_train_step(optax.sgd(1e-2), bucket_cfg=jb, **kw)
    jst, jl, jo = jstep(jfit.init_state(js, optax.sgd(1e-2)), *j_in)
    tstep = tfit.make_aniso_frame_train_step(bucket_cfg=tb, **kw)
    tst, tl, to = tstep(tfit.init_state(ts, functools.partial(torch.optim.SGD, lr=1e-2)), *t_in)
    assert int(to) == int(jo) == 0 and tst.step == 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tst.scene, f).numpy(),
                                   np.asarray(getattr(jst.scene, f)), atol=1e-6, err_msg=f)
        assert not torch.equal(getattr(tst.scene, f), getattr(ts, f)), f


def test_aniso_step_masks_and_refuses():
    """Frozen fields stay bit-identical; a mesh of one rank without a group
    gives the scene and loss of mesh=None; a mesh size that does not divide
    the tile count or the bucket sizes and capacities above
    MAX_CHUNKED_CAPACITY raise when the step is built, and a capacity above
    MAX_BWD_CAPACITY_ANISO builds (the chunked anisotropic route)."""
    from sgrt_tpu_torch.parallel.mesh import make_mesh

    start = _grid_np()
    ts = an.aniso_scene_from_numpy(*start, device="cpu")
    cam = orbit_camera(20.0, -4.0, 1.0, 32, 32, device="cpu")
    o, dirs = cam.rays()
    one = make_mesh(device="cpu")
    runs = []
    for mesh in (None, one):
        step = tfit.make_aniso_frame_train_step(width=32, height=32, tiles=4, capacity=16,
                                                trainable=("scale",), mesh=mesh)
        state = tfit.init_state(ts, tfit.adam(3e-3), mesh=mesh)
        runs.append(step(state, cam.view_matrix, o, dirs, torch.zeros(32, 32, 3)))
    state = runs[0][0]
    assert torch.equal(state.scene.mu, ts.mu) and not torch.equal(state.scene.scale, ts.scale)
    assert float(runs[1][1]) == float(runs[0][1])
    assert torch.equal(runs[1][0].scene.scale, state.scene.scale)
    with pytest.raises(ValueError, match="divisible by the mesh"):
        tfit.make_aniso_frame_train_step(mesh=dataclasses.replace(one, size=3))
    with pytest.raises(ValueError, match="bucket sizes"):
        tfit.make_aniso_frame_train_step(capacity=64, bucket_cfg=BucketConfig(3, 128, 64),
                                         mesh=dataclasses.replace(one, size=2))
    tfit.make_aniso_frame_train_step(capacity=6145)
    with pytest.raises(ValueError, match="chunked"):
        tfit.make_aniso_frame_train_step(capacity=65537)
    with pytest.raises(ValueError, match="chunked"):
        tfit.make_aniso_frame_train_step(capacity=64, bucket_cfg=BucketConfig(4, 65537, 64))


def test_checkpoint_roundtrip_aniso(tmp_path):
    """An AnisoScene fit state saves and restores exactly, and the resumed
    step equals an uninterrupted run's."""
    ts = an.aniso_scene_from_numpy(*_grid_np(), device="cpu")
    cam = orbit_camera(20.0, -4.0, 1.0, 16, 16, device="cpu")
    o, dirs = cam.rays()
    target = an.render_tiled_aniso(ts.replace(scale=ts.scale * 0.9), cam, tiles=2,
                                   capacity=16, backend="kernel")[0]
    step = tfit.make_aniso_frame_train_step(width=16, height=16, tiles=2, capacity=16)
    inputs = (cam.view_matrix, o, dirs, target)
    st = tfit.init_state(ts, tfit.adam(3e-3))
    st, _, _ = step(st, *inputs)
    mgr = make_manager(str(tmp_path / "ck"))
    save_fit(mgr, 1, st)
    restored = restore_fit(str(tmp_path / "ck"), tfit.init_state(ts, tfit.adam(3e-3)))
    assert isinstance(restored.scene, an.AnisoScene) and restored.step == 1
    for f in FIELDS:
        assert torch.equal(getattr(restored.scene, f), getattr(st.scene, f))
    st, want, _ = step(st, *inputs)
    restored, got, _ = step(restored, *inputs)
    assert float(got) == float(want)
    for f in FIELDS:
        assert torch.equal(getattr(restored.scene, f), getattr(st.scene, f))


def test_torch_backend_gradients_match_jax_xla():
    """Autograd of the port's plain tiled render against jax.grad of the
    JAX package's xla route: the per-axis scale gradients included."""
    fields = _grid_np()
    js, ts = _both(fields)
    jcam = j_orbit(30.0, -4.0, 1.0, 16, 16)
    tcam = orbit_camera(30.0, -4.0, 1.0, 16, 16, device="cpu")

    def jloss(s):
        img, _ = jan.render_tiled_aniso(s, jcam, tiles=2, capacity=16)
        return jnp.sum(img ** 2)

    jg = jax.grad(jloss)(js)
    leaves = {f: getattr(ts, f).clone().requires_grad_(True) for f in FIELDS}
    img, _ = an.render_tiled_aniso(an.AnisoScene(**leaves), tcam, tiles=2, capacity=16)
    torch.sum(img ** 2).backward()
    tol = _tol(fields, tcam.position.numpy())
    for f in FIELDS:
        _close(leaves[f].grad, getattr(jg, f), 4 * tol, f)
