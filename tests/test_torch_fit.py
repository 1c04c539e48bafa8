"""Port parity: training (sgrt_tpu_torch.parallel.fit, .fit_cli and
.utils.checkpoint, device="cpu") against the JAX package's training path,
Pallas in interpret mode, on tests/test_frame_fit.py's setup: grid_scene(4)
with its means moved by 0.03, a 32^2 frame at orbit angle 0, 4x4 tiles,
capacity 32, Adam 3e-3.

Both sides get the same numpy inputs (view matrix, rays, target image).
Tolerances: losses rtol 1e-3 over Adam steps (test_frame_fit.py's own
cross-backend tolerance: Adam divides by sqrt(v), so float32 differences
in tiny gradients grow over steps). Frame gradients: 2e-3 of each field's
max |value|, derived. The Gaussian exponent cancels |oc|^2 (up to 25)
against mb^2, so one rounding step of mb (Pallas takes it from a dot, the
port from ordered products) moves a color by up to 2 ulp(25) / (2 sigma^2)
= 1.2e-4 relative at sigma = 1/8. The loss's residual c - t is only ~2e-3
rms here (loss 4e-6), so those color differences reach a few percent of
the residual at single pixels and ~7e-4 of the gradients' scale overall
(measured); the JAX package's Pallas and XLA routes share XLA's rounding
and agree to 3e-6. The fused op's own gradients are held at 5e-5 of scale
in tests/test_torch_backward.py.
"""

import dataclasses
import importlib
import re

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.fit_cli import main as jax_fit_main
from sgrt_tpu.models.gaussians import GaussianScene as JScene, grid_scene as j_grid
from sgrt_tpu.ops.frame import orbit_camera as j_orbit, render_orbit_frame as j_render
from sgrt_tpu.ops.scheduler import BucketConfig as JBucket
from sgrt_tpu_torch.fit_cli import main as torch_fit_main
from sgrt_tpu_torch.models.gaussians import scene_from_numpy
from sgrt_tpu_torch.ops.scheduler import BucketConfig
from sgrt_tpu_torch.utils.checkpoint import make_manager, restore_fit, save_fit

# the packages' parallel/__init__ re-export the function fit over the module
jfit = importlib.import_module("sgrt_tpu.parallel.fit")
tfit = importlib.import_module("sgrt_tpu_torch.parallel.fit")

FIELDS = ("mu", "sigma", "magnitude", "albedo")
KW = dict(width=32, height=32, tiles=4, capacity=32)
BUCKETS = (4, 16, 8)
FRAME_GRAD_REL = 2e-3


def _port_scene(js):
    return scene_from_numpy(*(np.asarray(getattr(js, f)) for f in FIELDS), device="cpu")


@pytest.fixture(scope="module")
def setup():
    """(JAX scene, port scene, JAX inputs, port inputs); inputs are (view,
    o, dirs, target)."""
    cam = j_orbit(0.0, -4.0, 1.0, 32, 32)
    o, dirs = cam.rays()
    target, _ = j_render(j_grid(4), 0.0, width=32, height=32, tiles=4, capacity=32)
    g = j_grid(4)
    js = g.replace(mu=g.mu + 0.03)
    j_in = (cam.view_matrix, o, dirs, target)
    t_in = tuple(torch.from_numpy(np.array(x)) for x in j_in)
    return js, _port_scene(js), j_in, t_in


def _losses(step, state, inputs, n):
    out = []
    for _ in range(n):
        state, loss, overflow = step(state, *inputs)
        assert int(overflow) == 0
        out.append(float(loss))
    return out, state


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Four Adam steps of the JAX package's frame step, plain and bucketed."""
    js, _, j_in, _ = setup
    runs = {}
    for name, cfg in (("plain", None), ("bucketed", JBucket(*BUCKETS))):
        step = jfit.make_frame_train_step(optax.adam(3e-3), bucket_cfg=cfg, **KW)
        runs[name] = _losses(step, jfit.init_state(js, optax.adam(3e-3)), j_in, 4)[0]
    return runs


@pytest.mark.parametrize("bucketed", [False, True])
def test_frame_value_and_grad_matches_jax(setup, bucketed):
    js, ts, j_in, t_in = setup
    jvg = jfit.make_frame_value_and_grad(
        bucket_cfg=JBucket(*BUCKETS) if bucketed else None, **KW)
    tvg = tfit.make_frame_value_and_grad(
        bucket_cfg=BucketConfig(*BUCKETS) if bucketed else None, **KW)
    (jl, jo), jg = jvg(js, *j_in)
    (tl, to), tg = tvg(ts, *t_in)
    assert int(jo) == int(to) == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for f in FIELDS:
        want = np.asarray(getattr(jg, f))
        np.testing.assert_allclose(getattr(tg, f).numpy(), want,
                                   atol=FRAME_GRAD_REL * np.abs(want).max(), err_msg=f)


@pytest.mark.parametrize("bucketed", [False, True])
def test_frame_train_step_losses_match_jax(setup, jax_runs, bucketed):
    _, ts, _, t_in = setup
    step = tfit.make_frame_train_step(
        bucket_cfg=BucketConfig(*BUCKETS) if bucketed else None, **KW)
    state = tfit.init_state(ts, tfit.adam(3e-3))
    losses, state = _losses(step, state, t_in, 4)
    np.testing.assert_allclose(losses, jax_runs["bucketed" if bucketed else "plain"],
                               rtol=1e-3)
    assert losses[-1] < losses[0] and state.step == 4
    # the caller's scene is never updated
    np.testing.assert_array_equal(ts.mu.numpy(), np.asarray(setup[0].mu))


def test_torch_backend_matches_kernel(setup):
    _, ts, _, t_in = setup
    runs = []
    for backend in ("kernel", "torch"):
        step = tfit.make_frame_train_step(backend=backend, **KW)
        runs.append(_losses(step, tfit.init_state(ts, tfit.adam(3e-3)), t_in, 3)[0])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-3)


def test_trainable_mask_leaves_frozen_fields_bit_identical(setup):
    _, ts, _, t_in = setup
    step = tfit.make_frame_train_step(trainable=("mu",), **KW)
    state = tfit.init_state(ts, tfit.adam(3e-3))
    mu0, sig0, alb0 = (state.scene.mu.clone(), state.scene.sigma.clone(),
                       state.scene.albedo.clone())
    state, _, _ = step(state, *t_in)
    assert not torch.allclose(state.scene.mu, mu0)
    assert torch.equal(state.scene.sigma, sig0) and torch.equal(state.scene.albedo, alb0)
    # the frozen fields' gradients are zeros, as the JAX package's mask gives
    vg = tfit.make_frame_value_and_grad(trainable=("mu",), **KW)
    _, grads = vg(ts, *t_in)
    assert torch.count_nonzero(grads.sigma) == 0 and torch.count_nonzero(grads.mu) > 0


def test_frame_step_flags_capacity_overflow():
    """64 co-located Gaussians against capacity 8 (padded to 32): overflow
    is reported, as tests/test_frame_fit.py:96-118 requires of the JAX
    package, with the same tile count."""
    rng = np.random.default_rng(0)
    n = 64
    fields = (rng.normal(0, 0.05, (n, 3)).astype(np.float32), np.full(n, 0.1, np.float32),
              np.ones(n, np.float32), np.full((n, 3), 0.5, np.float32))
    cam = j_orbit(0.0, -4.0, 1.0, 32, 32)
    o, dirs = cam.rays()
    inputs = (cam.view_matrix, o, dirs, jnp.zeros((32, 32, 3), jnp.float32))
    kw = dict(KW, capacity=8)
    jstep = jfit.make_frame_train_step(optax.adam(3e-3), **kw)
    _, _, jo = jstep(jfit.init_state(JScene(*map(jnp.asarray, fields)), optax.adam(3e-3)),
                     *inputs)
    tstep = tfit.make_frame_train_step(**kw)
    state = tfit.init_state(scene_from_numpy(*fields, device="cpu"), tfit.adam(3e-3))
    _, _, to = tstep(state, *(torch.from_numpy(np.array(x)) for x in inputs))
    assert int(to) == int(jo) > 0


@pytest.mark.parametrize("backend,jbackend", [("kernel", "pallas"), ("torch", "xla")])
def test_untiled_train_step_matches_jax(backend, jbackend):
    from sgrt_tpu.models.camera import Camera as JCamera
    from sgrt_tpu.ops.render import render_rays_impl

    cam = JCamera.create(position=(0.0, 0.0, -4.0), width=16, height=16)
    o, dirs = cam.rays()
    target = render_rays_impl(o, dirs, j_grid(4), q_block=16, ray_block=256)
    g = j_grid(4)
    js = g.replace(mu=g.mu + 0.04)
    jstep = jfit.make_train_step(optax.adam(3e-3), q_block=16, ray_block=256,
                                 backend=jbackend)
    tstep = tfit.make_train_step(q_block=16, ray_block=256,
                                 backend=backend)
    jst, tst = jfit.init_state(js, optax.adam(3e-3)), tfit.init_state(_port_scene(js),
                                                                      tfit.adam(3e-3))
    t_in = [torch.from_numpy(np.array(x)) for x in (o, dirs, target)]
    jl, tl = [], []
    for _ in range(3):
        jst, loss = jstep(jst, o, dirs, target)
        jl.append(float(loss))
        tst, loss = tstep(tst, *t_in)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_fit_matches_jax():
    from sgrt_tpu.models.camera import Camera as JCamera
    from sgrt_tpu.ops.render import render_rays_impl

    cam = JCamera.create(position=(0.0, 0.0, -4.0), width=8, height=8)
    o, dirs = cam.rays()
    target = render_rays_impl(o, dirs, j_grid(2), q_block=8, ray_block=64)
    g = j_grid(2)
    js = g.replace(mu=g.mu + 0.05)
    _, jl = jfit.fit(js, o, dirs, target, steps=3, learning_rate=1e-2, q_block=8,
                     ray_block=64)
    seen = []
    fitted, tl = tfit.fit(_port_scene(js), *(torch.from_numpy(np.array(x))
                                             for x in (o, dirs, target)),
                          steps=3, learning_rate=1e-2, q_block=8, ray_block=64,
                          callback=lambda i, loss: seen.append(i))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert seen == [0, 1, 2] and fitted.mu.shape == (4, 3)


def test_mesh_is_not_ported(setup):
    """(The name is historical: the mesh is ported, and this asserts how it
    behaves.) A mesh of one rank without a process group (make_mesh when no group
    runs) gives init_state and the frame step, single-capacity and
    bucketed, the same scene and loss as mesh=None; a mesh size that does
    not divide the tile count or the bucket sizes raises when the step is
    built. Two ranks run in tests/test_torch_parallel.py."""
    from sgrt_tpu_torch.parallel.mesh import make_mesh

    _, ts, _, t_in = setup
    one = make_mesh(device="cpu")
    assert (one.group, one.rank, one.size) == (None, 0, 1)
    assert torch.equal(tfit.init_state(ts, _sgd(1e-2), mesh=one).scene.mu, ts.mu)
    for cfg in (None, BucketConfig(*BUCKETS)):
        runs = [_losses(tfit.make_frame_train_step(mesh=m, bucket_cfg=cfg, **KW),
                        tfit.init_state(ts, _sgd(1e-2), mesh=m), t_in, 1)
                for m in (None, one)]
        # the bucketed mesh step sums each bucket apart, as the JAX mesh step
        np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(runs[1][1].scene, f).numpy(),
                                       getattr(runs[0][1].scene, f).numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=f)
    with pytest.raises(ValueError, match="divisible by the mesh"):
        tfit.make_frame_train_step(mesh=dataclasses.replace(one, size=3), **KW)
    with pytest.raises(ValueError, match="bucket sizes"):
        tfit.make_frame_train_step(mesh=dataclasses.replace(one, size=2),
                                   bucket_cfg=BucketConfig(3, 16, 8), **KW)
    with pytest.raises(ValueError, match="backend"):
        tfit.make_frame_value_and_grad(backend="pallas", **KW)


def test_checkpoint_roundtrip_resumes_exactly(setup, tmp_path):
    """Save mid-fit, restore into a fresh state, and the resumed losses
    equal an uninterrupted run's (tests/test_checkpoint.py's check)."""
    _, ts, _, t_in = setup
    step = tfit.make_frame_train_step(**KW)
    full, _ = _losses(step, tfit.init_state(ts, tfit.adam(3e-3)), t_in, 6)
    _, st = _losses(step, tfit.init_state(ts, tfit.adam(3e-3)), t_in, 3)
    mgr = make_manager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (1, 2, 3):
        save_fit(mgr, s, st)
    assert mgr.all_steps() == [2, 3]
    template = tfit.init_state(ts, tfit.adam(3e-3))
    restored = restore_fit(str(tmp_path / "ckpt"), template)
    assert restored.step == 3
    assert torch.equal(restored.scene.mu, st.scene.mu)
    resumed, _ = _losses(step, restored, t_in, 3)
    np.testing.assert_allclose(resumed, full[3:], rtol=1e-6)
    assert restore_fit(str(tmp_path / "empty"), template) is None


def _step_lines(text):
    return re.findall(r"^step +(\d+) +view (\d+) +loss ([\d.e+-]+)$", text, re.M)


def test_fit_cli_matches_jax_fit_cli(tmp_path, capsys):
    common = ["-g", "4", "-w", "32", "--height", "32", "--tiles", "4", "--steps", "4",
              "--views", "2"]
    assert jax_fit_main(common) == 0
    jout = capsys.readouterr().out
    png = tmp_path / "fit.png"
    assert torch_fit_main(common + ["--device", "cpu", "--out", str(png),
                                    "--checkpoint-dir", str(tmp_path / "ck"),
                                    "--checkpoint-every", "2"]) == 0
    tout = capsys.readouterr().out
    assert tout.splitlines()[0] == jout.splitlines()[0]    # scene, capacity, buckets
    js, ts = _step_lines(jout), _step_lines(tout)
    assert len(ts) == len(js) == 4
    assert [t[:2] for t in ts] == [j[:2] for j in js]
    np.testing.assert_allclose([float(t[2]) for t in ts], [float(j[2]) for j in js],
                               rtol=1e-3)
    err = re.search(r"max \|mu error\|: ([\d.]+) -> ([\d.]+)", tout)
    assert err and float(err.group(2)) < float(err.group(1))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert make_manager(str(tmp_path / "ck")).all_steps() == [2, 4]


def test_fit_cli_aniso_matches_jax_fit_cli(tmp_path, capsys):
    """fit_cli --aniso: the same probe line, step lines (losses rtol 1e-3)
    and recovery lines as the JAX fit_cli; the means and the per-axis
    scales both move toward the truth."""
    common = ["-g", "4", "-w", "16", "--height", "16", "--tiles", "4", "--steps", "2",
              "--views", "2", "--aniso", "1.6,0.7,1.0"]
    assert jax_fit_main(common) == 0
    jout = capsys.readouterr().out
    png = tmp_path / "fit.png"
    assert torch_fit_main(common + ["--device", "cpu", "--out", str(png)]) == 0
    tout = capsys.readouterr().out
    assert tout.splitlines()[0] == jout.splitlines()[0] and tout.splitlines()[0].endswith(
        "[aniso]")
    js, ts = _step_lines(jout), _step_lines(tout)
    assert len(ts) == len(js) == 2 and [t[:2] for t in ts] == [j[:2] for j in js]
    np.testing.assert_allclose([float(t[2]) for t in ts], [float(j[2]) for j in js],
                               rtol=1e-3)
    for what in ("mu", "scale"):
        pat = rf"max \|{what} error\|: ([\d.]+) -> ([\d.]+)"
        got, want = re.search(pat, tout), re.search(pat, jout)
        assert got and float(got.group(2)) < float(got.group(1))
        np.testing.assert_allclose([float(g) for g in got.groups()],
                                   [float(w) for w in want.groups()], atol=2e-5)
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert torch_fit_main(common + ["--device", "cpu", "--backend", "torch"]) == 2


def _sgd(lr):
    import functools

    return functools.partial(torch.optim.SGD, lr=lr)


@pytest.fixture(scope="module")
def wall_setup():
    """tests/test_chunked.py's setup above the monolithic wall: grid_scene(4,
    sigma 0.3, magnitude 2), a 16^2 frame in 2x2 tiles, a black target."""
    js = j_grid(4, sigma=0.3, magnitude=2.0)
    cam = j_orbit(0.0, -4.0, 1.0, 16, 16)
    o, dirs = cam.rays()
    j_in = (cam.view_matrix, o, dirs, jnp.zeros((16, 16, 3), jnp.float32))
    return js, _port_scene(js), j_in, tuple(torch.from_numpy(np.array(x)) for x in j_in)


def test_train_step_routes_to_chunked_above_wall(wall_setup):
    """make_frame_train_step at capacity MAX_MONOLITHIC_CAPACITY + 1 takes
    the chunked route in both packages: the same losses (rtol 1e-3, Adam)
    and the same updated scene. Adam moves every parameter by about lr a
    step whatever its gradient's size, so 4 steps of 1e-2 agree to 1e-4
    where the float32 gradients agree in sign."""
    from sgrt_tpu_torch.ops.cuda_chunked import MAX_MONOLITHIC_CAPACITY

    js, ts, j_in, t_in = wall_setup
    kw = dict(width=16, height=16, tiles=2, capacity=MAX_MONOLITHIC_CAPACITY + 1)
    jstep = jfit.make_frame_train_step(optax.adam(1e-2), backend="pallas", **kw)
    jl, jst = _losses(jstep, jfit.init_state(js, optax.adam(1e-2)), j_in, 4)
    tl, tst = _losses(tfit.make_frame_train_step(**kw), tfit.init_state(ts, tfit.adam(1e-2)),
                      t_in, 4)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tst.scene, f).numpy(),
                                   np.asarray(getattr(jst.scene, f)), atol=1e-4, err_msg=f)


@pytest.mark.parametrize("capacity,slab_tiles", [(16, 8), (4097, 2)])
def test_slab_step_matches_jax_and_frame_step(capacity, slab_tiles):
    """make_slab_frame_train_step against the JAX package's slab step on one
    device (tests/test_chunked.py's setup, SGD 1e-2) and against the port's
    own frame step, which computes the same function in one launch; at
    capacity 4097 both run the chunked route."""
    js = j_grid(4, sigma=0.3, magnitude=2.0)
    size, tiles = (32, 4) if capacity == 16 else (16, 2)
    cam = j_orbit(0.0, -4.0, 1.0, size, size)
    o, dirs = cam.rays()
    target, _ = j_render(j_grid(4, sigma=0.35), 0.0, -4.0, 1.0, width=size, height=size,
                         tiles=tiles, capacity=16, backend="pallas")
    j_in = (cam.view_matrix, o, dirs, target)
    t_in = tuple(torch.from_numpy(np.array(x)) for x in j_in)
    common = dict(width=size, height=size, tiles=tiles, capacity=capacity)
    jstep = jfit.make_slab_frame_train_step(optax.sgd(1e-2), slab_tiles=slab_tiles, **common)
    jst, jl, jo = jstep(jfit.init_state(js, optax.sgd(1e-2)), *j_in)
    slab = tfit.make_slab_frame_train_step(slab_tiles=slab_tiles, **common)
    sst, sl, so = slab(tfit.init_state(_port_scene(js), _sgd(1e-2)), *t_in)
    frame = tfit.make_frame_train_step(**common)
    fst, fl, fo = frame(tfit.init_state(_port_scene(js), _sgd(1e-2)), *t_in)
    assert int(jo) == int(so) == int(fo) == 0
    np.testing.assert_allclose(float(sl), float(fl), rtol=1e-5)
    np.testing.assert_allclose(float(sl), float(jl), rtol=1e-4)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(sst.scene, f).numpy(), getattr(fst.scene, f).numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
        np.testing.assert_allclose(getattr(sst.scene, f).numpy(),
                                   np.asarray(getattr(jst.scene, f)), rtol=1e-5, atol=1e-6,
                                   err_msg=f)


def test_slab_step_refuses_mesh_and_aniso():
    """(The name is historical: the slab step now takes a mesh and aniso.)
    Over a mesh of one rank without a group the slab step gives the
    scene and loss of mesh=None, and a mesh size that does not divide the
    tile count raises when it is built (two ranks: tests/test_torch_parallel
    .py); its anisotropic variant builds on both routes
    (tests/test_torch_chunked_aniso.py runs it), and like the isotropic one
    refuses a capacity above MAX_CHUNKED_CAPACITY when it is built."""
    from sgrt_tpu_torch.models.gaussians import grid_scene
    from sgrt_tpu_torch.ops.frame import orbit_camera
    from sgrt_tpu_torch.parallel.mesh import make_mesh

    one = make_mesh(device="cpu")
    cam = orbit_camera(10.0, -4.0, 1.0, 16, 16, device="cpu")
    o, dirs = cam.rays()
    scene = grid_scene(2, device="cpu")
    inputs = (cam.view_matrix, o, dirs, torch.full((16, 16, 3), 0.1))
    runs = []
    for mesh in (None, one):
        step = tfit.make_slab_frame_train_step(width=16, height=16, tiles=2, capacity=16,
                                               slab_tiles=2, mesh=mesh)
        runs.append(step(tfit.init_state(scene, _sgd(1e-2), mesh=mesh), *inputs))
    assert float(runs[0][1]) == float(runs[1][1]) and int(runs[1][2]) == 0
    for f in FIELDS:
        assert torch.equal(getattr(runs[0][0].scene, f), getattr(runs[1][0].scene, f)), f
    with pytest.raises(ValueError, match="divisible by the mesh"):
        tfit.make_slab_frame_train_step(mesh=dataclasses.replace(one, size=3))
    for capacity in (16, 6145):
        tfit.make_slab_frame_train_step(aniso=True, capacity=capacity)
    for aniso in (False, True):
        with pytest.raises(ValueError, match="chunked"):
            tfit.make_slab_frame_train_step(aniso=aniso, capacity=65537)
