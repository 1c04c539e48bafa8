"""Port parity: distribution (sgrt_tpu_torch.parallel.mesh, .render and the
mesh branches of .fit) in two gloo processes on the CPU, against the JAX
package's mesh counterparts on a 2-device sub-mesh of conftest's 8 CPU
devices, Pallas in interpret mode.

The cases are __graft_entry__.dryrun_multichip's seven sharded variants at
its shapes (pad_scene(grid_scene(2), 8); 8x16 rays; a 32x32 frame in 4x4
tiles at capacity 8; the slab step isotropic and anisotropic), the sharded
forward of tests/test_parallel.py (grid_scene(3) at 30 degrees,
single-capacity and bucketed), render_sharded and fit(mesh=...). The
targets are the scene seen from another orbit angle, or a perturbed
scene's render, so losses and gradients are not zero. The port's ranks
run in tests/torch_parallel_worker.py (torch and sgrt_tpu_torch only),
started once for the module.

Gradients are read through SGD at lr 1 (old - new) on both sides.
Tolerances: losses rtol 1e-4 (tests/test_parallel.py:53; fit's Adam
losses 1e-3 as tests/test_torch_fit.py); images rtol 1e-4, atol 5e-5
(tests/test_parallel.py:102, :127); gradients FRAME_GRAD_REL = 2e-3 of each
field's max |value|, tests/test_torch_fit.py's JAX-vs-port frame tolerance,
derived there from the float32 rounding of the Gaussian exponent. The two
ranks are equal bit for bit; the sharded forwards equal the port's
one-device frames bit for bit.
"""

import importlib
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.camera import Camera as JCamera
from sgrt_tpu.models.gaussians import grid_scene as j_grid, pad_scene as j_pad
from sgrt_tpu.ops.anisotropic import from_isotropic as j_from_isotropic
from sgrt_tpu.ops.frame import orbit_camera as j_orbit, render_orbit_frame as j_render
from sgrt_tpu.ops.pallas_kernel import MAX_BWD_CAPACITY
from sgrt_tpu.ops.render import render_rays_impl as j_render_rays
from sgrt_tpu.ops.scheduler import BucketConfig as JBucket
from sgrt_tpu.parallel.mesh import make_mesh as j_make_mesh, shard_rays as j_shard
from sgrt_tpu.parallel.render import make_sharded_frame_renderer, render_sharded

jfit = importlib.import_module("sgrt_tpu.parallel.fit")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
FIELDS = ("mu", "sigma", "magnitude", "albedo")
ANISO_FIELDS = ("mu", "scale", "magnitude", "albedo")
FRAME = dict(width=32, height=32, tiles=4)
FRAME_GRAD_REL = 2e-3
STEPS = ("ray", "frame", "bucketed", "chunked", "aniso", "slab", "slab_aniso")
FORWARDS = ("forward", "fwd_single", "fwd_bucketed", "render_sharded")


def _inputs():
    """The cases' numpy inputs, made with the JAX package."""
    s = j_pad(j_grid(2), 8)
    cam = JCamera.create(position=(0.0, 0.0, -4.0), width=8, height=16)
    o, dirs = cam.rays()
    # a perturbed scene's render: residuals ~10x the renderers' float32
    # difference on these rays (2.2e-6 of colors up to 0.075)
    moved = s.replace(mu=s.mu + 0.25, magnitude=s.magnitude * 0.5)
    fcam = j_orbit(0.0, -4.0, 1.0, 32, 32)
    fo, fdirs = fcam.rays()
    # the target: the scene from 20 degrees further round the orbit
    ftarget, _ = j_render(s, 20.0, capacity=8, **FRAME)
    g3 = j_grid(3)
    gcam = j_orbit(30.0, -4.0, 1.0, 32, 32)
    go, gdirs = gcam.rays()
    x = {"ray_o": o, "ray_dirs": dirs,
         "ray_target": j_render_rays(o, dirs, moved, q_block=8, ray_block=16),
         "frame_view": fcam.view_matrix, "frame_o": fo, "frame_dirs": fdirs,
         "frame_target": ftarget, "fwd_view": gcam.view_matrix, "fwd_o": go,
         "fwd_dirs": gdirs}
    x.update({f"scene_{f}": getattr(s, f) for f in FIELDS})
    x.update({f"fwd_scene_{f}": getattr(g3, f) for f in FIELDS})
    return s, g3, {k: np.asarray(v) for k, v in x.items()}


def _jax_runs(s, g3, x):
    """The JAX package's mesh counterparts of every case on 2 devices."""
    mesh = j_make_mesh(jax.devices()[:2])
    sgd = optax.sgd(1.0)
    out = {}

    def put(case, **vals):
        for k, v in vals.items():
            if hasattr(v, "mu"):         # a scene: its four fields
                out.update({f"{case}__{f}": np.asarray(getattr(v, f)) for f in
                            (ANISO_FIELDS if hasattr(v, "scale") else FIELDS)})
            else:
                out[f"{case}__{k}"] = np.asarray(v)

    step = jfit.make_train_step(sgd, mesh=mesh, q_block=8, ray_block=8)
    st, loss = step(jfit.init_state(s, sgd, mesh), x["ray_o"],
                    *j_shard(mesh, x["ray_dirs"], x["ray_target"]))
    put("ray_mesh", loss=loss, scene=st.scene)
    # the reference of the port's ray-sharded step: the one-device step (the
    # mesh step's gradients are D times too large, test_jax_ray_mesh_defect)
    step = jfit.make_train_step(sgd, q_block=8, ray_block=8)
    st, loss = step(jfit.init_state(s, sgd), x["ray_o"], x["ray_dirs"], x["ray_target"])
    put("ray", loss=loss, scene=st.scene)
    frame_in = (x["frame_view"], x["frame_o"], x["frame_dirs"], x["frame_target"])
    aniso = j_from_isotropic(s)
    steps = {
        "frame": (s, jfit.make_frame_train_step(sgd, capacity=8, mesh=mesh, **FRAME)),
        "bucketed": (s, jfit.make_frame_train_step(sgd, capacity=8, mesh=mesh,
                                                   bucket_cfg=JBucket(2, 16, 8), **FRAME)),
        "chunked": (s, jfit.make_frame_train_step(sgd, capacity=MAX_BWD_CAPACITY + 1,
                                                  mesh=mesh, **FRAME)),
        "aniso": (aniso, jfit.make_aniso_frame_train_step(sgd, capacity=8, mesh=mesh,
                                                          **FRAME)),
        "slab": (s, jfit.make_slab_frame_train_step(sgd, capacity=8, slab_tiles=2, mesh=mesh,
                                                    **FRAME)),
        "slab_aniso": (aniso, jfit.make_slab_frame_train_step(
            sgd, capacity=8, slab_tiles=2, mesh=mesh, aniso=True, **FRAME)),
    }
    for case, (sc, fn) in steps.items():
        st, loss, overflow = fn(jfit.init_state(sc, sgd, mesh), *frame_in)
        put(case, loss=loss, overflow=overflow, scene=st.scene)
    fwd_in = (x["fwd_view"], x["fwd_o"], x["fwd_dirs"])
    forwards = {"forward": (s, frame_in[:3], dict(capacity=8)),
                "fwd_single": (g3, fwd_in, dict(capacity=32)),
                "fwd_bucketed": (g3, fwd_in, dict(bucket_cfg=JBucket(8, 32, 16)))}
    for case, (sc, inp, kw) in forwards.items():
        img, overflow = make_sharded_frame_renderer(mesh, **FRAME, **kw)(sc, *inp)
        put(case, image=img, overflow=overflow)
    cam = JCamera.create(position=(0.0, 0.0, -4.0), width=8, height=16)
    put("render_sharded", image=render_sharded(s, cam, mesh, q_block=8, ray_block=16))
    fitted, losses = jfit.fit(s, x["ray_o"], x["ray_dirs"], x["ray_target"], steps=3,
                              learning_rate=1e-2, q_block=8, ray_block=8)
    put("fit", loss=np.array(losses), scene=fitted)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX results, [rank 0's, rank 1's results]): the two port
    ranks run while the JAX side does."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    s, g3, x = _inputs()
    np.savez(tmp / "inputs.npz", **x)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", coord,
                               str(tmp / "inputs.npz"), str(tmp)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        want = _jax_runs(s, g3, x)
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return x, want, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _start(x, case):
    """The scene's fields before the step (aniso: from_isotropic's)."""
    start = {f: x[f"scene_{f}"] for f in FIELDS}
    if "aniso" in case:
        start["scale"] = np.repeat(start.pop("sigma")[:, None], 3, axis=1)
    return start


@pytest.mark.parametrize("case", STEPS)
def test_sharded_step_matches_jax(runs, case):
    """One SGD(1) step of each sharded variant: the loss and the gradients
    against the JAX mesh step's (ray: the one-device step's), ranks equal
    bit for bit, overflow 0."""
    x, want, (r0, r1) = runs
    assert float(r0[f"{case}__loss"]) > 0
    np.testing.assert_allclose(r0[f"{case}__loss"], want[f"{case}__loss"], rtol=1e-4)
    assert np.array_equal(r0[f"{case}__loss"], r1[f"{case}__loss"])
    if case != "ray":
        assert int(r0[f"{case}__overflow"]) == int(want[f"{case}__overflow"]) == 0
    for f, old in _start(x, case).items():
        assert np.array_equal(r0[f"{case}__{f}"], r1[f"{case}__{f}"]), f
        g_jax = old - want[f"{case}__{f}"]
        assert np.abs(g_jax).max() > 0, f
        np.testing.assert_allclose(old - r0[f"{case}__{f}"], g_jax,
                                   atol=FRAME_GRAD_REL * np.abs(g_jax).max(), err_msg=f)


@pytest.mark.parametrize("case", FORWARDS)
def test_sharded_forward_matches_jax(runs, case):
    """The sharded frames against the JAX mesh renders, the same frame on
    both ranks, and (the tiled ones) the port's one-device frame bit for
    bit, overflow 0."""
    _, want, (r0, r1) = runs
    img = r0[f"{case}__image"]
    assert img.max() > 0
    np.testing.assert_allclose(img, want[f"{case}__image"], rtol=1e-4, atol=5e-5)
    assert np.array_equal(img, r1[f"{case}__image"])
    if case != "render_sharded":
        assert np.array_equal(img, r0[f"{case}__single"])
        assert int(r0[f"{case}__overflow"]) == int(want[f"{case}__overflow"]) == 0


def test_jax_ray_mesh_defect(runs):
    """A defect of the reference that the port does not copy: the JAX
    package's ray-sharded make_train_step (shard_map with its default
    check_vma) differentiates the replicated scene, whose gradient is
    already summed over the mesh, and then takes pmean: its gradients are
    D times the one-device step's (here 2), its loss the same. The port's
    equal the one-device step's (test_sharded_step_matches_jax[ray])."""
    x, want, _ = runs
    np.testing.assert_allclose(want["ray_mesh__loss"], want["ray__loss"], rtol=1e-6)
    for f, old in _start(x, "ray").items():
        g1, g2 = old - want[f"ray__{f}"], old - want[f"ray_mesh__{f}"]
        # 1% of scale: above SGD's read-out rounding (ulp(|old|) ~ 1.2e-7),
        # far below the factor 2
        np.testing.assert_allclose(g2, 2 * g1, atol=1e-2 * np.abs(g1).max(), err_msg=f)


def test_fit_over_mesh_matches_jax_and_restores(runs):
    """fit(mesh=...) (3 Adam steps, ray-sharded) against the JAX fit on one
    device (its mesh fit takes the defective step of test_jax_ray_mesh_defect);
    rank 0 wrote the checkpoints, and restore_fit gives both ranks the
    fitted scene and its step."""
    _, want, (r0, r1) = runs
    np.testing.assert_allclose(r0["fit__loss"], want["fit__loss"], rtol=1e-3)
    assert np.array_equal(r0["fit__loss"], r1["fit__loss"])
    assert int(r0["fit__restored_step"]) == int(r1["fit__restored_step"]) == 3
    for f in FIELDS:
        for r in (r0, r1):
            assert np.array_equal(r[f"fit_restored__{f}"], r0[f"fit__{f}"]), f
        np.testing.assert_allclose(r0[f"fit__{f}"], want[f"fit__{f}"], atol=1e-4, err_msg=f)


def test_one_rank_mesh_and_shard_rays():
    """Without a process group make_mesh is one rank whose collectives are
    the identity; shard_rays and Mesh.shard refuse an axis the mesh size
    does not divide."""
    import dataclasses

    import torch

    from sgrt_tpu_torch.parallel.mesh import make_mesh, replicate, shard_rays

    mesh = make_mesh(device="cpu")
    t = torch.arange(6.0)
    assert shard_rays(mesh, t) is not None and torch.equal(shard_rays(mesh, t), t)
    assert replicate(mesh, t) is t and mesh.all_reduce([t], mean=True)[0] is t
    two = dataclasses.replace(mesh, rank=1, size=2)
    a, b = shard_rays(two, t, t[:, None])
    assert torch.equal(a, t[3:]) and b.shape == (3, 1)
    with pytest.raises(ValueError, match="divisible by the mesh"):
        shard_rays(dataclasses.replace(mesh, size=4), t)
