"""The benchmark's plain reference (benchmark/reference/) against the
program's CPU path at a tiny size. The test imports both; the reference
imports nothing of the program (test_bench_harness.py)."""

import numpy as np
import pytest
import torch
from bench_helpers import ROOT  # noqa: F401  (puts the checkout on the path)

from benchmark import checks, scenes
from benchmark.reference import render
from benchmark.reference.fit import fit_reference
from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops.frame import orbit_camera, render_orbit_frame
from sgrt_tpu_torch.ops.tiling import tile_membership
from sgrt_tpu_torch.parallel.fit import adam, init_state, make_frame_train_step

W = H = 16
TILES = (4, 2)


def _scene(seed, n=120):
    return scenes.make_scene({"kind": "cube_surface", "n": n},
                             scenes.generator(seed, "cpu"), "cpu")


@pytest.mark.parametrize("angle", [0.0, 45.0, 123.4])
def test_camera_and_culling_equal_the_programs_bit_for_bit(angle):
    fields = _scene(1)
    position, view = render.orbit_view(angle, -4.0, 1.0, "cpu")
    cam = orbit_camera(angle, -4.0, 1.0, W, H, device="cpu")
    assert torch.equal(view, cam.view_matrix)
    o, dirs = cam.rays()
    assert torch.equal(position, o)
    assert torch.equal(render.camera_rays(position, view, W, H), dirs)
    member = tile_membership(GaussianScene(*fields), view, TILES, focal_length=1.0)
    assert torch.equal(render.membership(fields[0], fields[1], view, TILES, 1.0), member)


@pytest.mark.parametrize("seed,angle", [(2, 0.0), (3, 200.0)])
def test_pixels_match_the_programs_frame(seed, angle):
    fields = _scene(seed)
    img, ovf = render_orbit_frame(GaussianScene(*fields), angle, -4.0, 1.0, width=W, height=H,
                                  tiles=TILES, capacity=128, backend="kernel")
    assert int(ovf) == 0
    pix = np.arange(W * H)
    ref = render.render_pixels(fields, angle, pix, width=W, height=H, tiles=TILES,
                               offset=-4.0, focal=1.0)
    assert float(ref.abs().max()) > 0.05
    # float32 program (its A&S erf) against the float64 reference: the
    # exponent of cbar cancels |oc|^2 ~ 16 against mu_bar^2 at 1/(2 sigma^2)
    assert checks.pixel_gap(img.reshape(-1, 3), ref) < 2e-3
    ctl = render.render_pixels(fields, angle, pix, width=W, height=H, tiles=TILES,
                               offset=-4.0, focal=1.0, dtype=torch.float32, tf32=True)
    assert checks.pixel_gap(ctl, ref) > 10 * checks.pixel_gap(img.reshape(-1, 3), ref)


def test_fit_follows_the_programs_steps():
    truth, start = scenes.fit_inputs({"kind": "cube_surface", "n": 150}, 0.02, 7, "cpu")
    angles = [0.0, 90.0, 180.0, 270.0]
    cap = 128
    step = make_frame_train_step(width=W, height=H, tiles=TILES, capacity=cap)
    targets = [render_orbit_frame(GaussianScene(*truth), a, -4.0, 1.0, width=W, height=H,
                                  tiles=TILES, capacity=cap, backend="kernel")[0]
               for a in angles]
    state = init_state(GaussianScene(*start), adam(2e-3))
    losses = []
    for i in range(3):
        cam = orbit_camera(angles[i], -4.0, 1.0, W, H, device="cpu")
        o, d = cam.rays()
        state, loss, _ = step(state, cam.view_matrix, o, d, targets[i])
        losses.append(float(loss))
        if i == 0:
            opt = state.opt_state
            grad1 = {f: opt.state[q]["exp_avg"] / 0.1
                     for f, q in zip(("mu", "sigma", "magnitude", "albedo"),
                                     opt.param_groups[0]["params"])}
    change = {f: getattr(state.scene, f) - s
              for f, s in zip(("mu", "sigma", "magnitude", "albedo"), start)}
    kw = dict(steps=3, width=W, height=H, tiles=TILES, offset=-4.0, focal=1.0, lr=2e-3)
    ref = fit_reference(truth, start, angles, **kw)
    got = checks.fit_numbers({"losses": losses, "grad1": grad1, "change": change}, ref)
    assert got["loss_gap"] < 2e-3 and got["grad_gap"] < 1e-3 and got["change_gap"] < 1e-3
    ctl = checks.fit_numbers(fit_reference(truth, start, angles, dtype=torch.float32,
                                           tf32=True, **kw), ref)
    assert max(ctl.values()) > 10 * max(got.values())
