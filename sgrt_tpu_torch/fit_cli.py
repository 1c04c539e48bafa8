"""Scene-fitting CLI, the training entry point (PyTorch port of
sgrt_tpu.fit_cli, with the same flags and output lines).

Renders target views of a ground-truth scene (obj or grid), perturbs the
scene's means, and recovers them by gradient descent through the fused
kernels' analytic backward, orbiting the camera across steps (each step
sees another view, so the fit is multi-view). With --aniso the ground
truth is the scene with per-axis scale multipliers, the means and the
per-axis scales are perturbed, and the fit runs through the anisotropic
kernels. Checkpoints with utils.checkpoint.

Usage:
  python -m sgrt_tpu_torch.fit_cli -f scene.obj --steps 200 --views 8 \
      --noise 0.02 --out fitted.png --checkpoint-dir ckpt/ [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sgrt_tpu_torch.fit_cli",
                                 description="Fit a Gaussian scene to target renders")
    ap.add_argument("--file", "-f", default=None, help="Ground-truth scene (.obj).")
    ap.add_argument("--grid", "-g", type=int, default=4)
    ap.add_argument("--width", "-w", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--tiles", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--views", type=int, default=8,
                    help="Number of orbit views cycled during fitting.")
    ap.add_argument("--noise", type=float, default=0.02,
                    help="Stddev of the mu perturbation to recover from.")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trainable", default=None,
                    help="Comma list (default: mu,sigma,magnitude,albedo; "
                         "with --aniso: mu,scale,magnitude,albedo).")
    ap.add_argument("--aniso", default=None, metavar="SX,SY,SZ",
                    help="Fit an anisotropic (diagonal-covariance) scene: the ground "
                         "truth is the loaded scene with per-axis scale multipliers; the "
                         "fit recovers means and per-axis scales through the anisotropic "
                         "kernels (--backend kernel).")
    ap.add_argument("--out", default=None, help="Write final render to PNG.")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Device to fit on (cpu runs the kernels' plain versions).")
    ap.add_argument("--backend", choices=("kernel", "torch"), default="kernel",
                    help="The fused CUDA kernels with their analytic backward, or "
                         "plain tensor ops differentiated by autograd.")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from sgrt_tpu_torch.models.gaussians import grid_scene, scene_from_obj
    from sgrt_tpu_torch.ops import anisotropic as an
    from sgrt_tpu_torch.ops.frame import (orbit_camera, probe_buckets, probe_capacity,
                                          render_orbit_frame)
    from sgrt_tpu_torch.parallel.fit import (adam, init_state, make_aniso_frame_train_step,
                                             make_frame_train_step)

    dev = args.device
    scene = (scene_from_obj(args.file, device=dev) if args.file
             else grid_scene(args.grid, device=dev))
    w, h = args.width, args.height

    aniso_scene = None
    if args.aniso:
        sf = [float(x) for x in args.aniso.split(",")]
        if len(sf) != 3:
            print("error: --aniso expects SX,SY,SZ", file=sys.stderr)
            return 1
        if args.backend != "kernel":
            print("error: --aniso fits through the anisotropic kernels (--backend kernel)",
                  file=sys.stderr)
            return 2
        aniso_scene = an.from_isotropic(scene)
        aniso_scene = aniso_scene.replace(
            scale=aniso_scene.scale * torch.tensor([sf], device=scene.device))
        scene = an.iso_proxy(aniso_scene)   # probing/tiling proxy

    angles = [i * 360.0 / args.views for i in range(args.views)]
    cap = max(32, int(probe_capacity(scene, angles, -4.0, 1.0, args.tiles) * 1.3))
    bucket = probe_buckets(scene, angles, -4.0, 1.0, args.tiles, margin=1.3)
    print(f"scene: {scene.n} Gaussians; {args.views} views at {w}x{h}; "
          f"capacity {cap}; {bucket}" + (" [aniso]" if args.aniso else ""))

    render_kw = dict(tiles=args.tiles, capacity=cap, backend=args.backend, bucket_cfg=bucket)

    def render(sc, a):
        if aniso_scene is not None:
            return an.render_tiled_aniso(sc, orbit_camera(a, -4.0, 1.0, w, h, device=dev),
                                         **render_kw)[0]
        return render_orbit_frame(sc, a, width=w, height=h, **render_kw)[0]

    # targets: ground-truth renders of each orbit view
    cams = [orbit_camera(a, -4.0, 1.0, w, h, device=dev) for a in angles]
    targets = [render(aniso_scene if aniso_scene is not None else scene, a) for a in angles]

    rng = np.random.default_rng(args.seed)

    def noise(shape, draw):
        return torch.from_numpy(draw(shape).astype(np.float32)).to(scene.device)

    step_kw = dict(width=w, height=h, tiles=args.tiles, capacity=cap, bucket_cfg=bucket)
    if aniso_scene is not None:
        # perturb the means and the per-axis scales: the fit must recover
        # the covariance structure, not just positions
        truth = aniso_scene
        noisy = truth.replace(
            mu=truth.mu + noise(tuple(truth.mu.shape), lambda s: rng.normal(0, args.noise, s)),
            scale=truth.scale * noise(tuple(truth.scale.shape),
                                      lambda s: rng.uniform(0.8, 1.25, s)))
        trainable = tuple((args.trainable or "mu,scale,magnitude,albedo").split(","))
        step = make_aniso_frame_train_step(trainable=trainable, **step_kw)
    else:
        truth = scene
        noisy = truth.replace(
            mu=truth.mu + noise(tuple(truth.mu.shape), lambda s: rng.normal(0, args.noise, s)))
        trainable = tuple((args.trainable or "mu,sigma,magnitude,albedo").split(","))
        step = make_frame_train_step(backend=args.backend, trainable=trainable, **step_kw)
    state = init_state(noisy, adam(args.lr))

    mgr = None
    if args.checkpoint_dir:
        from sgrt_tpu_torch.utils.checkpoint import make_manager, save_fit

        mgr = make_manager(args.checkpoint_dir)

    t0 = time.perf_counter()
    for i in range(args.steps):
        v = i % args.views
        cam = cams[v]
        o, dirs = cam.rays()
        state, loss, overflow = step(state, cam.view_matrix, o, dirs, targets[v])
        if (i + 1) % max(args.steps // 10, 1) == 0:
            print(f"step {i+1:5d}  view {v}  loss {float(loss):.3e}")
            if int(overflow):
                print(f"warning: step {i+1}: {int(overflow)} tiles over "
                      "capacity (gradient mass dropped) — raise capacity/margin")
        if mgr is not None and (i + 1) % args.checkpoint_every == 0:
            save_fit(mgr, i + 1, state)
    if truth.device.type == "cuda":
        torch.cuda.synchronize(truth.device)
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f} s "
          f"({args.steps * w * h / dt / 1e3:.1f} K rays/s fwd+bwd)")
    if mgr is not None:
        save_fit(mgr, args.steps, state)

    # report recovery quality
    err0 = float(torch.abs(noisy.mu - truth.mu).max())
    err1 = float(torch.abs(state.scene.mu - truth.mu).max())
    print(f"max |mu error|: {err0:.5f} -> {err1:.5f}")
    if aniso_scene is not None:
        s0 = float(torch.abs(noisy.scale - truth.scale).max())
        s1 = float(torch.abs(state.scene.scale - truth.scale).max())
        print(f"max |scale error|: {s0:.5f} -> {s1:.5f}")

    if args.out:
        from sgrt_tpu_torch.utils.image import write_png

        write_png(args.out, render(state.scene, 0.0).detach().cpu().numpy())
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
