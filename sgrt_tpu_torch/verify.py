"""On-device correctness verification: the kernel route against the plain
tensor route and the oracle (port of the JAX package's verify_tpu.py).

    python -m sgrt_tpu_torch.verify [--quick] [--device cuda|cpu]

Every check runs the port's kernel route (backend="kernel": the CUDA
kernels on the card, their plain versions on the CPU) and compares pixels
AND gradients with the plain tensor formulation (backend="torch",
ops.render) and the un-fused oracle (ops.reference). It prints a JSON
report, {"device", "compiled", "checks", "parity_ok"}, and exits 1 when a
check fails; "compiled" says whether the kernels ran on CUDA.

Checks (the JAX script's five, with its names and tolerances):
  1. fused forward, untiled: cuda_render.render_rays vs render_rays_impl
     vs render_rays_reference, cube scene, 64x64 rays.
  2. fused forward, tiled + counts-bounded: render_orbit_frame
     (backend="kernel") vs (backend="torch"), 256x256, cube + teapot.
  3. gradients, untiled: the kernel route's backward vs autograd of the
     torch route, all four scene fields.
  4. gradients through the tiled frame loss (gather + kernel +
     scatter-add transpose): make_frame_value_and_grad, kernel vs torch
     backend, teapot.
  5. counts semantics: the split kernel tw_split at capacity with counts=c
     equals it with no counts on inert-padded inputs (fwd + bwd).

The cube and teapot are read from the obj files the caller names
(--cube-obj, --teapot-obj); otherwise seeded clouds of 386 (cube) and 3644
(teapot) points on the cube's surface stand in, the JAX script's fallbacks
for its absent reference objs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

FIELDS = ("mu", "sigma", "magnitude", "albedo")
# sides of the untiled ray grid (checks 1, 3) and of the tiled frames (check 2)
RAYS, FRAME = 64, 256


def _scene(path, n_fallback, device):
    from sgrt_tpu_torch.models.gaussians import scene_from_obj, scene_from_vertices

    if path is not None:
        return scene_from_obj(path, device=device)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (n_fallback, 3)).astype(np.float32)
    pts /= np.maximum(np.abs(pts).max(axis=1, keepdims=True), 1e-6)
    return scene_from_vertices(pts, device=device)


def _rel_err(a, b) -> float:
    a = torch.as_tensor(a).detach().double().cpu()
    b = torch.as_tensor(b).detach().double().cpu()
    denom = max(float(b.abs().max()), 1e-12)
    return float((a - b).abs().max()) / denom


def _torch_rays(o, dirs, scene, block: int = 256):
    """render_rays_impl (the torch route) with autograd in checkpointed
    blocks of rays: its graph holds ~3 R 5N^2 floats (64 GB at 4096 rays
    and N 512), a block's alone R/block times less."""
    from torch.utils.checkpoint import checkpoint

    from sgrt_tpu_torch.models.gaussians import GaussianScene
    from sgrt_tpu_torch.ops.render import render_rays_impl

    def run(d, *fields):
        return render_rays_impl(o, d, GaussianScene(*fields), ray_block=d.shape[0])

    fields = [getattr(scene, f) for f in FIELDS]
    return torch.cat([checkpoint(run, dirs[i:i + block], *fields, use_reentrant=False)
                      for i in range(0, dirs.shape[0], block)])


def _scene_grads(loss_of, scene):
    """Gradients of loss_of(scene) for the four fields, by autograd."""
    from sgrt_tpu_torch.models.gaussians import GaussianScene

    leaves = {f: getattr(scene, f).detach().clone().requires_grad_(True) for f in FIELDS}
    loss_of(GaussianScene(**leaves)).backward()
    return {f: leaves[f].grad for f in FIELDS}


def counts_case(device):
    """Check 5's inputs: one tile of 64 rows, 40 live, 128 rays, from
    rng(1); coeff is 0 past the count, as gather_tiles' dummies are. Returns
    mu_bar, coeff (1,64,128), sigma, inv (1,64), counts (1,) int32 and the
    live-row mask (64,) as numpy."""
    rng = np.random.default_rng(1)
    n_cap, n_live, r = 64, 40, 128
    zmask = np.arange(n_cap) < n_live
    z = torch.as_tensor(zmask, device=device)[None, :, None]
    mu_bar = torch.as_tensor(rng.normal(size=(1, n_cap, r)), dtype=torch.float32, device=device)
    # physical scale: small positive weights keep |exponent| ~ O(1), so tw
    # stays O(1) and relative error is meaningful
    coeff = torch.as_tensor(rng.uniform(0.01, 0.1, (1, n_cap, r)), dtype=torch.float32,
                            device=device) * z
    sigma = torch.as_tensor(rng.uniform(0.5, 1.5, (1, n_cap)), dtype=torch.float32,
                            device=device)
    inv = 1.0 / (1.4142135 * sigma)
    counts = torch.full((1,), n_live, dtype=torch.int32, device=device)
    return mu_bar, coeff, sigma, inv, counts, zmask


def run_checks(quick: bool = False, device="cuda", *, cube_obj: str | None = None,
               teapot_obj: str | None = None) -> dict:
    """The checks as a report dict, at the JAX script's sizes (RAYS,
    FRAME). cube_obj and teapot_obj name obj files for the two scenes
    (None: the seeded clouds)."""
    from sgrt_tpu_torch.ops.cuda_render import render_rays
    from sgrt_tpu_torch.ops.cuda_split import tw_split
    from sgrt_tpu_torch.ops.frame import orbit_camera, probe_capacity, render_orbit_frame
    from sgrt_tpu_torch.ops.reference import render_rays_reference
    from sgrt_tpu_torch.ops.render import render_rays_impl
    from sgrt_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    report = {"device": name, "compiled": dev.type == "cuda", "checks": {}}
    ok = True
    t_start = time.perf_counter()

    def record(check, err, tol):
        nonlocal ok
        passed = bool(err <= tol)
        ok = ok and passed
        report["checks"][check] = {"max_rel_err": err, "tol": tol, "ok": passed}
        print(f"[verify {time.perf_counter() - t_start:7.1f}s] {check}: "
              f"err={err:.2e} {'ok' if passed else 'FAIL'}", file=sys.stderr)

    cube = _scene(cube_obj, 386, dev)
    cam = orbit_camera(30.0, -4.0, 1.0, RAYS, RAYS, device=dev)
    o, dirs = cam.rays()
    # the torch route pads the rays to a multiple of its ray block
    ray_block = min(2048, dirs.shape[0])

    # --- 1. forward untiled: kernel vs torch vs oracle ---------------------
    with torch.no_grad():
        px_kernel = render_rays(o, dirs, cube, erf_name="as5")
        px_torch = render_rays_impl(o, dirs, cube, ray_block=ray_block)
        record("fwd_untiled_vs_xla", _rel_err(px_kernel, px_torch), 2e-5)
        if not quick:
            # the fused route hoists erf1 and collapses the pdf (ops.render):
            # algebraically equal, but float32 rounding of the different
            # association accumulates over N Gaussians
            px_oracle = render_rays_reference(o, dirs, cube)
            record("fwd_untiled_vs_oracle", _rel_err(px_kernel, px_oracle), 2.5e-4)

    # --- 2. forward tiled + counts, full frames ----------------------------
    scenes = [("cube", cube)] if quick else [
        ("cube", cube), ("teapot", _scene(teapot_obj, 3644, dev))]
    for scene_name, sc in scenes:
        capacity = max(64, int(probe_capacity(sc, [30.0], -4.0, 1.0, 16) * 1.2))
        with torch.no_grad():
            kw = dict(width=FRAME, height=FRAME, tiles=16, capacity=capacity)
            img_k, ovf = render_orbit_frame(sc, 30.0, -4.0, 1.0, backend="kernel",
                                            erf_name="as5", **kw)
            img_t, _ = render_orbit_frame(sc, 30.0, -4.0, 1.0, backend="torch",
                                          erf_name="exact", **kw)
        if int(ovf) != 0:
            raise RuntimeError(f"{scene_name}: tile capacity overflow in verify")
        # the kernels' as5 erf is float32-exact per element (|err| <= 1.5e-7);
        # summed over thousands of Gaussians and exponentiated, its distance
        # to torch.erf reaches ~1e-4 relative
        record(f"fwd_tiled_{scene_name}", _rel_err(img_k, img_t), 2.5e-4)

    # --- 3. gradients untiled: the kernel route's VJP vs autograd ----------
    tgt = torch.zeros((dirs.shape[0], 3), device=dev)
    g_k = _scene_grads(lambda s: torch.mean(
        (render_rays(o, dirs, s, erf_name="as5") - tgt) ** 2), cube)
    g_t = _scene_grads(lambda s: torch.mean((_torch_rays(o, dirs, s) - tgt) ** 2), cube)
    for f in FIELDS:
        record(f"grad_untiled_{f}", _rel_err(g_k[f], g_t[f]), 5e-4)

    # --- 4. gradients through the tiled frame train loss -------------------
    if not quick:
        from sgrt_tpu_torch.parallel.fit import make_frame_value_and_grad

        sc = scenes[-1][1]
        capacity = max(64, int(probe_capacity(sc, [0.0], -4.0, 1.0, 8) * 1.2))
        cam_t = orbit_camera(0.0, -4.0, 1.0, 128, 128, device=dev)
        o_t, dirs_t = cam_t.rays()
        target = torch.zeros((128, 128, 3), device=dev)
        grads = {}
        for be in ("kernel", "torch"):
            # the torch route's backward recomputes one checkpointed tile
            # batch at a time and holds its graph, ~3 (P, q_block, 5N)
            # float32 tensors per q block: 3 P 5N^2 4 bytes a tile, ~21 GB
            # at this capacity (N = 1184, P = 256), so one tile a batch
            vg = make_frame_value_and_grad(width=128, height=128, tiles=8, capacity=capacity,
                                           backend=be,
                                           erf_name="as5" if be == "kernel" else "exact",
                                           q_block=32, tile_batch=1)
            (_, ovf), g = vg(sc, cam_t.view_matrix, o_t, dirs_t, target)
            if int(ovf) != 0:
                raise RuntimeError("teapot: tile capacity overflow in the frame loss")
            grads[be] = g
        for f in FIELDS:
            record(f"grad_tiled_teapot_{f}",
                   _rel_err(getattr(grads["kernel"], f), getattr(grads["torch"], f)), 5e-4)

    # --- 5. counts semantics of the split kernel (fwd + bwd) ---------------
    # Contract (ops.cuda_split): counts bound the live prefix; rows past it
    # are inert (coeff = 0), as gather_tiles' dummies are. tw of dead rows is
    # no part of the contract, so comparisons mask to live rows.
    mu_bar, coeff, sigma, inv, counts, zmask = counts_case(dev)
    z = torch.as_tensor(zmask, device=dev)[None, :, None]

    def value_and_grad(cnt):
        mb, co = (t.clone().requires_grad_(True) for t in (mu_bar, coeff))
        v = torch.sum(tw_split(mb, co, sigma, inv, cnt) * z)
        v.backward()
        return v.detach(), mb.grad, co.grad

    v_c, dmu_c, dco_c = value_and_grad(counts)
    v_t, dmu_t, dco_t = value_and_grad(None)
    record("counts_fwd", _rel_err(v_c, v_t), 1e-5)
    record("counts_bwd_dmu", _rel_err(dmu_c[:, zmask], dmu_t[:, zmask]), 1e-4)
    record("counts_bwd_dcoeff", _rel_err(dco_c[:, zmask], dco_t[:, zmask]), 1e-4)

    report["parity_ok"] = ok
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sgrt_tpu_torch.verify",
                                 description="kernel route vs torch route vs oracle")
    ap.add_argument("--quick", action="store_true", help="checks 1 (no oracle), 2 (cube), 3, 5")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cube-obj", help="obj file of the cube scene (default: 386 seeded points)")
    ap.add_argument("--teapot-obj",
                    help="obj file of the teapot scene (default: 3644 seeded points)")
    args = ap.parse_args(argv)
    report = run_checks(quick=args.quick, device=args.device, cube_obj=args.cube_obj,
                        teapot_obj=args.teapot_obj)
    print(json.dumps(report, indent=2))
    return 0 if report["parity_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
