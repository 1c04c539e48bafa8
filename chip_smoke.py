#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sgrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version, drives the main path (the CLI's default tiled orbit
render) through the kernels, checks the images, and times the kernels.
Each phase prints one JSON line; any failure exits non-zero before the last
line, which is {"ok": true, "device": {...}} on success.

Scene: bench.py's stand-in for the teapot — 3644 seeded points on the
surface of the cube [-1, 1]^3 (np.random.default_rng(0)) turned into
Gaussians by the obj rule (sigma 0.05) — at 512x512 with 64x32 tiles
(docs/BASELINE_CONFIGS.json, config3_teapot_512).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

N_POINTS = 3644
SIZE = 512
TILES = (64, 32)
FRAMES = 8
OFFSET, FOCAL = -4.0, 1.0
KERNEL_ATOL = 2e-5        # tests/test_pallas.py's kernel tolerance
# float32 conditioning of the Gaussian exponent on the small grid frame,
# derived in tests/test_torch_frame.py
FRAME_ATOL = 8e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 FLOP/s (an FMA
# counts as two, so FP32 instructions issue at half the FLOP rate)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
SFU_PER_CLOCK_PER_SM = 16  # MUFU results per clock per SM, compute capability 9.0
# per erf tap of csrc/fused_fwd.cu (its source note): FP32 instructions and
# SFU operations; an exp alone is ~4 FP32 and 1 SFU
TAP_FP32, TAP_SFU, EXP_FP32, EXP_SFU = 17, 2, 4, 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        emit("fail", error=msg)
        sys.exit(1)


def smoke_points() -> np.ndarray:
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (N_POINTS, 3)).astype(np.float32)
    pts /= np.maximum(np.abs(pts).max(axis=1, keepdims=True), 1e-6)
    return pts


def read_png_rgba(path: str) -> np.ndarray:
    """Decode the 8-bit RGBA, filter-0 PNGs that sgrt_tpu_torch writes."""
    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    check(bool(np.all(raw[:, 0] == 0)), f"{path}: unexpected PNG filter")
    return raw[:, 1:].reshape(h, w, 4)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not available"


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over `iters` calls, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_frames(render, angles=(0.0, 45.0)) -> dict:
    """Device time by CUDA kernel over a few frames (torch.profiler), and
    the share of the frames' wall time during which no kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in angles:
            render(a)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us = {}
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            kernels_us[e.key[:80]] = kernels_us.get(e.key[:80], 0.0) + us
    busy_us = sum(kernels_us.values())
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:10]
    return {"frames": len(angles), "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / wall_us if busy_us else None,
            "top_kernels_ms": {k: v / 1e3 for k, v in top}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2

    from sgrt_tpu_torch import cli
    from sgrt_tpu_torch.models.gaussians import grid_scene, scene_from_vertices
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for
    from sgrt_tpu_torch.ops.cuda_kernel import (FUSED_FWD, _block_sizes,
                                                fused_forward, fused_forward_plain)
    from sgrt_tpu_torch.ops.frame import (orbit_camera, probe_capacity,
                                          render_orbit_frame)
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.ops.tiling import gather_tiles, tile_indices
    from sgrt_tpu_torch.utils import nvcc

    dev = torch.device("cuda")

    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    emit("device", name=name, count=count, nvidia_smi=smi, max_sm_clock_mhz=clock_mhz,
         sms=n_sm, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build every kernel from the checkout's sources, all nvcc at once
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    for k in kernels.KERNELS:
        ptxas = [ln.strip() for ln in nvcc.build_log(k.source).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        emit("build", kernel=k.name, source=str(k.source.relative_to(nvcc.CSRC_DIR.parents[1])),
             seconds=round(build_s, 2), ptxas=ptxas)

    # 3. kernel vs plain on frame 0 of the smoke scene
    scene = scene_from_vertices(smoke_points(), device=dev)
    angles = [0.0, 30.0, 45.0, 60.0, 90.0]
    capacity = max(32, int(probe_capacity(scene, angles, OFFSET, FOCAL, TILES) * 1.25))
    cap, _ = tile_renderer_for(capacity)
    pb, qb = _block_sizes(cap)
    cam = orbit_camera(0.0, OFFSET, FOCAL, SIZE, SIZE, device=dev)
    o, dirs = cam.rays()
    idx, counts = tile_indices(scene, cam.view_matrix, TILES, cap, focal_length=FOCAL)
    tiled = gather_tiles(scene, idx)
    frame_in = [(tiled.mu - o).contiguous(), tiled.sigma.contiguous(),
                tiled.magnitude.contiguous(), tiled.albedo.contiguous(),
                _tile_rays(dirs, SIZE, SIZE, TILES).transpose(1, 2).contiguous(), counts]
    cnt = torch.clamp(counts, max=cap).cpu().numpy()
    check(int(counts.max()) <= cap, "frame 0 overflows the probed capacity")
    dense = int(np.argmax(cnt))
    live = [i for i in np.flatnonzero(cnt > 0) if i != dense]
    rng = np.random.default_rng(1)
    pick = [dense] + sorted(rng.choice(live, size=min(31, len(live)), replace=False).tolist())
    sel = torch.tensor(pick, device=dev)
    sub = [t[sel].contiguous() for t in frame_in]
    errs = {}
    for erf_name, exp_name, rows in (("as5", "exact", sub),
                                     ("as3", "fast", [t[:1] for t in sub])):
        got = fused_forward(*rows, pb=pb, qb=qb, erf_name=erf_name, exp_name=exp_name)
        ref = fused_forward_plain(*rows, erf_name=erf_name, exp_name=exp_name)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"kernel output not finite ({erf_name}/{exp_name})")
        errs[f"{erf_name}/{exp_name}"] = float((got - ref).abs().max())
    emit("kernel_vs_plain", kernel=FUSED_FWD.name, capacity=capacity, padded_capacity=cap,
         tiles=len(pick), densest_tile=dense, densest_count=int(cnt[dense]),
         live_tiles=int((cnt > 0).sum()), max_abs_err=errs, atol=KERNEL_ATOL)
    check(all(e <= KERNEL_ATOL for e in errs.values()),
          f"kernel disagrees with its plain version: {errs}")

    # 4. main path: the CLI renders an 8-frame orbit through the kernel
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "cube_cloud.obj")
        with open(obj, "w") as f:
            f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in smoke_points())
        out_png = os.path.join(tmp, "orbit.png")
        argv = ["-f", obj, "-w", str(SIZE), "--height", str(SIZE), "--tiles",
                f"{TILES[0]}x{TILES[1]}", "--frames", str(FRAMES), "-q", "-o", out_png]
        stdout, stderr = io.StringIO(), io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = cli.main(argv)
        cli_s = time.perf_counter() - t0
        main_launches = {k.name: k.launches for k in kernels.KERNELS}
        check(rc == 0, f"cli exited {rc}: {stderr.getvalue()[-2000:]}")
        check(all(n > 0 for n in main_launches.values()),
              f"a kernel was not launched on the main path: {main_launches}")
        check("overflow" not in stderr.getvalue(), stderr.getvalue()[-2000:])
        avg = re.search(r"AVG\. TIME: ([\d.]+) ms", stdout.getvalue())
        check(avg is not None, f"no AVG. TIME line: {stdout.getvalue()!r}")
        imgs = [read_png_rgba(os.path.join(tmp, f"orbit_{i}.png")) for i in range(1, FRAMES + 1)]
        check(all(im.shape == (SIZE, SIZE, 4) for im in imgs), "wrong image shape")
        check(all(int(im[..., :3].max()) > 0 for im in imgs), "a frame is black")
        # frame 1 again through the library entry point: finite, no
        # overflow, and the same 8-bit image the CLI wrote
        img0, ovf0 = render_orbit_frame(scene, 0.0, OFFSET, FOCAL, width=SIZE, height=SIZE,
                                        tiles=TILES, capacity=capacity, backend="kernel")
        check(bool(torch.isfinite(img0).all()), "frame 0 is not finite")
        check(int(ovf0) == 0, f"frame 0 overflowed {int(ovf0)} tiles")
        from sgrt_tpu_torch.utils.image import to_rgba_u8

        check(bool(np.array_equal(to_rgba_u8(img0.cpu().numpy()), imgs[0])),
              "CLI frame 1 differs from render_orbit_frame")
        emit("main_path", argv=argv[2:], rc=rc, frames=FRAMES, capacity=capacity,
             launches=main_launches, overflow=0, cli_seconds=round(cli_s, 3),
             avg_time_ms=float(avg.group(1)),
             mean_rgb=[round(float(im[..., :3].mean()), 3) for im in imgs])

        # the untiled path (modes 1-4): one 128^2 frame
        kernels.reset_launch_counts()
        un_png = os.path.join(tmp, "untiled.png")
        with contextlib.redirect_stdout(io.StringIO()) as so:
            rc = cli.main(["-f", obj, "-w", "128", "--height", "128", "-m", "1", "-q",
                           "-o", un_png])
        un_launches = {k.name: k.launches for k in kernels.KERNELS}
        check(rc == 0 and un_launches[FUSED_FWD.name] == 1, f"untiled run: rc {rc}, {un_launches}")
        un = read_png_rgba(un_png)
        check(int(un[..., :3].max()) > 0, "untiled frame is black")
        emit("untiled_path", size=128, launches=un_launches, time=so.getvalue().strip())

    # small-input reference: the 8x8 grid frame, kernel route vs plain route
    grid = grid_scene(8, device=dev)
    kw = dict(width=64, height=64, tiles=4, capacity=64)
    a, _ = render_orbit_frame(grid, 23.0, backend="kernel", **kw)
    b, _ = render_orbit_frame(grid, 23.0, backend="torch", **kw)
    grid_err = float((a - b).abs().max())
    emit("reference_frame", scene="grid_scene(8)", size=64, max_abs_err=grid_err, atol=FRAME_ATOL)
    check(grid_err <= FRAME_ATOL, f"grid frame differs from the plain route by {grid_err}")

    # 5. times at the main path's shapes (frame 0: all tiles, padded capacity)
    def run_kernel():
        return fused_forward(*frame_in, pb=pb, qb=qb)

    ms = time_cuda(run_kernel, iters=20)
    plain_ms = time_cuda(lambda: fused_forward_plain(*frame_in), iters=1, warmup=1)
    c = cnt.astype(np.float64)
    rays = frame_in[4].shape[2]
    taps = float(np.sum(5 * c * c + c) * rays)           # acc taps + base erfs
    exps = float(np.sum(6 * c) * rays)                   # co once per (q, ray) + 5 tw
    fp32 = TAP_FP32 * taps + EXP_FP32 * exps
    sfu = TAP_SFU * taps + EXP_SFU * exps
    b_, n_ = frame_in[1].shape
    nbytes = 4 * (b_ * n_ * 8 + 2 * b_ * 3 * rays + b_)
    t_fp32, t_sfu = fp32 / FP32_INSTR_PER_S, sfu / (SFU_PER_CLOCK_PER_SM * n_sm * clock_mhz * 1e6)
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_s = max(t_fp32, t_sfu, t_bytes)
    frame_ms = []
    for i in range(FRAMES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_orbit_frame(scene, i * 360.0 / FRAMES, OFFSET, FOCAL, width=SIZE, height=SIZE,
                           tiles=TILES, capacity=capacity, backend="kernel")
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    frame_mean = float(np.mean(frame_ms[1:]))  # the first frame warms up
    emit("frame_profile", **profile_frames(
        lambda a: render_orbit_frame(scene, a, OFFSET, FOCAL, width=SIZE, height=SIZE,
                                     tiles=TILES, capacity=capacity, backend="kernel")))
    emit("times", kernel=FUSED_FWD.name, shape={"B": b_, "N": n_, "R": rays},
         ms=ms, plain_ms=plain_ms, library_ms="n/a: no single PyTorch call computes it",
         live_erf=taps, erf_per_s=taps / (ms * 1e-3),
         bound_ms=bound_s * 1e3, fp32_bound_ms=t_fp32 * 1e3, sfu_bound_ms=t_sfu * 1e3,
         bytes_bound_ms=t_bytes * 1e3, bound_by=("sfu" if t_sfu >= t_fp32 else "fp32")
         if bound_s > t_bytes else "bytes", frame_ms=frame_mean,
         rays_per_s=SIZE * SIZE / (frame_mean * 1e-3), power_limit=smi)

    # 6. the kernel line
    print(json.dumps({"kernels": [{
        "name": FUSED_FWD.name, "route": FUSED_FWD.route,
        "source": str(FUSED_FWD.source.relative_to(nvcc.CSRC_DIR.parents[1])),
        "replaces": FUSED_FWD.replaces, "launches": main_launches[FUSED_FWD.name],
        "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3, "bound_by": "operations" if bound_s > t_bytes else "bytes",
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
