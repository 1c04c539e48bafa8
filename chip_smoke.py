#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sgrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --torch-route   # only times the torch route's terms
    python3 chip_smoke.py --only aniso_dense[,split,approx,frontends,...]   # some phase groups

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version, drives the main paths through the kernels, checks what
comes out, and times the kernels:

  serving   the CLI's default tiled orbit render (the fused forward kernel,
            csrc/chunked.cu's forward at one chunk), held against its plain
            version and float64 on frame 0;
  training  fit_cli (forward-with-T and saved-T backward kernels) and the
            north-star train step, once more with the saved-T budget at 0
            so that the recompute backward kernel runs; the fused forwards
            against their plain versions and float64 at the step's view;
            the kernels' times with the backwards' parts (every fused
            kernel is csrc/chunked.cu's at one chunk); under --only also
            the fused backwards and forwards beside the chunked route's at
            one chunk (the forwards at the serving frame 0 and the step's
            view);
  dense     the 50k-Gaussian sphere at 512x512 (the Gaussian-axis chunked
            kernels): tile grid and buckets, the chunked kernels against
            their plain versions (the fused forwards on the sparse bucket),
            the bucketed frame and the CLI, the bucketed train step and the
            slab train step, and the kernels' times with each backward's
            parts (kernel 5 at one chunk beside it at its chunk plan);
  aniso     the cube cloud with per-axis scales at 256x256 (the fused
            anisotropic kernels, csrc/chunked.cu's at one chunk): kernels vs
            plain, the --aniso CLI orbit, fit_cli --aniso, the bucketed
            anisotropic train step, the kernels' times with the backwards'
            parts; under --only also the fused backwards and forwards
            beside the chunked route's at one chunk;
  aniso dense  the 50k-Gaussian sphere with per-axis scales at 512x512 (the
            chunked anisotropic kernels): tile grid and buckets, kernels vs
            plain (the forward, the forward-with-T and both backwards; the
            fused anisotropic kernels on the sparse bucket), the
            bucketed frame and the --aniso CLI, the anisotropic slab train
            step on the saved-T schedule and once with the saved-T budget at
            0 (the recompute backward), the kernels' times with each
            backward's parts, and the crossover of the fused and chunked
            anisotropic backwards; under --only also the fused anisotropic
            forwards beside the chunked ones on the sparse bucket;
  split     the split kernels (tw and colors from precomputed planes,
            csrc/chunked.cu's forward and recompute backward at one chunk
            over plane rows) at the training cell's 30-degree view: kernels
            vs plain and float64 (also on the dense cell's densest tile),
            the split render route against the fused route in colors and
            scene gradients, the on-card verification entry point
            (sgrt_tpu_torch.verify, full checks; its check 5 launches the
            split kernels), and the kernels' times with their device
            profiles and peak memory and the backwards' parts, kernels 1,
            2 and 4 on the same tiles beside them;
  approx    every erf and exp name on the main paths: the reference's
            img-error (img-error.cpp:18-60) at its own 256x256 per stack
            against the oracle under tests/test_img_error.py's MSE bounds;
            the serving CLI's orbit and kernels 1, 2 and 3 per stack
            (TIMED_STACKS) with their bounds; the north-star train step
            under spline_mirror/spline, saved-T and recompute;
  frontends the entry points beside the CLI: the batched orbit at the
            serving cell (8 frames' tiles in one launch of kernel 1, each
            frame equal to the per-frame render, the per-frame loop and the
            batched call timed in turns with their device profiles), the
            bucketed batched orbit at the training cell's size (5 frames in
            batches of 3), render_tiled (the plain renderer, tiled) on the
            serving frame 0 within 2/255 of the kernel route, the viewer over
            HTTP (isotropic tiled and untiled, anisotropic tiled at sx=3,
            an image after an edit: each equal to the direct render, no
            overflow), and the native PNG writer against the Python encoder.

Every kernels-vs-plain phase holds one tile under as3/fast and under each
stack of APPROX_STACKS (taylor/exact, spline/spline, spline_mirror/exact)
beside its as5/exact cases, under the same gates.

After the build, kernel_resources prints each device function's registers,
spill bytes, shared memory and resident blocks per SM, and the instructions
of its hot loop in the built SASS. Each phase prints one JSON line; any
failure exits non-zero before the last line, which is {"ok": true,
"device": {...}} on success.

Scenes. Serving and training: bench.py's stand-in for the teapot, 3644
seeded points on the surface of the cube [-1, 1]^3 (np.random.default_rng(0))
turned into Gaussians by the obj rule (sigma 0.05); serving at 512x512 with
64x32 tiles (docs/BASELINE_CONFIGS.json, config3_teapot_512), training at
bench.py's north-star step, 256x256 with 32x16 tiles, bucketed. Dense:
scripts/large_n.py's sphere, 50,000 seeded points on the unit sphere by the
same rule, at docs/LARGE_N.md's fitting size (512x512, orbit at 30 degrees,
auto_tile_grid at margin 1.2, the buckets pinned: DENSE_N_DENSE). Anisotropic:
config4_aniso_teapot_256 on the cube cloud (ANISO_MULT); aniso dense: the
sphere with scales sigma x ADENSE_MULT (scripts/large_n.py --aniso).
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
# per erf tap of csrc/chunked.cu's forward (its source note): FP32
# instructions and SFU operations; an exp alone is ~4 FP32 and 1 SFU
TAP_FP32, TAP_SFU, EXP_FP32, EXP_SFU = 17, 2, 4, 1
# the same per tap of every erf of the forward and per exp
# (csrc/gauss_common.cuh): as3 its 3-term polynomial with the IEEE
# reciprocal and expf; taylor a clamp, x^2, a 10-term Horner and (2/sqrt(pi)
# x) acc; the splines their saturation tests, a clamp, the segment's scale
# and a 3-step Horner (the mirror also its sign), no SFU; the fast exp 4
# FP32; the spline exp as the spline erf, and under it T's exponent is
# summed term by term, one FP32 more a tap (chunked.cu, kTermwise)
ERF_TAP_OPS = {"as5": (TAP_FP32, TAP_SFU), "as3": (14, 2), "taylor": (23, 0),
               "spline": (12, 0), "spline_mirror": (14, 0)}
EXP_OPS = {"exact": (EXP_FP32, EXP_SFU), "fast": (4, 0), "spline": (12, 0)}
# the erfs without an (erf, gauss) pair and the spline exp, a stack each: a
# one-tile case each beside one_tile_as3_fast in every kernels-vs-plain phase
APPROX_STACKS = (("taylor", "exact"), ("spline", "spline"), ("spline_mirror", "exact"))
# the reference's img-error test (img-error.cpp:18-60) at its own 256x256:
# the stacks and MSE bounds of tests/test_img_error.py's kernel tests
IMG_ERROR_SIZE = 256
IMG_ERROR_STACKS = (("as5", "exact", 1e-10), ("as3", "exact", 1e-8),
                    ("spline_mirror", "exact", 1e-8), ("taylor", "exact", 1e-2),
                    ("as3", "fast", 1e-4), ("as5", "fast", 1e-4), ("as5", "spline", 1e-6))
# the dense cells' APPROX_STACKS cases: the seeded tile nearest this many
# rows (two chunks, the second partly live; the plain versions and their
# float64 runs cost ~count^2 a tile, 21-29 s a stack on the densest tiles)
APPROX_DENSE_COUNT = 2000
# the stacks timed on the serving and training paths (approx_phases)
TIMED_STACKS = (("as5", "exact"), ("as3", "fast"), *APPROX_STACKS, ("spline_mirror", "spline"))
# the backward's work, whatever kernel does it: per live (p, q, ray) the
# gradient pass's five erf-and-gauss taps, 4 FP32 each to fold the
# cotangents, and 8 FP32 per pair (mb_p - mb_q, the S0 and S1 scaling, dmb,
# dinv, dsb); per live (q, ray) the base path, co's exp and the prep chain
# (~20 FP32). The counts are the yardstick of every backward's bound.
BWD_PAIR_FP32, BWD_PAIR_SFU = 5 * (TAP_FP32 + 4) + 8, 5 * TAP_SFU
BWD_ROW_FP32, BWD_ROW_SFU = TAP_FP32 + EXP_FP32 + 20, TAP_SFU + EXP_SFU
# training cell: bench.py's north-star step (bench.py:103-150)
TRAIN_SIZE, TRAIN_TILES, TRAIN_STEPS = 256, (32, 16), 10
ANGLES = [0.0, 30.0, 45.0, 60.0, 90.0]
# Training kernels vs their plain versions, as max |diff| / max |plain| per
# output. tests/test_pallas.py holds gradients at 5e-5 of scale; on an H100
# every output but doc agrees within 4e-6 (this script's
# train_kernels_vs_plain line), so 1e-5. doc is the
# difference of two terms, sum_r dmb d and 2 oc d|oc|^2, each ~|oc|/sigma
# = 4/0.05 = 80 times its size on this cloud, so summation order alone
# moves it by ~sqrt(R) 2^-24 80 = 5e-5 of its scale at R = 128: 2e-4.
TRAIN_REL, DOC_REL = 1e-5, 2e-4
# the dense cell: scripts/large_n.py's sphere at docs/LARGE_N.md's size
DENSE_N, DENSE_SIZE, DENSE_ANGLE, DENSE_TARGET_ANGLE = 50_000, 512, 30.0, 35.0
DENSE_MARGIN = 1.2
# slab of the slab step: 256 tiles of 5376 rows and 128 rays hold 3.5 GB of
# T, and a recomputing slab 1.2 GB of the chunked backward's T scratch
DENSE_SLAB_TILES = 256
# The dense cell's buckets: the densest eighth of the 2048 tiles at
# auto_tile_grid's capacity, the rest (empty at 30 degrees) at 32 rows.
# probe_buckets chose this on an H100 in some calls and one bucket of all
# tiles in others (its cost model is measured in every call), and the choice
# decides which backward each launch takes; pinned so that every run times
# the same launches. The probe's own pick is printed beside it.
DENSE_N_DENSE, DENSE_CAP_SPARSE = 256, 32
# tiles of the dense kernels-vs-plain case: the densest and seeded live ones
# (the plain versions and their float64 runs cost ~count^2 a tile; 32 tiles
# took 198 s of an H100 run, so the script keeps to 16)
DENSE_SUB_TILES = 16
# the anisotropic cell: docs/BASELINE_CONFIGS.json's config4_aniso_teapot_256
# (the cube cloud with per-axis scales sigma * ANISO_MULT, 256x256, 32x16
# tiles of 128 rays, orbit camera at -4, focal length 1)
ANISO_MULT = (1.6, 0.7, 1.0)
ANISO_SIZE, ANISO_TILES, ANISO_STEPS = 256, (32, 16), 10
ANISO_FIT_TILES = 16      # fit_cli's square grid, as the training phase's run
# the anisotropic dense cell: scripts/large_n.py --res 512 --n 50000 --aniso
# (large_n.py:118-126: the dense cell's sphere with per-axis scales
# sigma x (2, 1, 0.5)), at docs/LARGE_N.md:82's fitting size: 512x512, orbit
# at 30 degrees, auto_tile_grid on the max-scale proxy at margin 1.2. The
# buckets are pinned from the seeded data, not from probe_buckets' measured
# cost model: the sparse bucket at 32 rows, the dense one the tiles whose
# count exceeds that at 30 or 35 degrees (frame and target), rounded up to a
# multiple of 64. Slabs of 256 tiles: a recomputing slab holds 256 x 5 x
# 1920 x 128 floats (1.26 GB) of the chunked backward's T scratch.
ADENSE_MULT = (2.0, 1.0, 0.5)
ADENSE_CAP_SPARSE, ADENSE_SLAB_TILES = 32, 256
# the kernels-vs-plain cases' tiles: the plain versions cost ~count^2 per
# tile, ~4x the isotropic dense cell's at these counts
ADENSE_SUB_TILES, ADENSE_B1_COUNT = 8, 3000
# the dense cells' sparse buckets' densest tiles, held against the fused
# kernels' plain versions (at most 32 rows a tile: cheap)
SPARSE_TILES = 32
# the crossover of the two anisotropic routes: the densest tiles cut to
# these counts, both backwards timed once each
ADENSE_CROSS_TILES, ADENSE_CROSS_COUNTS = 8, (1024, 2048, 4096)
# per live (row, ray), anisotropic rows (csrc/gauss_common.cuh, AnisoGeo):
# A (8 FP32), Bt (5), two IEEE square roots (~6 FP32 and a MUFU.RSQ each)
# and a division (~5 and a MUFU.RCP), mb, the exponent and co (7); the
# backward's chain through A, Bt and C adds ~40 FP32 and two divisions
PREP_FP32, PREP_SFU = 38, 3
CHAIN_FP32, CHAIN_SFU = 40, 2
# the split kernels (15-18): the training cell's 30-degree view, its 32-tile
# subset for the kernels-vs-plain case and the plain versions' times, and the
# dense cell's densest tile (4315 rows) padded to SPLIT_DENSE_CAP rows for
# the long sums. Kernels vs their float32 plain versions: every output within
# TRAIN_REL of its scale, as the training kernels (the planes' terms are
# summed in another order, over at most 480 rows; nothing cancels as doc
# does); the dense tile is held to gate_vs_f64 alone, as the dense cell.
SPLIT_SUB_TILES, SPLIT_DENSE_CAP, SPLIT_REL = 32, 4352, TRAIN_REL
# the viewer phase: the cube cloud at 128x128 in 16x16 tiles
VIEWER_SIZE, VIEWER_TILES = 128, 16


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


def sphere_points(n: int) -> np.ndarray:
    """scripts/large_n.py's sphere: n seeded normal points on the unit sphere."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def write_obj(path: str, pts: np.ndarray) -> None:
    with open(path, "w") as f:
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in pts)


def read_png_rgba(path: str) -> np.ndarray:
    """Decode the 8-bit RGBA, filter-0 PNGs that sgrt_tpu_torch writes."""
    return decode_png_rgba(open(path, "rb").read(), path)


def decode_png_rgba(data: bytes, path: str) -> np.ndarray:
    """read_png_rgba of a PNG's bytes; `path` names it in a failure."""
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
    return {"frames": len(angles), **profile_device(render, angles)}


def profile_device(run, args) -> dict:
    """run(a) for each a in args under torch.profiler: wall ms, device busy
    ms, the idle share of the wall time, and the top kernels by device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in args:
            run(a)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us = {}
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            kernels_us[e.key[:80]] = kernels_us.get(e.key[:80], 0.0) + us
    busy_us = sum(kernels_us.values())
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / wall_us if busy_us else None,
            "top_kernels_ms": {k: v / 1e3 for k, v in top}}


def time_once(fn):
    """(ms of one call by CUDA events, the call's result)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def rel_err(got, want) -> float:
    """max |got - want| / max |want|: a difference relative to the output's
    scale."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def launch_inputs(tiled, o, tile_dirs, counts) -> list:
    """The fused op's inputs (oc, sigma, mag, albedo, dirs_t, counts) as
    render_tiles_fused builds them from gathered tiles; for an anisotropic
    tile scene (oc, invd, ...) as render_tiles_fused_aniso does."""
    import torch

    n = tiled.mu.shape[1]
    shape = tiled.sigma if hasattr(tiled, "sigma") else 1.0 / (tiled.scale * tiled.scale)
    return [(tiled.mu - o).contiguous(), shape.contiguous(),
            tiled.magnitude.contiguous(), tiled.albedo.contiguous(),
            tile_dirs.transpose(1, 2).contiguous(),
            torch.clamp(counts.to(torch.int32), max=n).contiguous()]


def bucket_launches(scene, view, o, tile_dirs, cfg, tiles=TRAIN_TILES) -> list:
    """The inputs of each launch of render_tiles_bucketed (dense bucket
    first, if any), at the capacities the scene's router rounds to."""
    from sgrt_tpu_torch.ops.scheduler import BucketConfig, _scene_ops, bucketed_tile_indices

    renderer_for, gather, culled = _scene_ops(scene)
    cfg = BucketConfig(cfg.n_dense, renderer_for(cfg.cap_dense)[0],
                       renderer_for(cfg.cap_sparse)[0])
    dense_ids, idx_d, sparse_ids, idx_s, counts = bucketed_tile_indices(
        culled, view, tiles, cfg, focal_length=FOCAL)
    out = []
    if cfg.n_dense:
        out.append(launch_inputs(gather(scene, idx_d), o, tile_dirs[dense_ids],
                                 counts[dense_ids]))
    out.append(launch_inputs(gather(scene, idx_s), o, tile_dirs[sparse_ids],
                             counts[sparse_ids]))
    return out


def live_counts(inp) -> np.ndarray:
    return np.minimum(inp[5].cpu().numpy().astype(np.float64), inp[0].shape[1])


def is_aniso(inp) -> bool:
    return inp[1].dim() == 3          # invd (B,N,3), not sigma (B,N)


def fwd_ops(inp, erf_name: str = "as5", exp_name: str = "exact") -> tuple[float, float]:
    """(FP32 instructions, SFU operations) of the forward's live work: 5
    erf taps per live (p, q, ray), one base erf and 6 exps per live (q, ray),
    and for anisotropic rows their per-(row, ray) prep; each tap and exp as
    the stack's erf and exp cost (ERF_TAP_OPS, EXP_OPS)."""
    c, r = live_counts(inp), inp[4].shape[2]
    taps = float(np.sum(5 * c * c + c) * r)
    exps = float(np.sum(6 * c) * r)
    preps = float(np.sum(c) * r) if is_aniso(inp) else 0.0
    (tap_f, tap_s), (exp_f, exp_s) = ERF_TAP_OPS[erf_name], EXP_OPS[exp_name]
    tap_f += exp_name == "spline"     # T's exponent summed term by term
    return (tap_f * taps + exp_f * exps + PREP_FP32 * preps,
            tap_s * taps + exp_s * exps + PREP_SFU * preps)


def bwd_ops(inp, recompute: bool, erf_name: str = "as5",
            exp_name: str = "exact") -> tuple[float, float]:
    """(FP32 instructions, SFU operations) of a backward's live work; the
    recompute backward also redoes the forward's pass A (fwd_ops of the
    stack). The pair pass's taps are as5's for every erf but as3 (the erf's
    pair); the timed stacks' backwards are counted as as5's. Anisotropic
    rows add their prep and chain per live (row, ray)."""
    c, r = live_counts(inp), inp[4].shape[2]
    pairs, rows = float(np.sum(c * c) * r), float(np.sum(c) * r)
    fp32 = BWD_PAIR_FP32 * pairs + BWD_ROW_FP32 * rows
    sfu = BWD_PAIR_SFU * pairs + BWD_ROW_SFU * rows
    if is_aniso(inp):
        fp32 += (PREP_FP32 + CHAIN_FP32) * rows
        sfu += (PREP_SFU + CHAIN_SFU) * rows
    if recompute:
        f, s = fwd_ops(inp, erf_name, exp_name)
        if is_aniso(inp):         # the prep is counted once
            f, s = f - PREP_FP32 * rows, s - PREP_SFU * rows
        fp32, sfu = fp32 + f, sfu + s
    return fp32, sfu


def scene_bytes(inp) -> int:
    """Bytes of the scene inputs and the rays (each read once): per row oc,
    sigma (or invd, 3), mag, albedo."""
    b, n = inp[2].shape
    per_row = 10 if is_aniso(inp) else 8
    return 4 * (b * n * per_row + b * 3 * inp[4].shape[2] + b)


def bound(fp32: float, sfu: float, nbytes: float, clock_mhz: float, n_sm: int) -> dict:
    t_fp32 = fp32 / FP32_INSTR_PER_S
    t_sfu = sfu / (SFU_PER_CLOCK_PER_SM * n_sm * clock_mhz * 1e6)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t = max(t_fp32, t_sfu, t_bytes)
    return {"bound_ms": t * 1e3, "fp32_bound_ms": t_fp32 * 1e3, "sfu_bound_ms": t_sfu * 1e3,
            "bytes_bound_ms": t_bytes * 1e3,
            "bound_by": "bytes" if t == t_bytes else "operations"}


def sass_loops(text: str) -> dict:
    """Per device function of `cuobjdump -sass` output: its instruction
    count and its hot loop, the innermost loop (a backward branch's body
    holding no other loop) with the most MUFU (SFU) instructions: its
    instructions, MUFU instructions by kind, and instructions per MUFU.RCP
    (one per erf tap: the A&S reciprocal)."""
    funcs, ins = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            ins = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and ins is not None:  # (address, instruction without its predicate)
            ins.append((int(m.group(1), 16), re.sub(r"^@!?U?P\w+\s+", "", m.group(2))))
    out = {}
    for name, ins in funcs.items():
        at = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (_, op) in enumerate(ins):
            m = re.match(r"BRA\S* 0x([0-9a-f]+)", op)
            t = at.get(int(m.group(1), 16)) if m else None
            if t is not None and t <= i:
                loops.append((t, i))
        # a loop's body holds no branch back past its head (that would be a
        # jump back into an enclosing loop from code placed after it)
        loops = [(t, i) for t, i in loops
                 if not any(t < i2 < i and t2 < t for t2, i2 in loops)]
        inner = [(t, i) for t, i in loops
                 if not any((t2, i2) != (t, i) and t <= t2 and i2 <= i for t2, i2 in loops)]
        best = None
        for t, i in inner:
            ops = [op.split()[0] for _, op in ins[t:i + 1]]
            mufu = {}
            for o in ops:
                if o.startswith("MUFU"):
                    mufu[o] = mufu.get(o, 0) + 1
            if best is None or sum(mufu.values()) > sum(best["mufu"].values()):
                rcp = mufu.get("MUFU.RCP", 0)
                best = {"instructions": len(ops), "mufu": mufu,
                        "per_rcp": len(ops) / rcp if rcp else None}
        out[name] = {"instructions": len(ins), "hot_loop": best}
    return out


def kernel_resources_phase() -> None:
    """Registers, spills, shared memory and resident blocks per SM of every
    device function that a library reports (ops.kernels.kernel_resources,
    at the main paths' 128 rays and 32 staged rows), and the hot loops of
    the erf-tap kernels in the built SASS (cuobjdump -sass)."""
    import shutil

    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.utils import nvcc

    res = kernels.kernel_resources(128, 32)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    sass = {}
    for source in sorted({k.source for k in kernels.KERNELS}):
        lib = nvcc.library_path(source)
        run = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                             timeout=300)
        if run.returncode != 0:
            sass[source.name] = f"cuobjdump failed: {run.stderr[-500:]}"
            continue
        for mangled, v in sass_loops(run.stdout).items():
            # the erf-tap kernels' as5/exact instantiations (template
            # arguments ERF 0, EXP 0; the p side's EXP 0 alone), as the main
            # paths run them
            if ("kernel" not in mangled or not re.search(r"GeoELi0E(Li0E|E)", mangled)
                    or v["hot_loop"] is None):
                continue
            name = mangled
            if os.path.exists(filt):
                name = subprocess.run([filt, mangled], capture_output=True, text=True,
                                      timeout=60).stdout.strip() or mangled
            sass[f"{source.name}: {name}"] = v
    over = [r["kernel"] for r in res if r["local_bytes"]]
    # every instantiation of csrc/chunked.cu (all erf/exp names), from the
    # ptxas report in its build log: stack frame and spill bytes
    chunked = [k.source for k in kernels.KERNELS if k.source.name == "chunked.cu"][0]
    frames = re.findall(r"Compiling entry function '(\S+)'.*?(\d+) bytes stack frame, "
                        r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        nvcc.build_log(chunked), re.S)
    frames = [(f, [int(v) for v in vals]) for f, *vals in frames if "kernel" in f]
    local = {f: vals for f, vals in frames if any(vals)}
    by_source = {s.name: [k.name for k in kernels.KERNELS if k.source == s]
                 for s in sorted({k.source for k in kernels.KERNELS})}
    emit("kernel_resources", functions=res, sass=sass, spilling=over,
         chunked_instantiations=len(frames), chunked_local_bytes=local,
         kernels_by_source=by_source)
    check(not over, f"a device function uses local memory: {over}")
    check(bool(frames) and not local, f"a chunked kernel uses local memory: {local}")


def compare_train_kernels(inp, dcol, erf_name="as5", exp_name="exact") -> dict:
    """The three training kernels against their plain versions on `inp`:
    per output, max |kernel - plain| / max |plain|; also both backwards
    against each other, and the absolute max differences."""
    import torch

    from sgrt_tpu_torch.ops import cuda_kernel as ck

    pb, qb = ck._block_sizes(inp[0].shape[1])
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    colors, t = ck.fused_forward_t(*inp, pb=pb, qb=qb, **kw)
    g_t = ck.fused_backward(*inp, dcol, t, qb=qb, **kw)
    g_r = ck.fused_backward(*inp, dcol, qb=qb, **kw)
    torch.cuda.synchronize()
    ref_c, ref_t = ck.fused_forward_t_plain(*inp, **kw)
    p_t = ck.fused_backward_plain(*inp, dcol, t, **kw)
    p_r = ck.fused_backward_plain(*inp, dcol, **kw)
    names = ("doc", "dsigma", "dmag", "dalbedo", "ddirs")
    for x in (colors, t, *g_t, *g_r):
        check(bool(torch.isfinite(x).all()), f"a training kernel's output is not finite "
                                             f"({erf_name}/{exp_name})")
    dead = torch.arange(inp[0].shape[1], device=t.device)[None, :] >= inp[5][:, None].long()
    check(bool((t.permute(0, 2, 1, 3)[dead] == 0).all()), "T is not 0 on dead rows")
    rel = {"fused_fwd_t": {"colors": rel_err(colors, ref_c), "T": rel_err(t, ref_t)},
           "fused_bwd_t": {n: rel_err(a, b) for n, a, b in zip(names, g_t, p_t)},
           "fused_bwd": {n: rel_err(a, b) for n, a, b in zip(names, g_r, p_r)},
           "bwd_t_vs_bwd": {n: rel_err(a, b) for n, a, b in zip(names, g_t, g_r)}}
    absd = {"fused_fwd_t": max(float((colors - ref_c).abs().max()),
                               float((t - ref_t).abs().max())),
            "fused_bwd_t": max(float((a - b).abs().max()) for a, b in zip(g_t, p_t)),
            "fused_bwd": max(float((a - b).abs().max()) for a, b in zip(g_r, p_r))}
    over = [f"{k}.{o}: {v:.3g}" for k, d in rel.items() for o, v in d.items()
            if v > (DOC_REL if o == "doc" else TRAIN_REL)]
    return {"rel": rel, "abs": absd, "over_tolerance": over + backwards_differ(rel)}


def compare_fused_forwards(inp, erf_name="as5", exp_name="exact") -> dict:
    """Kernels 1-2 (the fused forward and forward-with-T) against their
    plain versions on `inp`: colors and T within KERNEL_ATOL absolute and
    within the float64 gate (gate_vs_f64); the two forwards' colors equal
    bit for bit (T is rounded alike whether or not it is stored), T zero
    past the count."""
    import torch

    from sgrt_tpu_torch.ops import cuda_kernel as ck

    pb, qb = ck._block_sizes(inp[0].shape[1])
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    colors = ck.fused_forward(*inp, pb=pb, qb=qb, **kw)
    colors_t, t = ck.fused_forward_t(*inp, pb=pb, qb=qb, **kw)
    torch.cuda.synchronize()
    for x in (colors, colors_t, t):
        check(bool(torch.isfinite(x).all()), f"a fused forward's output is not finite "
                                             f"({erf_name}/{exp_name})")
    dead = torch.arange(inp[0].shape[1], device=t.device)[None, :] >= inp[5][:, None].long()
    check(bool((t.permute(0, 2, 1, 3)[dead] == 0).all()), "fused T is not 0 on dead rows")
    t0 = time.perf_counter()
    ref_c, ref_t = ck.fused_forward_t_plain(*inp, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    f64 = [x.double() if x.is_floating_point() else x for x in inp]
    f64_c, f64_t = ck.fused_forward_t_plain(*f64, **kw)
    outs = {ck.FUSED_FWD.name: {"colors": (colors, ref_c, f64_c)},
            ck.FUSED_FWD_T.name: {"colors": (colors_t, ref_c, f64_c), "T": (t, ref_t, f64_t)}}
    rel, vs_f64, absd, over = gate_vs_f64(outs)
    over += [f"{k}: {v:.3g} from its plain version (atol {KERNEL_ATOL})"
             for k, v in absd.items() if v > KERNEL_ATOL]
    if not torch.equal(colors, colors_t):
        over.append(f"fwd vs fwd_t colors: {rel_err(colors, colors_t):.3g} (must be equal)")
    return {"rel": rel, "vs_f64": vs_f64, "abs": absd, "over_tolerance": over,
            "plain_ms": plain_ms,
            "shape": {"B": inp[0].shape[0], "N": inp[0].shape[1], "R": inp[4].shape[2],
                      "pb": pb, "qb": qb, "max_count": int(inp[5].max())}}


def backwards_differ(rel) -> list:
    """The recompute backward redoes the forward's pass A with the same code
    and block sizes, so it is the exact VJP of the forward that ran: its
    gradients must equal the saved-T backward's bit for bit (every
    "..bwd_t_vs_bwd" entry of rel)."""
    return [f"{k}.{o}: {v:.3g} (must be 0)" for k, d in rel.items()
            if k.endswith("bwd_t_vs_bwd") for o, v in d.items() if v != 0]


def one_chunk_parts(part_ms) -> dict:
    """The device ms of a one-chunk backward's launches by name (part_ms of
    a backward of csrc/chunked.cu at C = 1): the recompute's forward-with-T
    (T), p side, db sum, q side, the row and ddirs kernels, and their sum."""
    pm = part_ms.tolist()
    names = ("T_ms", "p_side_ms", "db_sum_ms", "q_side_ms", "rows_ddirs_ms")
    return {**dict(zip(names, pm)), "sum_ms": sum(pm)}


def forwards_vs_chunked(fused, chunked, views) -> dict:
    """The fused forwards of one row geometry (forward, forward-with-T)
    beside the chunked route's at one chunk, on each view: the chunked ones
    on the view's rows padded with inert rows to the next multiple of 128
    (their chunk contract; the counts are the view's, so both sweep the
    same live rows). Each timed over 5 calls; the max abs difference of the
    colors, and whether T is equal on the view's rows. fused, chunked: each
    route's (forward, forward_t); views: name -> launch inputs."""
    import torch

    from sgrt_tpu_torch.ops import cuda_kernel as ck

    (f_fwd, f_fwd_t), (c_fwd, c_fwd_t) = fused, chunked
    out = {}
    for name, inp in views.items():
        b, n = inp[2].shape
        n_c = -(-n // 128) * 128
        wide = [torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, n_c - n), value=v)
                .contiguous() for x, v in zip(inp[:4], (0.0, 1.0, 0.0, 0.0))] + list(inp[4:])
        pb, qb = ck._block_sizes(n)
        runs = {"fused_fwd": lambda: f_fwd(*inp, pb=pb, qb=qb),
                "chunked_fwd_C1": lambda: c_fwd(*wide, ck=n_c, pb=pb, qb=qb),
                "fused_fwd_t": lambda: f_fwd_t(*inp, pb=pb, qb=qb),
                "chunked_fwd_t_C1": lambda: c_fwd_t(*wide, ck=n_c, pb=pb, qb=qb)}
        res = {k: fn() for k, fn in runs.items()}
        torch.cuda.synchronize()
        t_f, t_c = res["fused_fwd_t"][1], res["chunked_fwd_t_C1"][1][:, :, :n]
        out[name] = {
            "shape": {"B": b, "N": n, "N_chunked": n_c, "R": inp[4].shape[2], "pb": pb,
                      "qb": qb, "max_count": int(inp[5].max())},
            "ms": {k: time_cuda(fn, iters=5, warmup=1) for k, fn in runs.items()},
            "colors_max_abs_diff": {
                "fwd": float((res["fused_fwd"] - res["chunked_fwd_C1"]).abs().max()),
                "fwd_t": float((res["fused_fwd_t"][0] - res["chunked_fwd_t_C1"][0])
                               .abs().max())},
            "T_equal": bool(torch.equal(t_f, t_c)),
            "T_max_abs_diff": float((t_f - t_c).abs().max())}
        del res, t_f, t_c
    return out


def fused_vs_chunked_phase(phase: str, dev, smi: str, fused, chunked, scene, view, o,
                           tile_dirs, bucket, tiles, dense_in, forwards=None,
                           **extra) -> None:
    """The fused backwards of one row geometry (csrc/chunked.cu's backward
    at one chunk of the view's N rows) beside the chunked route's at one
    chunk, on a train step's view: the fused ones at its capacity, the
    chunked ones on the same tiles gathered at the next multiple of 128 rows
    (their chunk contract); each timed over 5 calls, with its parts. Also
    whether the chunked forward-with-T at one chunk writes the fused
    forward-with-T's T bit for bit, at qb 16 and 32 and pb 8 and 16 (the
    chunked forward ignores pb): the recompute backward's T is that
    forward's, so the two fused backwards' gradients are equal bit for bit
    only if it does. fused, chunked: each route's (forward_t, backward,
    saved-T kernel, recompute kernel); forwards, if given, the arguments
    of forwards_vs_chunked; extra is printed beside."""
    import torch

    from sgrt_tpu_torch.ops import cuda_kernel as ck

    f_fwd_t, f_bwd, f_kt, f_kr = fused
    c_fwd_t, c_bwd, c_kt, c_kr = chunked
    n = dense_in[0].shape[1]
    n_c = -(-n // 128) * 128
    (wide,) = bucket_launches(scene, view, o, tile_dirs,
                              bucket._replace(n_dense=0, cap_dense=n_c, cap_sparse=n_c), tiles)
    check(wide[0].shape[1] == n_c and torch.equal(wide[5], dense_in[5]),
          "the view gathered at the chunked capacity holds other tiles")
    g = torch.Generator().manual_seed(90)
    dcol = torch.randn((dense_in[0].shape[0], 3, dense_in[4].shape[2]), generator=g).to(dev)
    pb, qb = ck._block_sizes(n)
    t_f = f_fwd_t(*dense_in, pb=pb, qb=qb)[1]
    t_w = c_fwd_t(*wide, ck=n_c, pb=pb, qb=qb)[1]

    out = {}
    for name, fn in (
            (f_kt.name, lambda pm: f_bwd(*dense_in, dcol, t_f, qb=qb, part_ms=pm)),
            (f_kr.name, lambda pm: f_bwd(*dense_in, dcol, qb=qb, part_ms=pm)),
            (f"{c_kt.name}_C1", lambda pm: c_bwd(*wide, dcol, t_w, ck=n_c, qb=qb, part_ms=pm)),
            (f"{c_kr.name}_C1", lambda pm: c_bwd(*wide, dcol, ck=n_c, qb=qb, part_ms=pm))):
        part_ms = torch.zeros(5)
        fn(part_ms)
        out[name] = {"ms": time_cuda(lambda: fn(None), iters=5, warmup=1),
                     "parts": one_chunk_parts(part_ms)}
    same_t = {}
    for qb_t in (16, 32):
        for pb_t in (8, 16):
            c_f, t_fused = f_fwd_t(*wide, pb=pb_t, qb=qb_t)
            c_c, t_c = c_fwd_t(*wide, ck=n_c, pb=pb_t, qb=qb_t)
            torch.cuda.synchronize()
            same_t[f"qb{qb_t}_pb{pb_t}"] = {
                "T_equal": bool(torch.equal(t_c, t_fused)),
                "T_elements_differing": int((t_c != t_fused).sum()),
                "T_max_abs_diff": float((t_c - t_fused).abs().max()),
                "colors_equal": bool(torch.equal(c_c, c_f))}
    if forwards is not None:
        extra["forwards"] = forwards_vs_chunked(*forwards)
    emit(phase, shape={"B": dense_in[0].shape[0], "N": n, "N_chunked": n_c,
                       "R": dense_in[4].shape[2], "qb": qb, "max_count": int(dense_in[5].max())},
         backwards=out, chunked_fwd_t_vs_fused_fwd_t=same_t, **extra, power_limit=smi)


def train_phases(dev, smi: str, clock_mhz: float, n_sm: int, obj: str,
                 fused_vs_chunked: bool = False) -> list:
    """The training path: shapes, kernels vs plain, fit_cli, the fused
    forwards against their plain versions and float64 at the step's
    launches, the north-star train step (saved-T and recompute), a profile
    of two steps, and the kernels' times; with fused_vs_chunked (--only
    train) also train_fused_vs_chunked. Returns the kernel line's entries
    of its kernels."""
    import torch

    from sgrt_tpu_torch import fit_cli
    from sgrt_tpu_torch.models.gaussians import scene_from_vertices
    from sgrt_tpu_torch.ops import cuda_chunked as cc
    from sgrt_tpu_torch.ops import cuda_kernel as ck
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for
    from sgrt_tpu_torch.ops.frame import (orbit_camera, probe_buckets, probe_capacity,
                                          render_orbit_frame)
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.ops.scheduler import calibrate_cost_model
    from sgrt_tpu_torch.ops.tiling import gather_tiles, tile_indices
    from sgrt_tpu_torch.parallel.fit import adam, init_state, make_frame_train_step
    from sgrt_tpu_torch.utils import nvcc

    S = TRAIN_SIZE
    scene = scene_from_vertices(smoke_points(), device=dev)

    # 1. train shapes: bench.py's capacity and bucket probes
    capacity = max(64, int(probe_capacity(scene, ANGLES, OFFSET, FOCAL, TRAIN_TILES) * 1.3))
    cap_pad, _ = tile_renderer_for(capacity)
    t0 = time.perf_counter()
    bucket = probe_buckets(scene, ANGLES, OFFSET, FOCAL, TRAIN_TILES, margin=1.3)
    probe_s = time.perf_counter() - t0
    emit("train_shapes", size=S, tiles=list(TRAIN_TILES), capacity=capacity,
         padded_capacity=cap_pad, bucket_cfg=bucket._asdict(),
         cost_model=calibrate_cost_model(dev), probe_buckets_seconds=probe_s)

    # 2. kernels vs plain at the full padded capacity, camera at 30 degrees
    cam = orbit_camera(30.0, OFFSET, FOCAL, S, S, device=dev)
    o, dirs = cam.rays()
    tile_dirs = _tile_rays(dirs, S, S, TRAIN_TILES)
    idx, counts = tile_indices(scene, cam.view_matrix, TRAIN_TILES, cap_pad, focal_length=FOCAL)
    check(int(counts.max()) <= cap_pad, "the 30-degree view overflows the probed capacity")
    full = launch_inputs(gather_tiles(scene, idx), o, tile_dirs, counts)
    cnt = full[5].cpu().numpy()
    rng = np.random.default_rng(1)

    def pick(c, k):
        dense = int(np.argmax(c))
        live = [i for i in np.flatnonzero(c > 0) if i != dense]
        return [dense] + sorted(rng.choice(live, size=min(k, len(live)), replace=False).tolist())

    def cotangent(inp, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn((inp[0].shape[0], 3, inp[4].shape[2]), generator=g).to(dev)

    sel = torch.tensor(pick(cnt, 31), device=dev)
    sub = [t[sel].contiguous() for t in full]
    # untiled: B = 1, 256 seeded Gaussians, 1000 seeded rays of the frame's
    # central 96x96 pixels (8 ray blocks, the last partial)
    g_idx = torch.tensor(np.sort(rng.choice(scene.n, 256, replace=False)), device=dev)
    lo, hi = S * 5 // 16, S * 11 // 16
    yy, xx = np.meshgrid(np.arange(lo, hi), np.arange(lo, hi), indexing="ij")
    r_idx = torch.tensor(rng.choice((yy * S + xx).ravel(), min(1000, yy.size), replace=False),
                         device=dev)
    sc = scene.replace(mu=scene.mu[g_idx], sigma=scene.sigma[g_idx],
                       magnitude=scene.magnitude[g_idx], albedo=scene.albedo[g_idx])
    untiled = launch_inputs(sc.replace(**{f: getattr(sc, f)[None] for f in
                                          ("mu", "sigma", "magnitude", "albedo")}),
                            o, dirs[r_idx][None], torch.tensor([256], device=dev))
    # 256-ray tiles: fit_cli's --tiles 16 at 256^2
    idx16, counts16 = tile_indices(scene, cam.view_matrix, 16, 4096, focal_length=FOCAL)
    cap16, _ = tile_renderer_for(int(counts16.max()))
    full16 = launch_inputs(gather_tiles(scene, idx16[:, :cap16]), o, _tile_rays(dirs, S, S, 16),
                           counts16)
    sel16 = torch.tensor(pick(full16[5].cpu().numpy(), 7), device=dev)
    tiles256 = [t[sel16].contiguous() for t in full16]
    cases = {"32_tiles": (sub, "as5", "exact"), "one_tile_as3_fast": ([t[:1] for t in sub],
                                                                     "as3", "fast"),
             **{f"one_tile_{e}_{x}": ([t[:1] for t in sub], e, x) for e, x in APPROX_STACKS},
             "untiled_B1": (untiled, "as5", "exact"), "256_ray_tiles": (tiles256, "as5", "exact")}
    results = {}
    t0 = time.perf_counter()
    for i, (name, (inp, e, x)) in enumerate(cases.items()):
        results[name] = compare_train_kernels(inp, cotangent(inp, 10 + i), e, x)
        results[name]["shape"] = {"B": inp[0].shape[0], "N": inp[0].shape[1],
                                  "R": inp[4].shape[2], "max_count": int(inp[5].max())}
    emit("train_kernels_vs_plain", tolerance_rel=TRAIN_REL, tolerance_rel_doc=DOC_REL,
         seconds=time.perf_counter() - t0, densest_count=int(cnt.max()),
         live_tiles=int((cnt > 0).sum()), cases=results)
    over = [f"{name}: {o}" for name, r in results.items() for o in r["over_tolerance"]]
    check(not over, f"a training kernel disagrees with its plain version: {over}")

    # 3. main path: fit_cli fits the cloud for 10 steps at 256^2
    png = os.path.join(os.path.dirname(obj), "fit.png")
    argv = ["-f", obj, "-w", str(S), "--height", str(S), "--tiles", "16", "--steps", "10",
            "--views", "4", "--out", png]
    stdout, stderr = io.StringIO(), io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = fit_cli.main(argv)
    fit_s = time.perf_counter() - t0
    fit_launches = {k.name: k.launches for k in kernels.KERNELS}
    out = stdout.getvalue()
    check(rc == 0, f"fit_cli exited {rc}: {stderr.getvalue()[-2000:]}")
    check(fit_launches[ck.FUSED_FWD.name] > 0 and fit_launches[ck.FUSED_FWD_T.name] > 0
          and fit_launches[ck.FUSED_BWD_T.name] > 0,
          f"a kernel of the training path was not launched by fit_cli: {fit_launches}")
    check("warning" not in out, f"fit_cli warned: {out[-2000:]}")
    losses = [float(v) for v in re.findall(r"loss ([^\s]+)", out)]
    check(len(losses) == 10 and all(np.isfinite(losses)), f"fit_cli losses: {out[-2000:]}")
    img = read_png_rgba(png)
    check(img.shape == (S, S, 4) and int(img[..., :3].max()) > 0, "fit_cli's PNG is black")
    emit("train_main_path", argv=argv[2:], rc=rc, launches=fit_launches, losses=losses,
         seconds=fit_s, lines=[ln for ln in out.splitlines()
                               if ln.startswith(("scene", "10 steps", "max"))],
         mean_rgb=round(float(img[..., :3].mean()), 3))

    # 4. the north-star train step (bench.py:103-150), saved-T and recompute
    target, ovf = render_orbit_frame(scene, 35.0, OFFSET, FOCAL, width=S, height=S,
                                     tiles=TRAIN_TILES, capacity=capacity, backend="kernel",
                                     bucket_cfg=bucket)
    check(int(ovf) == 0, "the target frame overflowed")

    def run_steps(n):
        step = make_frame_train_step(width=S, height=S, tiles=TRAIN_TILES,
                                     capacity=capacity, backend="kernel", erf_name="as5",
                                     bucket_cfg=bucket)
        state = init_state(scene, adam(1e-3))
        state, loss, ovf = step(state, cam.view_matrix, o, dirs, target)
        losses, ovfs = [loss], [ovf]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            state, loss, ovf = step(state, cam.view_matrix, o, dirs, target)
            losses.append(loss)
            ovfs.append(ovf)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        launches = {k.name: k.launches for k in kernels.KERNELS}
        losses = [float(v) for v in losses]
        check(all(int(v) == 0 for v in ovfs), "a train step overflowed")
        check(all(np.isfinite(losses)), f"train-step losses not finite: {losses}")
        return {"step_ms": dt * 1e3, "rays_per_s": S * S / dt, "losses": losses,
                "launches": launches, "launches_per_step": {k: v / n for k, v in launches.items()},
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}, step, state

    per_bucket = bucket_launches(scene, cam.view_matrix, o, tile_dirs, bucket)
    # the fused forwards at the step's launches, against their plain
    # versions and float64
    fwd_cases = {f"bucket{i}": compare_fused_forwards(inp) for i, inp in enumerate(per_bucket)}
    emit("train_forwards_vs_plain", atol=KERNEL_ATOL, cases=fwd_cases)
    over = [f"{name}: {o}" for name, c in fwd_cases.items() for o in c["over_tolerance"]]
    check(not over, f"a fused forward disagrees with its plain version at the step's view: {over}")
    residual = sum(ck.save_t_bytes(i[0].shape[0], i[0].shape[1], i[4].shape[2])
                   for i in per_bucket)
    saved, step, state = run_steps(TRAIN_STEPS)
    check(saved["losses"][-1] < saved["losses"][0],
          f"the train step's loss did not fall: {saved['losses']}")
    check(saved["launches"][ck.FUSED_BWD_T.name] > 0, "the saved-T backward did not run")
    budget = ck.SAVE_T_MAX_BYTES
    ck.SAVE_T_MAX_BYTES = 0          # a residual over budget: the recompute backward
    try:
        recompute, _, _ = run_steps(3)
    finally:
        ck.SAVE_T_MAX_BYTES = budget
    recompute_launches = recompute["launches"]
    check(recompute_launches[ck.FUSED_BWD.name] > 0
          and recompute_launches[ck.FUSED_BWD_T.name] == 0,
          f"the recompute backward did not run: {recompute_launches}")
    np.testing.assert_allclose(recompute["losses"], saved["losses"][:4], rtol=1e-4)
    emit("train_step", size=S, tiles=list(TRAIN_TILES), capacity=capacity,
         bucket_cfg=bucket._asdict(), steps=TRAIN_STEPS,
         backward_chosen="saved-T" if residual <= budget else "recompute",
         residual_bytes=residual, save_t_max_bytes=budget, saved_t=saved,
         recompute=recompute, power_limit=smi)
    emit("train_profile", steps=2, **profile_device(
        lambda _: step(state, cam.view_matrix, o, dirs, target), range(2)))

    # 5. times at the train step's launch shapes, per train step
    dcols = [cotangent(inp, 20 + i) for i, inp in enumerate(per_bucket)]
    blocks = [ck._block_sizes(inp[0].shape[1]) for inp in per_bucket]
    ts = [ck.fused_forward_t(*inp, pb=pb, qb=qb)[1] for inp, (pb, qb) in zip(per_bucket, blocks)]
    runs = {
        ck.FUSED_FWD_T.name: [lambda i=i, b=b: ck.fused_forward_t(*i, pb=b[0], qb=b[1])
                              for i, b in zip(per_bucket, blocks)],
        ck.FUSED_BWD_T.name: [lambda i=i, b=b, d=d, t=t: ck.fused_backward(*i, d, t, qb=b[1])
                              for i, b, d, t in zip(per_bucket, blocks, dcols, ts)],
        ck.FUSED_BWD.name: [lambda i=i, b=b, d=d: ck.fused_backward(*i, d, qb=b[1])
                            for i, b, d in zip(per_bucket, blocks, dcols)],
    }
    ms = {k: sum(time_cuda(f, iters=5, warmup=1) for f in fs) for k, fs in runs.items()}
    # kernels 3-4 part by part (csrc/chunked.cu at one chunk): the
    # recompute's T, p side, db sum, q side and the row and ddirs kernels by
    # CUDA events, one call each, summed over the train step's launches
    parts = {}
    for k, t_args in ((ck.FUSED_BWD_T, ts), (ck.FUSED_BWD, [None] * len(ts))):
        pm = torch.zeros(5)
        for i, b, d, t in zip(per_bucket, blocks, dcols, t_args):
            one = torch.zeros(5)
            ck.fused_backward(*i, d, t, qb=b[1], part_ms=one)
            pm += one
        parts[k.name] = one_chunk_parts(pm)
    plain = {ck.FUSED_FWD_T.name: (sum(time_cuda(lambda i=i: ck.fused_forward_t_plain(*i),
                                                 iters=1, warmup=0) for i in per_bucket),
                                   "the train step's launches")}
    d_sub = cotangent(sub, 30)
    t_sub = ck.fused_forward_t(*sub)[1]
    plain[ck.FUSED_BWD_T.name] = (time_cuda(
        lambda: ck.fused_backward_plain(*sub, d_sub, t_sub), iters=1, warmup=0),
        "the 32-tile subset of phase 2")
    plain[ck.FUSED_BWD.name] = (time_cuda(
        lambda: ck.fused_backward_plain(*sub, d_sub), iters=1, warmup=0),
        "the 32-tile subset of phase 2")
    # bytes, each input read once and each output written once: the scene
    # and rays; colors (B,3,R) and T out of the forward; dcol and T in, the
    # five gradients out of a backward
    t_bytes = sum(ck.save_t_bytes(i[0].shape[0], i[0].shape[1], i[4].shape[2])
                  for i in per_bucket)
    rays3 = sum(4 * 3 * i[0].shape[0] * i[4].shape[2] for i in per_bucket)
    rows8 = sum(4 * 8 * i[0].shape[0] * i[0].shape[1] for i in per_bucket)
    scene_b = sum(scene_bytes(i) for i in per_bucket)
    nbytes = {ck.FUSED_FWD_T.name: scene_b + rays3 + t_bytes,
              ck.FUSED_BWD_T.name: scene_b + 2 * rays3 + rows8 + t_bytes,
              ck.FUSED_BWD.name: scene_b + 2 * rays3 + rows8}
    ops = {ck.FUSED_FWD_T.name: [fwd_ops(i) for i in per_bucket],
           ck.FUSED_BWD_T.name: [bwd_ops(i, False) for i in per_bucket],
           ck.FUSED_BWD.name: [bwd_ops(i, True) for i in per_bucket]}
    times = {}
    for k in runs:
        fp32 = sum(a for a, _ in ops[k])
        sfu = sum(b for _, b in ops[k])
        times[k] = {"ms": ms[k], "launches_per_step": saved["launches_per_step"][k]
                    if k != ck.FUSED_BWD.name else recompute["launches_per_step"][k],
                    "live_pairs": sum(float(np.sum(live_counts(i) ** 2) * i[4].shape[2])
                                      for i in per_bucket),
                    "fp32_instr": fp32, "sfu_ops": sfu, "bytes": nbytes[k],
                    **bound(fp32, sfu, nbytes[k], clock_mhz, n_sm),
                    "plain_ms": plain[k][0], "plain_shape": plain[k][1],
                    "library_ms": "n/a: no single PyTorch call computes it",
                    **({"parts": parts[k]} if k in parts else {})}
    emit("train_times", shapes=[{"B": i[0].shape[0], "N": i[0].shape[1], "R": i[4].shape[2],
                                 "max_count": int(i[5].max())} for i in per_bucket],
         kernels=times, power_limit=smi)

    launches = {ck.FUSED_FWD_T.name: fit_launches[ck.FUSED_FWD_T.name],
                ck.FUSED_BWD_T.name: fit_launches[ck.FUSED_BWD_T.name],
                ck.FUSED_BWD.name: recompute_launches[ck.FUSED_BWD.name]}
    checked = [*results.values(), *fwd_cases.values()]
    entries = []
    for k in (ck.FUSED_FWD_T, ck.FUSED_BWD_T, ck.FUSED_BWD):
        entries.append({
            "name": k.name, "route": k.route,
            "source": str(k.source.relative_to(nvcc.CSRC_DIR.parents[1])),
            "replaces": k.replaces,
            "launches": launches[k.name],
            "max_abs_err": max(r["abs"][k.name] for r in checked if k.name in r["abs"]),
            "max_rel_err": max(max(r["rel"][k.name].values()) for r in checked
                               if k.name in r["rel"]),
            "ms": times[k.name]["ms"], "plain_ms": times[k.name]["plain_ms"],
            "bound_ms": times[k.name]["bound_ms"], "bound_by": times[k.name]["bound_by"],
            "library_ms": None})
    if fused_vs_chunked:
        fused_vs_chunked_phase(
            "train_fused_vs_chunked", dev, smi,
            (ck.fused_forward_t, ck.fused_backward, ck.FUSED_BWD_T, ck.FUSED_BWD),
            (cc.chunked_forward_t, cc.chunked_backward, cc.CHUNKED_BWD_T, cc.CHUNKED_BWD),
            scene, cam.view_matrix, o, tile_dirs, bucket, TRAIN_TILES, per_bucket[0],
            forwards=((ck.fused_forward, ck.fused_forward_t),
                      (cc.chunked_forward, cc.chunked_forward_t),
                      {"serving_frame0": serving_frame0(scene, dev)[2], "step": per_bucket[0]}),
            step_peak_memory_gb={"saved_t": saved["peak_memory_gb"],
                                 "recompute": recompute["peak_memory_gb"]})
    return entries


def per_tile(fn, inp, *extra):
    """fn over one tile at a time, outputs joined on the tile axis: the
    plain versions pad every tile of a call to the largest count, so one
    dense tile among sparse ones costs as much as all dense; tile by tile
    the cost follows the sum of count^2."""
    import torch

    outs = [fn(*[t[b:b + 1] for t in inp], *[e[b:b + 1] for e in extra])
            for b in range(inp[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(z) for z in zip(*outs))
    return torch.cat(outs)


def gate_vs_f64(outs) -> tuple:
    """outs: {kernel: {output: (kernel's, float32 plain's, float64 plain's)}}.

    The gate of thousands of rows a tile: T and every gradient subtract or
    cancel sums over a tile's rows, so float32 summation order moves them
    by about sqrt(N) ulp of those sums relative, more than a fixed
    tolerance. Each output of a kernel must be as close to the float64 run
    of the plain version as the float32 plain version is, up to a factor of
    2, or within TRAIN_REL (doc and dinvd, whose terms cancel ~|oc|/sigma
    times their size: DOC_REL) of its scale; colors also pass within
    KERNEL_ATOL absolute. Returns (rel: max |kernel - plain| / max |plain|,
    vs_f64: both against float64, abs: max |kernel - plain| per kernel,
    the outputs over the gate)."""
    rel, vs_f64, absd, over = {}, {}, {}, []
    for k, d in outs.items():
        rel[k], vs_f64[k] = {}, {}
        absd[k] = max(float((a - b).abs().max()) for a, b, _ in d.values())
        for o, (a, b, c) in d.items():
            rel[k][o] = rel_err(a, b)
            e_k, e_p = rel_err(a.double(), c), rel_err(b.double(), c)
            vs_f64[k][o] = {"kernel": e_k, "plain_f32": e_p}
            base = DOC_REL if o in ("doc", "dinvd") else TRAIN_REL
            ok = e_k <= max(base, 2 * e_p)
            if o == "colors":
                ok = ok or float((a.double() - c).abs().max()) <= KERNEL_ATOL
            if not ok:
                over.append(f"{k}.{o}: {e_k:.3g} vs float64 (plain float32 {e_p:.3g})")
    return rel, vs_f64, absd, over


def compare_chunked_kernels(inp, dcol, c_k: int, erf_name="as5", exp_name="exact",
                            rb: int = 128, with_fused_bwd: bool = False) -> dict:
    """The four chunked kernels against their plain versions on `inp`, and
    with_fused_bwd also the fused saved-T and recompute backwards (kernels
    3-4) on the same launch.

    Tolerance, derived from the data: the exponent of T subtracts sums of up
    to N terms (base and acc), so float32 summation order moves T, the
    colors and the gradients by about sqrt(N) ulp of those sums relative,
    which at the dense cell's thousands of rows exceeds the training cell's
    TRAIN_REL. So the plain version is also run in float64, and each output
    of a kernel must be as close to it as the float32 plain version is, up
    to a factor of 2, or within TRAIN_REL (colors: KERNEL_ATOL absolute;
    doc: DOC_REL) of its scale. Both backwards are held against the float64
    VJP at the float64 T (gate_vs_f64). Reported: per output, max
    |kernel - plain| / max |plain| against the float32 plain version
    ("rel"), against the float64 one for kernel and float32 plain
    ("vs_f64"), the absolute max differences against the float32 plain
    version, the saved-T and recompute backwards against each other (equal
    bit for bit, backwards_differ, as the forward's and the forward-with-T's
    colors), and the plain versions' ms (one call each, tile by tile)."""
    import torch

    from sgrt_tpu_torch.ops import cuda_chunked as cc
    from sgrt_tpu_torch.ops import cuda_kernel as ck

    kw = dict(ck=c_k, erf_name=erf_name, exp_name=exp_name)
    colors = cc.chunked_forward(*inp, rb=rb, **kw)
    colors_t, t = cc.chunked_forward_t(*inp, rb=rb, **kw)
    g_t = cc.chunked_backward(*inp, dcol, t, rb=rb, **kw)
    g_r = cc.chunked_backward(*inp, dcol, rb=rb, **kw)
    torch.cuda.synchronize()
    names = ("doc", "dsigma", "dmag", "dalbedo", "ddirs")
    for x in (colors, colors_t, t, *g_t, *g_r):
        check(bool(torch.isfinite(x).all()), f"a chunked kernel's output is not finite "
                                             f"({erf_name}/{exp_name})")
    dead = torch.arange(inp[0].shape[1], device=t.device)[None, :] >= inp[5][:, None].long()
    check(bool((t.permute(0, 2, 1, 3)[dead] == 0).all()), "chunked T is not 0 on dead rows")

    plain, plain_ms = {}, {}
    runs = {cc.CHUNKED_FWD.name: (cc.chunked_forward_plain, ()),
            cc.CHUNKED_FWD_T.name: (cc.chunked_forward_t_plain, ()),
            cc.CHUNKED_BWD_T.name: (cc.chunked_backward_plain, (dcol, t)),
            cc.CHUNKED_BWD.name: (cc.chunked_backward_plain, (dcol,))}
    for name, (fn, extra) in runs.items():
        t0 = time.perf_counter()
        plain[name] = per_tile(lambda *a: fn(*a, **kw), inp, *extra)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
    f64 = [x.double() if x.is_floating_point() else x for x in inp]
    ref_c, ref_t = per_tile(lambda *a: cc.chunked_forward_t_plain(*a, **kw), f64)
    ref_g = per_tile(lambda *a: cc.chunked_backward_plain(*a, **kw), f64, dcol.double(), ref_t)

    outs = {cc.CHUNKED_FWD.name: {"colors": (colors, plain[cc.CHUNKED_FWD.name], ref_c)},
            cc.CHUNKED_FWD_T.name: {"colors": (colors_t, plain[cc.CHUNKED_FWD_T.name][0], ref_c),
                                    "T": (t, plain[cc.CHUNKED_FWD_T.name][1], ref_t)},
            cc.CHUNKED_BWD_T.name: {n: (a, b, c) for n, a, b, c in
                                    zip(names, g_t, plain[cc.CHUNKED_BWD_T.name], ref_g)},
            cc.CHUNKED_BWD.name: {n: (a, b, c) for n, a, b, c in
                                  zip(names, g_r, plain[cc.CHUNKED_BWD.name], ref_g)}}
    if with_fused_bwd:
        # the fused backwards at the same thousands of rows a launch, against
        # the same plain and float64 VJPs (the same function)
        f_t = ck.fused_backward(*inp, dcol, t, rb=rb)
        f_r = ck.fused_backward(*inp, dcol, rb=rb)
        torch.cuda.synchronize()
        outs[ck.FUSED_BWD_T.name] = {n: (a, b, c) for n, a, b, c in
                                     zip(names, f_t, plain[cc.CHUNKED_BWD_T.name], ref_g)}
        outs[ck.FUSED_BWD.name] = {n: (a, b, c) for n, a, b, c in
                                   zip(names, f_r, plain[cc.CHUNKED_BWD.name], ref_g)}
    rel, vs_f64, absd, over = gate_vs_f64(outs)
    rel["bwd_t_vs_bwd"] = {n: rel_err(a, b) for n, a, b in zip(names, g_t, g_r)}
    if with_fused_bwd:
        rel["fused_bwd_t_vs_bwd"] = {n: rel_err(a, b) for n, a, b in zip(names, f_t, f_r)}
    over += backwards_differ(rel)
    if not torch.equal(colors, colors_t):   # T is rounded alike whether or not it is stored
        over.append(f"chunked_fwd vs chunked_fwd_t colors: {rel_err(colors, colors_t):.3g} "
                    "(must be 0)")
    for i in [i for i, c in enumerate(inp[5].tolist()) if c <= 0]:
        check(all(bool((x[i] == 0).all()) for x in (colors, colors_t, *g_t, *g_r)),
              f"a dead tile's chunked outputs are not zero ({erf_name}/{exp_name})")
    return {"rel": rel, "vs_f64": vs_f64, "abs": absd, "over_tolerance": over,
            "plain_ms": plain_ms,
            "shape": {"B": inp[0].shape[0], "N": inp[0].shape[1], "R": inp[4].shape[2],
                      "ck": c_k, "rb": rb, "max_count": int(inp[5].max())}}


def dense_phases(dev, smi: str, clock_mhz: float, n_sm: int, tmp: str) -> list:
    """The dense cell: tile grid and buckets, the chunked kernels against
    their plain versions (and kernels 1-2 on the sparse bucket's densest
    tiles), the bucketed frame and the CLI, the bucketed train step and the
    slab train step, and the chunked kernels' times (each backward's parts;
    kernel 5 at one chunk beside it at its chunk plan and the fused saved-T
    backward beside kernel 8). Returns the kernel line's entries of kernels
    5-8."""
    import torch

    from sgrt_tpu_torch import cli
    from sgrt_tpu_torch.models.gaussians import scene_from_vertices
    from sgrt_tpu_torch.ops import cuda_chunked as cc
    from sgrt_tpu_torch.ops import cuda_kernel as ck
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.frame import (auto_tile_grid, orbit_camera, probe_buckets,
                                          render_orbit_frame)
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.ops.scheduler import BucketConfig
    from sgrt_tpu_torch.parallel.fit import (adam, init_state, make_frame_train_step,
                                             make_slab_frame_train_step)
    from sgrt_tpu_torch.utils import nvcc

    S = DENSE_SIZE
    pts = sphere_points(DENSE_N)
    scene = scene_from_vertices(pts, device=dev)

    # 1. shapes: the tile grid, the buckets, and each bucket's route
    t0 = time.perf_counter()
    tiles, capacity = auto_tile_grid(scene, [DENSE_ANGLE], OFFSET, FOCAL, margin=DENSE_MARGIN,
                                     width=S, height=S)
    probed = probe_buckets(scene, [DENSE_ANGLE], OFFSET, FOCAL, tiles, margin=DENSE_MARGIN)
    bucket = BucketConfig(DENSE_N_DENSE, capacity, DENSE_CAP_SPARSE)
    routes = {}
    for name, cap in (("dense", bucket.cap_dense), ("sparse", bucket.cap_sparse)):
        chunked = cap > cc.MAX_MONOLITHIC_CAPACITY
        padded, c_k = cc.chunk_plan(cap)
        routes[name] = {"capacity": cap, "route": "chunked" if chunked else "fused",
                        "padded_capacity": cc.tile_renderer_for(cap)[0],
                        "chunk_plan": {"C": padded // c_k, "ck": c_k, "padded": padded}}
    emit("dense_shapes", scene=f"sphere({DENSE_N})", size=S, tiles=list(tiles),
         capacity=capacity, chunk_plan=dict(zip(("padded", "ck"), cc.chunk_plan(capacity))),
         bucket_cfg=bucket._asdict(), probe_buckets_pick=probed._asdict(), buckets=routes,
         seconds=time.perf_counter() - t0)

    cam = orbit_camera(DENSE_ANGLE, OFFSET, FOCAL, S, S, device=dev)
    o, dirs = cam.rays()
    tile_dirs = _tile_rays(dirs, S, S, tiles)
    per_bucket = bucket_launches(scene, cam.view_matrix, o, tile_dirs, bucket, tiles)
    dense_in = per_bucket[0]
    n_d = dense_in[0].shape[1]
    c_k = cc.chunk_plan(n_d)[1]
    check(n_d > cc.MAX_MONOLITHIC_CAPACITY, f"the dense bucket ({n_d} rows) is not chunked")

    # 2. the chunked kernels against their plain versions
    cnt = live_counts(dense_in).astype(np.int64)
    rng = np.random.default_rng(2)
    dense_tile = int(np.argmax(cnt))
    live = [i for i in np.flatnonzero(cnt > 0) if i != dense_tile]
    sel = [dense_tile] + sorted(rng.choice(live, size=min(DENSE_SUB_TILES - 1, len(live)),
                                           replace=False).tolist())
    sub = [t[torch.tensor(sel, device=dev)].contiguous() for t in dense_in]
    sub_case = f"{len(sel)}_tiles"
    # B = 1, three chunks with the last one partly live: the densest tile cut
    # or padded (inert rows: oc = -o, sigma 1, magnitude 0) to 3 chunks
    c0 = int(cnt[dense_tile])
    ck3 = -(-int(np.ceil(c0 / 2.5)) // 128) * 128
    one = [t[:1] for t in sub]
    if 3 * ck3 <= n_d:
        one3 = [t[:, :3 * ck3].contiguous() if i < 4 else t for i, t in enumerate(one)]
    else:
        pad = 3 * ck3 - n_d
        fill = [(-o).expand(1, pad, 3), torch.ones(1, pad, device=dev),
                torch.zeros(1, pad, device=dev), torch.zeros(1, pad, 3, device=dev)]
        one3 = [torch.cat([t, f], dim=1).contiguous() for t, f in zip(one[:4], fill)] + one[4:]
    dead = [t[:2].clone() for t in sub]
    dead[5][0] = 0

    def cotangent(inp, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn((inp[0].shape[0], 3, inp[4].shape[2]), generator=g).to(dev)

    near = min(range(1, len(sel)), key=lambda i: abs(int(cnt[sel[i]]) - APPROX_DENSE_COUNT))
    one_near = [t[near:near + 1] for t in sub]
    cases = {sub_case: (sub, c_k, "as5", "exact", 128),
             "B1_three_chunks_last_partial": (one3, ck3, "as5", "exact", 128),
             "dead_tile": (dead, c_k, "as5", "exact", 128),
             "two_ray_blocks": ([t[:4] for t in sub], c_k, "as5", "exact", 64),
             "one_tile_as3_fast": (one, c_k, "as3", "fast", 128),
             **{f"one_tile_{e}_{x}": (one_near, c_k, e, x, 128) for e, x in APPROX_STACKS}}
    results = {}
    t0 = time.perf_counter()
    for i, (name, (inp, kk, e, x, rb)) in enumerate(cases.items()):
        # the many-tile case also holds the fused backwards (kernels 3-4) at
        # these thousands of rows a launch to the same float64 gate
        results[name] = compare_chunked_kernels(inp, cotangent(inp, 40 + i), kk, e, x, rb,
                                                with_fused_bwd=name == sub_case)
    emit("dense_kernels_vs_plain", seconds=time.perf_counter() - t0, densest_count=c0,
         live_tiles=int((cnt > 0).sum()), cases=results)
    over = [f"{name}: {o}" for name, r in results.items() for o in r["over_tolerance"]]
    check(not over, f"a chunked kernel disagrees with its plain version: {over}")
    # the sparse bucket's launch takes the fused route (kernels 1-2): its
    # densest tiles against the plain versions and float64
    sparse_in = per_bucket[-1]
    top_s = np.argsort(-live_counts(sparse_in), kind="stable")[:SPARSE_TILES]
    sparse_case = compare_fused_forwards([t[torch.tensor(top_s.tolist(), device=dev)]
                                          .contiguous() for t in sparse_in])
    emit("dense_sparse_vs_plain", case=sparse_case)
    check(not sparse_case["over_tolerance"], "a fused forward disagrees with its plain "
          f"version on the sparse bucket: {sparse_case['over_tolerance']}")

    # 3. the bucketed frame and the CLI
    def frame():
        return render_orbit_frame(scene, DENSE_ANGLE, OFFSET, FOCAL, width=S, height=S,
                                  tiles=tiles, backend="kernel", bucket_cfg=bucket)

    kernels.reset_launch_counts()
    frame_ms, ovf = [], []
    for _ in range(3):                        # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, ov = frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        ovf.append(int(ov))
    frame_launches = {k.name: k.launches for k in kernels.KERNELS}
    check(all(v == 0 for v in ovf), f"the dense frame overflowed: {ovf}")
    check(bool(torch.isfinite(img).all()) and float(img.max()) > 0, "the dense frame is black")
    check(frame_launches[cc.CHUNKED_FWD.name] > 0,
          f"the dense frame did not launch the chunked forward: {frame_launches}")
    obj = os.path.join(tmp, "sphere.obj")
    write_obj(obj, pts)
    argv = ["-f", obj, "-w", str(S), "--height", str(S), "--tiles", "64x32", "--frames", "1",
            "-q", "-o", os.path.join(tmp, "sphere.png")]
    stdout, stderr = io.StringIO(), io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = cli.main(argv)
    cli_launches = {k.name: k.launches for k in kernels.KERNELS}
    check(rc == 0, f"the dense CLI run exited {rc}: {stderr.getvalue()[-2000:]}")
    check(cli_launches[cc.CHUNKED_FWD.name] == 1 and "overflow" not in stderr.getvalue(),
          f"the dense CLI run: {cli_launches}, {stderr.getvalue()[-2000:]}")
    png = read_png_rgba(os.path.join(tmp, "sphere.png"))
    check(int(png[..., :3].max()) > 0, "the dense CLI frame is black")
    emit("dense_frame", size=S, tiles=list(tiles), bucket_cfg=bucket._asdict(),
         frame_ms=frame_ms[1:], overflow=ovf, launches=frame_launches,
         mean_rgb=float(img.mean()), cli={"argv": argv[2:10], "rc": rc,
                                          "stdout": stdout.getvalue().strip(),
                                          "launches": cli_launches},
         power_limit=smi)

    # 4. the bucketed train step (the north-star step's shape at this cell)
    target, ov = render_orbit_frame(scene, DENSE_TARGET_ANGLE, OFFSET, FOCAL, width=S,
                                    height=S, tiles=tiles, backend="kernel", bucket_cfg=bucket)
    check(int(ov) == 0, "the dense target overflowed")
    step = make_frame_train_step(width=S, height=S, tiles=tiles, capacity=capacity,
                                 backend="kernel", bucket_cfg=bucket)
    state = init_state(scene, adam(1e-3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss, ov = step(state, cam.view_matrix, o, dirs, target)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    fields = ("mu", "sigma", "magnitude", "albedo")
    after1 = {f: getattr(state.scene, f).clone() for f in fields}
    losses, ovfs = [loss], [ov]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(2):
        state, loss, ov = step(state, cam.view_matrix, o, dirs, target)
        losses.append(loss)
        ovfs.append(ov)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 2 * 1e3
    train_launches = {k.name: k.launches for k in kernels.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    check(all(int(v) == 0 for v in ovfs), "a dense train step overflowed")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the dense train step's loss did not fall: {losses}")
    chosen = []
    for name, inp in zip(("dense", "sparse") if len(per_bucket) == 2 else ("single",),
                         per_bucket):
        b_, n_ = inp[0].shape[:2]
        chunked = n_ > cc.MAX_MONOLITHIC_CAPACITY
        nbytes = ck.save_t_bytes(b_, n_, inp[4].shape[2])
        budget = cc.SAVE_T_CHUNKED_MAX_BYTES if chunked else ck.SAVE_T_MAX_BYTES
        chosen.append({"bucket": name, "B": b_, "N": n_, "max_count": int(inp[5].max()),
                       "route": "chunked" if chunked else "fused", "t_bytes": nbytes,
                       "budget": budget, "backward": "saved-T" if nbytes <= budget
                       else "recompute"})
    prof = profile_device(lambda _: step(state, cam.view_matrix, o, dirs, target), range(1))
    emit("dense_train_step", size=S, tiles=list(tiles), bucket_cfg=bucket._asdict(),
         first_step_ms=first_ms, step_ms=step_ms, rays_per_s=S * S / (step_ms * 1e-3),
         losses=losses, backward_per_bucket=chosen, launches=train_launches,
         peak_memory_gb=peak_gb, profile_one_step=prof, power_limit=smi)

    # 5. the slab step from the same start state: the same function, one
    # launch per slab of count-sorted tiles. Its backward is the one the
    # bucketed step's chunked bucket did not take, so both chunked
    # backwards run on a main path.
    saved_taken = chosen[0]["backward"] == "saved-T"
    budget = cc.SAVE_T_CHUNKED_MAX_BYTES
    if saved_taken:
        cc.SAVE_T_CHUNKED_MAX_BYTES = 0
    try:
        slab = make_slab_frame_train_step(width=S, height=S, tiles=tiles,
                                          capacity=bucket.cap_dense, slab_tiles=DENSE_SLAB_TILES)
        st = init_state(scene, adam(1e-3))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, slab_loss, ov = slab(st, cam.view_matrix, o, dirs, target)
        torch.cuda.synchronize()
        slab_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cc.SAVE_T_CHUNKED_MAX_BYTES = budget
    slab_launches = {k.name: k.launches for k in kernels.KERNELS}
    slab_peak = torch.cuda.max_memory_allocated() / 1e9
    want_bwd = cc.CHUNKED_BWD if saved_taken else cc.CHUNKED_BWD_T
    check(int(ov) == 0, "the slab step overflowed")
    check(slab_launches[want_bwd.name] > 0, f"the slab step did not run {want_bwd.name}: "
                                            f"{slab_launches}")
    # the updated scene, held at rtol 1e-5 and atol 1e-6
    diffs, max_abs = {}, {}
    for f, want in after1.items():
        got = getattr(st.scene, f)
        diffs[f] = float(((got - want).abs() / (1e-6 + 1e-5 * want.abs())).max())
        max_abs[f] = float((got - want).abs().max())
    loss_rel = abs(float(slab_loss) - losses[0]) / abs(losses[0])
    emit("dense_slab_step", slab_tiles=DENSE_SLAB_TILES, capacity=bucket.cap_dense,
         save_t_chunked_max_bytes=0 if saved_taken else budget, step_ms=slab_ms,
         loss=float(slab_loss), bucketed_loss=losses[0], loss_rel_diff=loss_rel,
         scene_max_abs_diff=max_abs, scene_diff_over_tolerance=diffs,
         launches=slab_launches, peak_memory_gb=slab_peak,
         power_limit=smi)
    check(loss_rel <= 1e-5, f"the slab step's loss differs from the bucketed step's: {loss_rel}")
    check(all(v <= 1.0 for v in diffs.values()),
          f"the slab step's scene differs from the bucketed step's: {diffs}")

    # 6. times at the dense bucket's launch shapes, and the chunked saved-T
    # backward beside the fused one (the card's own MAX_MONOLITHIC_CAPACITY
    # is to be set from that). Beside kernel 5 at its chunk plan, kernel 5
    # at one chunk of the same rows (the fused forward's entry point)
    dcol = cotangent(dense_in, 50)
    pb, qb = ck._block_sizes(c_k)
    kw = dict(ck=c_k, pb=pb, qb=qb)
    t_d = cc.chunked_forward_t(*dense_in, **kw)[1]
    ms = {cc.CHUNKED_FWD.name: time_cuda(lambda: cc.chunked_forward(*dense_in, **kw),
                                         iters=3, warmup=1),
          cc.CHUNKED_FWD_T.name: time_cuda(lambda: cc.chunked_forward_t(*dense_in, **kw),
                                           iters=2, warmup=1)}
    one_chunk = {"kernel 5 at one chunk (the fused forward's entry point)": time_cuda(
        lambda: ck.fused_forward(*dense_in, pb=pb, qb=qb), iters=3, warmup=1)}
    # the backwards, part by part: each chunk's pass A (recompute only), p
    # side, db sum and q side and the row sums by CUDA events; a backward's
    # time is their sum
    n_chunks = n_d // c_k
    parts, names = {}, ("pass_a", "p_side", "db_sum", "q_side")
    for k, t_arg in ((cc.CHUNKED_BWD, None), (cc.CHUNKED_BWD_T, t_d)):
        part_ms = torch.zeros(4 * n_chunks + 1)
        cc.chunked_backward(*dense_in, dcol, t_arg, ck=c_k, qb=qb, part_ms=part_ms)
        pm = part_ms.tolist()
        parts[k.name] = {
            "chunks": [{f"{p}_ms": pm[4 * a + i] for i, p in enumerate(names)}
                       for a in range(n_chunks)],
            "rows_ddirs_ms": pm[-1],
            **{f"{p}_total_ms": sum(pm[4 * a + i] for a in range(n_chunks))
               for i, p in enumerate(names)}}
        ms[k.name] = sum(pm)
    g_chunked = cc.chunked_backward(*dense_in, dcol, t_d, ck=c_k, qb=qb)
    fused_bwd_ms, g_fused = time_once(lambda: ck.fused_backward(*dense_in, dcol, t_d, qb=qb))
    check(all(bool(torch.isfinite(g).all()) for g in g_fused), "the fused backward at the "
                                                               "dense shapes is not finite")
    backward_side_by_side = {
        "chunked_bwd_t_ms": ms[cc.CHUNKED_BWD_T.name], "fused_bwd_t_ms": fused_bwd_ms,
        "max_rel_diff": {n: rel_err(a, b) for n, a, b in
                         zip(("doc", "dsigma", "dmag", "dalbedo", "ddirs"), g_fused, g_chunked)}}
    del t_d, g_chunked, g_fused
    b_, n_ = dense_in[1].shape
    r_ = dense_in[4].shape[2]
    t_bytes = ck.save_t_bytes(b_, n_, r_)
    rays3, rows8 = 4 * 3 * b_ * r_, 4 * 8 * b_ * n_
    nbytes = {cc.CHUNKED_FWD.name: scene_bytes(dense_in) + rays3,
              cc.CHUNKED_FWD_T.name: scene_bytes(dense_in) + rays3 + t_bytes,
              cc.CHUNKED_BWD_T.name: scene_bytes(dense_in) + 2 * rays3 + rows8 + t_bytes,
              cc.CHUNKED_BWD.name: scene_bytes(dense_in) + 2 * rays3 + rows8}
    ops = {cc.CHUNKED_FWD.name: fwd_ops(dense_in), cc.CHUNKED_FWD_T.name: fwd_ops(dense_in),
           cc.CHUNKED_BWD_T.name: bwd_ops(dense_in, False),
           cc.CHUNKED_BWD.name: bwd_ops(dense_in, True)}
    plain_ms = results[sub_case]["plain_ms"]
    launches = {k: frame_launches[k] + train_launches[k] + slab_launches[k]
                for k in frame_launches}
    times, entries = {}, []
    for k in (cc.CHUNKED_FWD, cc.CHUNKED_FWD_T, cc.CHUNKED_BWD, cc.CHUNKED_BWD_T):
        check(launches[k.name] > 0, f"{k.name} was not launched on a dense main path")
        times[k.name] = {"ms": ms[k.name], "fp32_instr": ops[k.name][0],
                         "sfu_ops": ops[k.name][1], "bytes": nbytes[k.name],
                         **bound(*ops[k.name], nbytes[k.name], clock_mhz, n_sm),
                         "plain_ms": plain_ms[k.name],
                         "plain_shape": f"the {sub_case} case of dense_kernels_vs_plain",
                         "launches": launches[k.name]}
        entries.append({
            "name": k.name, "route": k.route,
            "source": str(k.source.relative_to(nvcc.CSRC_DIR.parents[1])),
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": max(r["abs"][k.name] for r in results.values()),
            "max_rel_err": max(max(r["rel"][k.name].values()) for r in results.values()),
            "ms": ms[k.name], "plain_ms": plain_ms[k.name],
            "bound_ms": times[k.name]["bound_ms"], "bound_by": times[k.name]["bound_by"],
            "library_ms": None})
    emit("dense_times", shape={"B": b_, "N": n_, "R": r_, "ck": c_k,
                               "max_count": int(dense_in[5].max()),
                               "live_pairs": float(np.sum(live_counts(dense_in) ** 2) * r_)},
         kernels=times, one_chunk_ms=one_chunk, backward_parts=parts,
         backward_side_by_side=backward_side_by_side, power_limit=smi)
    return entries


def aniso_cloud(dev):
    """The anisotropic cell's scene: the cube cloud's Gaussians with per-axis
    scales sigma * ANISO_MULT (cli --aniso's from_isotropic and multiply)."""
    import torch

    from sgrt_tpu_torch.models.gaussians import scene_from_vertices
    from sgrt_tpu_torch.ops.anisotropic import from_isotropic

    scene = from_isotropic(scene_from_vertices(smoke_points(), device=dev))
    return scene.replace(scale=scene.scale * torch.tensor([ANISO_MULT], device=dev))


def compare_aniso_kernels(inp, dcol, erf_name="as5", exp_name="exact", rb: int = 128) -> dict:
    """Kernels 9-12 against their plain versions on `inp`, and all of them
    against a float64 run of the plain version (gate_vs_f64, as the dense
    cell's): colors within KERNEL_ATOL; T and the gradients within
    TRAIN_REL of scale (doc and dinvd DOC_REL), or as close to float64 as
    the float32 plain version is, x2. C - Bt mb cancels |oc|^2/scale^2
    (~6400 here) in float32 on both sides alike. The saved-T and recompute
    backwards must be equal bit for bit, and so must the colors of the
    forward and the forward-with-T; dead rows hold T = 0 and dead tiles get
    zero outputs."""
    import torch

    from sgrt_tpu_torch.ops import cuda_aniso as ca
    from sgrt_tpu_torch.ops import cuda_kernel as ck

    pb, qb = ck._block_sizes(inp[0].shape[1])
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    colors = ca.fused_forward_aniso(*inp, rb=rb, pb=pb, qb=qb, **kw)
    colors_t, t = ca.fused_forward_t_aniso(*inp, rb=rb, pb=pb, qb=qb, **kw)
    g_t = ca.fused_backward_aniso(*inp, dcol, t, rb=rb, qb=qb, **kw)
    g_r = ca.fused_backward_aniso(*inp, dcol, rb=rb, qb=qb, **kw)
    torch.cuda.synchronize()
    names = ("doc", "dinvd", "dmag", "dalbedo", "ddirs")
    for x in (colors, colors_t, t, *g_t, *g_r):
        check(bool(torch.isfinite(x).all()), f"an anisotropic kernel's output is not finite "
                                             f"({erf_name}/{exp_name})")
    dead = torch.arange(inp[0].shape[1], device=t.device)[None, :] >= inp[5][:, None].long()
    check(bool((t.permute(0, 2, 1, 3)[dead] == 0).all()), "aniso T is not 0 on dead rows")

    plain, plain_ms = {}, {}
    runs = {ca.FUSED_FWD_ANISO.name: (ca.fused_forward_aniso_plain, ()),
            ca.FUSED_FWD_T_ANISO.name: (ca.fused_forward_t_aniso_plain, ()),
            ca.FUSED_BWD_T_ANISO.name: (ca.fused_backward_aniso_plain, (dcol, t)),
            ca.FUSED_BWD_ANISO.name: (ca.fused_backward_aniso_plain, (dcol,))}
    for name, (fn, extra) in runs.items():
        t0 = time.perf_counter()
        plain[name] = per_tile(lambda *a: fn(*a, **kw), inp, *extra)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
    f64 = [x.double() if x.is_floating_point() else x for x in inp]
    ref_c, ref_t = per_tile(lambda *a: ca.fused_forward_t_aniso_plain(*a, **kw), f64)
    ref_g = per_tile(lambda *a: ca.fused_backward_aniso_plain(*a, **kw), f64, dcol.double(),
                     ref_t)
    outs = {ca.FUSED_FWD_ANISO.name: {"colors": (colors, plain[ca.FUSED_FWD_ANISO.name], ref_c)},
            ca.FUSED_FWD_T_ANISO.name: {
                "colors": (colors_t, plain[ca.FUSED_FWD_T_ANISO.name][0], ref_c),
                "T": (t, plain[ca.FUSED_FWD_T_ANISO.name][1], ref_t)},
            ca.FUSED_BWD_T_ANISO.name: {n: (a, b, c) for n, a, b, c in
                                        zip(names, g_t, plain[ca.FUSED_BWD_T_ANISO.name], ref_g)},
            ca.FUSED_BWD_ANISO.name: {n: (a, b, c) for n, a, b, c in
                                      zip(names, g_r, plain[ca.FUSED_BWD_ANISO.name], ref_g)}}
    rel, vs_f64, absd, over = gate_vs_f64(outs)
    rel["bwd_t_vs_bwd"] = {n: rel_err(a, b) for n, a, b in zip(names, g_t, g_r)}
    over += backwards_differ(rel)
    # T is rounded alike whether or not it is stored (csrc/chunked.cu)
    if not torch.equal(colors, colors_t):
        over.append(f"fwd vs fwd_t colors: {rel_err(colors, colors_t):.3g} (must be equal)")
    for i in [i for i, c in enumerate(inp[5].tolist()) if c <= 0]:
        check(all(bool((x[i] == 0).all()) for x in (colors, colors_t, *g_t, *g_r)),
              f"a dead tile's anisotropic outputs are not zero ({erf_name}/{exp_name})")
    return {"rel": rel, "vs_f64": vs_f64, "abs": absd, "over_tolerance": over,
            "plain_ms": plain_ms,
            "shape": {"B": inp[0].shape[0], "N": inp[0].shape[1], "R": inp[4].shape[2],
                      "rb": rb, "max_count": int(inp[5].max())}}


def aniso_phases(dev, smi: str, clock_mhz: float, n_sm: int, obj: str,
                 fused_vs_chunked: bool = False) -> list:
    """The anisotropic cell (config4_aniso_teapot_256): shapes, kernels 9-12
    against their plain versions (and float64), the CLI's --aniso orbit,
    fit_cli --aniso, the bucketed anisotropic train step (saved-T, then
    recompute) with a profile, and the kernels' times (kernels 11-12 with
    their parts); with fused_vs_chunked (--only aniso) also
    aniso_fused_vs_chunked. Returns the kernel line's entries of kernels
    9-12."""
    import torch

    from sgrt_tpu_torch import cli, fit_cli
    from sgrt_tpu_torch.ops import anisotropic as an
    from sgrt_tpu_torch.ops import cuda_aniso as ca
    from sgrt_tpu_torch.ops import cuda_chunked_aniso as cca
    from sgrt_tpu_torch.ops import cuda_kernel as ck
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_aniso_for
    from sgrt_tpu_torch.ops.frame import orbit_camera, probe_buckets, probe_capacity
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.parallel.fit import adam, init_state, make_aniso_frame_train_step
    from sgrt_tpu_torch.utils import nvcc
    from sgrt_tpu_torch.utils.image import to_rgba_u8

    S, TL = ANISO_SIZE, ANISO_TILES
    scene = aniso_cloud(dev)
    proxy = an.iso_proxy(scene)

    # 1. shapes: fit_cli's probes (x1.3, margin 1.3) and the CLI's (x1.25,
    # margin 1.25), both on the max-scale proxy
    t0 = time.perf_counter()
    probe = probe_capacity(proxy, ANGLES, OFFSET, FOCAL, TL)
    capacity = max(32, int(probe * 1.3))
    bucket = probe_buckets(proxy, ANGLES, OFFSET, FOCAL, TL, margin=1.3)
    cli_bucket = probe_buckets(proxy, ANGLES, OFFSET, FOCAL, TL, margin=1.25)
    cam = orbit_camera(30.0, OFFSET, FOCAL, S, S, device=dev)
    o, dirs = cam.rays()
    tile_dirs = _tile_rays(dirs, S, S, TL)
    per_bucket = bucket_launches(scene, cam.view_matrix, o, tile_dirs, bucket, TL)
    dense_in = per_bucket[0]
    cnt = live_counts(dense_in)
    shapes = [{"B": i[0].shape[0], "N": i[0].shape[1], "R": i[4].shape[2],
               "max_count": int(i[5].max()),
               "live_pairs_x_rays": float(np.sum(live_counts(i) ** 2) * i[4].shape[2])}
              for i in per_bucket]
    emit("aniso_shapes", scene=f"cube cloud ({N_POINTS}) x {list(ANISO_MULT)}", size=S,
         tiles=list(TL), probe_max_count=int(probe), capacity=capacity,
         padded_capacity=tile_renderer_aniso_for(capacity)[0], bucket_cfg=bucket._asdict(),
         cli_capacity=max(32, int(probe * 1.25)), cli_bucket_cfg=cli_bucket._asdict(),
         route="fused aniso", max_bwd_capacity_aniso=ca.MAX_BWD_CAPACITY_ANISO,
         launches_at_30_degrees=shapes, densest_tile=int(cnt.max()),
         seconds=time.perf_counter() - t0)
    check(max(s["N"] for s in shapes) <= ca.MAX_BWD_CAPACITY_ANISO,
          "the anisotropic cell's capacity leaves the fused route")

    # 2. kernels 9-12 against their plain versions and float64
    rng = np.random.default_rng(3)
    dense_tile = int(np.argmax(cnt))
    live = [i for i in np.flatnonzero(cnt > 0) if i != dense_tile]
    sel = [dense_tile] + sorted(rng.choice(live, size=min(31, len(live)), replace=False).tolist())
    sub = [t[torch.tensor(sel, device=dev)].contiguous() for t in dense_in]
    # counts below capacity: the rows past each halved count hold live data,
    # which the kernels must ignore; one tile dead
    below = [t[:4].clone() for t in sub]
    below[5] = below[5] // 2
    below[5][3] = 0

    def cotangent(inp, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn((inp[0].shape[0], 3, inp[4].shape[2]), generator=g).to(dev)

    cases = {"32_tiles": (sub, "as5", "exact", 128),
             "counts_below_capacity": (below, "as5", "exact", 128),
             "two_ray_blocks": ([t[:4] for t in sub], "as5", "exact", 64),
             "one_tile_as3_fast": ([t[:1] for t in sub], "as3", "fast", 128),
             **{f"one_tile_{e}_{x}": ([t[:1] for t in sub], e, x, 128) for e, x in APPROX_STACKS}}
    results = {}
    t0 = time.perf_counter()
    for i, (name, (inp, e, x, rb)) in enumerate(cases.items()):
        results[name] = compare_aniso_kernels(inp, cotangent(inp, 60 + i), e, x, rb)
    # the saved-T budget at 0: the differentiable op takes the recompute
    # backward, with the same gradients bit for bit
    four = [t[:4] for t in sub]
    dcol4 = cotangent(four, 70)
    pb, qb = ck._block_sizes(four[0].shape[1])
    budget, via_op = ck.SAVE_T_MAX_BYTES, {}
    for b in (budget, 0):
        ck.SAVE_T_MAX_BYTES = b
        try:
            leaves = [x.clone().requires_grad_(True) for x in four[:5]]
            kernels.reset_launch_counts()
            ca.render_fused_aniso(*leaves, four[5], pb=pb, qb=qb).backward(dcol4)
            torch.cuda.synchronize()
        finally:
            ck.SAVE_T_MAX_BYTES = budget
        via_op[b] = ([x.grad for x in leaves],
                     {k.name: k.launches for k in (ca.FUSED_BWD_T_ANISO, ca.FUSED_BWD_ANISO)})
    check(via_op[budget][1][ca.FUSED_BWD_T_ANISO.name] == 1
          and via_op[0][1][ca.FUSED_BWD_ANISO.name] == 1,
          f"the saved-T budget did not choose the backward: {via_op[budget][1]}, {via_op[0][1]}")
    budget0_equal = all(bool(torch.equal(a, b)) for a, b in zip(via_op[budget][0], via_op[0][0]))
    emit("aniso_kernels_vs_plain", tolerance_rel=TRAIN_REL, tolerance_rel_doc=DOC_REL,
         atol_colors=KERNEL_ATOL, seconds=time.perf_counter() - t0,
         densest_count=int(cnt.max()), live_tiles=int((cnt > 0).sum()), cases=results,
         save_t_budget_0={"launches": via_op[0][1], "grads_equal_saved_t": budget0_equal})
    over = [f"{name}: {o}" for name, r in results.items() for o in r["over_tolerance"]]
    check(not over, f"an anisotropic kernel disagrees with its plain version: {over}")
    check(budget0_equal, "the recompute op's gradients differ from the saved-T op's")

    # 3. main path, serving: the CLI's 8-frame --aniso orbit
    png = os.path.join(os.path.dirname(obj), "aniso.png")
    argv = ["-f", obj, "-w", str(S), "--height", str(S), "--tiles", f"{TL[0]}x{TL[1]}",
            "--aniso", ",".join(str(m) for m in ANISO_MULT), "--frames", str(FRAMES), "-q",
            "-o", png]
    stdout, stderr = io.StringIO(), io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = cli.main(argv)
    cli_s = time.perf_counter() - t0
    cli_launches = {k.name: k.launches for k in kernels.KERNELS}
    check(rc == 0, f"the --aniso CLI exited {rc}: {stderr.getvalue()[-2000:]}")
    check(cli_launches[ca.FUSED_FWD_ANISO.name] > 0,
          f"the --aniso orbit did not launch the anisotropic forward: {cli_launches}")
    check("overflow" not in stderr.getvalue(), stderr.getvalue()[-2000:])
    avg = re.search(r"AVG\. TIME: ([\d.]+) ms", stdout.getvalue())
    check(avg is not None, f"no AVG. TIME line: {stdout.getvalue()!r}")
    stem = png.rpartition(".")[0]
    imgs = [read_png_rgba(f"{stem}_{i}.png") for i in range(1, FRAMES + 1)]
    check(all(im.shape == (S, S, 4) and int(im[..., :3].max()) > 0 for im in imgs),
          "an --aniso frame is black")
    # frame 1 again through the library: finite, no overflow, the CLI's image
    img0, ovf0 = an.render_tiled_aniso(scene, orbit_camera(0.0, OFFSET, FOCAL, S, S, device=dev),
                                       tiles=TL, capacity=max(32, int(probe * 1.25)),
                                       backend="kernel", erf_name="as5", bucket_cfg=cli_bucket)
    check(bool(torch.isfinite(img0).all()) and int(ovf0) == 0, "aniso frame 0 is not finite "
                                                               "or overflowed")
    check(bool(np.array_equal(to_rgba_u8(img0.cpu().numpy()), imgs[0])),
          "the --aniso CLI's frame 1 differs from render_tiled_aniso")
    emit("aniso_cli", argv=argv[2:13], rc=rc, frames=FRAMES, launches=cli_launches, overflow=0,
         cli_seconds=cli_s, avg_time_ms=float(avg.group(1)),
         rays_per_s=S * S / (float(avg.group(1)) * 1e-3),
         mean_rgb=[round(float(im[..., :3].mean()), 3) for im in imgs], power_limit=smi)

    # 4. main path, training: fit_cli --aniso, 10 steps at 256^2
    fpng = os.path.join(os.path.dirname(obj), "aniso_fit.png")
    argv = ["-f", obj, "-w", str(S), "--height", str(S), "--tiles", str(ANISO_FIT_TILES),
            "--steps", "10", "--views", "4", "--aniso", ",".join(str(m) for m in ANISO_MULT),
            "--out", fpng]
    stdout, stderr = io.StringIO(), io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = fit_cli.main(argv)
    fit_s = time.perf_counter() - t0
    fit_launches = {k.name: k.launches for k in kernels.KERNELS}
    out = stdout.getvalue()
    check(rc == 0, f"fit_cli --aniso exited {rc}: {stderr.getvalue()[-2000:]}")
    check(fit_launches[ca.FUSED_FWD_T_ANISO.name] > 0 and fit_launches[ca.FUSED_BWD_T_ANISO.name] > 0,
          f"a kernel of the anisotropic training path was not launched: {fit_launches}")
    check("warning" not in out, f"fit_cli --aniso warned: {out[-2000:]}")
    losses = [float(v) for v in re.findall(r"loss ([^\s]+)", out)]
    check(len(losses) == 10 and all(np.isfinite(losses)), f"fit_cli --aniso losses: {out[-2000:]}")
    # views cycle 0-3: the loss of view 0 must fall from step 1 to step 9
    check(losses[8] < losses[0], f"fit_cli --aniso's loss did not fall: {losses}")
    serr = re.search(r"max \|scale error\|: ([\d.]+) -> ([\d.]+)", out)
    check(serr is not None, f"no scale error line: {out[-2000:]}")
    fimg = read_png_rgba(fpng)
    check(int(fimg[..., :3].max()) > 0, "fit_cli --aniso's PNG is black")
    emit("aniso_fit_cli", argv=argv[2:], rc=rc, launches=fit_launches, losses=losses,
         seconds=fit_s, lines=[ln for ln in out.splitlines()
                               if ln.startswith(("scene", "10 steps", "max"))])

    # 5. the bucketed anisotropic train step, saved-T and recompute
    cam35 = orbit_camera(35.0, OFFSET, FOCAL, S, S, device=dev)
    target, ovf = an.render_tiled_aniso(scene, cam35, tiles=TL, capacity=capacity,
                                        backend="kernel", bucket_cfg=bucket)
    check(int(ovf) == 0, "the anisotropic target overflowed")

    def run_steps(n):
        step = make_aniso_frame_train_step(width=S, height=S, tiles=TL, capacity=capacity,
                                           bucket_cfg=bucket)
        state = init_state(scene, adam(1e-3))
        state, loss, ov = step(state, cam.view_matrix, o, dirs, target)
        losses, ovfs = [loss], [ov]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            state, loss, ov = step(state, cam.view_matrix, o, dirs, target)
            losses.append(loss)
            ovfs.append(ov)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        launches = {k.name: k.launches for k in kernels.KERNELS}
        losses = [float(v) for v in losses]
        check(all(int(v) == 0 for v in ovfs), "an anisotropic train step overflowed")
        check(all(np.isfinite(losses)), f"anisotropic train-step losses not finite: {losses}")
        return {"step_ms": dt * 1e3, "rays_per_s": S * S / dt, "losses": losses,
                "launches": launches, "launches_per_step": {k: v / n for k, v in launches.items()},
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}, step, state

    saved, step, state = run_steps(ANISO_STEPS)
    check(saved["losses"][-1] < saved["losses"][0],
          f"the anisotropic train step's loss did not fall: {saved['losses']}")
    check(saved["launches"][ca.FUSED_BWD_T_ANISO.name] > 0, "the aniso saved-T backward did not run")
    ck.SAVE_T_MAX_BYTES = 0
    try:
        recompute, _, _ = run_steps(3)
    finally:
        ck.SAVE_T_MAX_BYTES = budget
    check(recompute["launches"][ca.FUSED_BWD_ANISO.name] > 0
          and recompute["launches"][ca.FUSED_BWD_T_ANISO.name] == 0,
          f"the aniso recompute backward did not run: {recompute['launches']}")
    np.testing.assert_allclose(recompute["losses"], saved["losses"][:4], rtol=1e-4)
    emit("aniso_train_step", size=S, tiles=list(TL), capacity=capacity,
         bucket_cfg=bucket._asdict(), steps=ANISO_STEPS, saved_t=saved, recompute=recompute,
         power_limit=smi)
    emit("aniso_train_profile", steps=2, **profile_device(
        lambda _: step(state, cam.view_matrix, o, dirs, target), range(2)))

    # 6. times: kernel 9 at the CLI orbit's frame-0 launches, kernels 10-12
    # at the train step's; plain versions on the 32-tile subset
    cam0 = orbit_camera(0.0, OFFSET, FOCAL, S, S, device=dev)
    o0, dirs0 = cam0.rays()
    cli_launch = bucket_launches(scene, cam0.view_matrix, o0, _tile_rays(dirs0, S, S, TL),
                                 cli_bucket, TL)
    shapes_of = {ca.FUSED_FWD_ANISO.name: cli_launch}
    for k in (ca.FUSED_FWD_T_ANISO, ca.FUSED_BWD_T_ANISO, ca.FUSED_BWD_ANISO):
        shapes_of[k.name] = per_bucket
    dcols = [cotangent(inp, 80 + i) for i, inp in enumerate(per_bucket)]
    blocks = [ck._block_sizes(inp[0].shape[1]) for inp in per_bucket]
    ts = [ca.fused_forward_t_aniso(*inp, pb=pb, qb=qb)[1] for inp, (pb, qb) in
          zip(per_bucket, blocks)]
    runs = {
        ca.FUSED_FWD_ANISO.name: [lambda i=i, b=ck._block_sizes(i[0].shape[1]):
                                  ca.fused_forward_aniso(*i, pb=b[0], qb=b[1])
                                  for i in cli_launch],
        ca.FUSED_FWD_T_ANISO.name: [lambda i=i, b=b: ca.fused_forward_t_aniso(*i, pb=b[0], qb=b[1])
                                    for i, b in zip(per_bucket, blocks)],
        ca.FUSED_BWD_T_ANISO.name: [lambda i=i, b=b, d=d, t=t:
                                    ca.fused_backward_aniso(*i, d, t, qb=b[1])
                                    for i, b, d, t in zip(per_bucket, blocks, dcols, ts)],
        ca.FUSED_BWD_ANISO.name: [lambda i=i, b=b, d=d: ca.fused_backward_aniso(*i, d, qb=b[1])
                                  for i, b, d in zip(per_bucket, blocks, dcols)],
    }
    ms = {k: sum(time_cuda(f, iters=5, warmup=1) for f in fs) for k, fs in runs.items()}
    # kernels 11-12 part by part (csrc/chunked.cu at one chunk): the
    # recompute's T, p side, db sum, q side and the row and ddirs kernels by
    # CUDA events, one call each, summed over the train step's launches
    parts = {}
    for k, t_args in ((ca.FUSED_BWD_T_ANISO, ts), (ca.FUSED_BWD_ANISO, [None] * len(ts))):
        pm = torch.zeros(5)
        for i, b, d, t in zip(per_bucket, blocks, dcols, t_args):
            one = torch.zeros(5)
            ca.fused_backward_aniso(*i, d, t, qb=b[1], part_ms=one)
            pm += one
        parts[k.name] = one_chunk_parts(pm)
    del ts

    def nbytes(k, inp):
        """Each input read once, each output written once: the scene and the
        rays; colors and T out of the forwards; dcol (and T) in, doc, dinvd,
        dmag, dalbedo (10 floats a row) and ddirs out of the backwards."""
        b_, n_, r_ = inp[0].shape[0], inp[0].shape[1], inp[4].shape[2]
        rays3, t_b = 4 * 3 * b_ * r_, ck.save_t_bytes(b_, n_, r_)
        if k in (ca.FUSED_FWD_ANISO.name, ca.FUSED_FWD_T_ANISO.name):
            return scene_bytes(inp) + rays3 + (t_b if k == ca.FUSED_FWD_T_ANISO.name else 0)
        rows10 = 4 * 10 * b_ * n_
        return (scene_bytes(inp) + 2 * rays3 + rows10
                + (t_b if k == ca.FUSED_BWD_T_ANISO.name else 0))

    def ops(k, inp):
        if k in (ca.FUSED_FWD_ANISO.name, ca.FUSED_FWD_T_ANISO.name):
            return fwd_ops(inp)
        return bwd_ops(inp, k == ca.FUSED_BWD_ANISO.name)

    launches = {ca.FUSED_FWD_ANISO.name: cli_launches[ca.FUSED_FWD_ANISO.name],
                ca.FUSED_FWD_T_ANISO.name: fit_launches[ca.FUSED_FWD_T_ANISO.name],
                ca.FUSED_BWD_T_ANISO.name: fit_launches[ca.FUSED_BWD_T_ANISO.name],
                ca.FUSED_BWD_ANISO.name: recompute["launches"][ca.FUSED_BWD_ANISO.name]}
    plain_ms = results["32_tiles"]["plain_ms"]
    times, entries = {}, []
    for k in (ca.FUSED_FWD_ANISO, ca.FUSED_FWD_T_ANISO, ca.FUSED_BWD_T_ANISO, ca.FUSED_BWD_ANISO):
        check(launches[k.name] > 0, f"{k.name} was not launched on an anisotropic main path")
        fp32 = sum(ops(k.name, i)[0] for i in shapes_of[k.name])
        sfu = sum(ops(k.name, i)[1] for i in shapes_of[k.name])
        nb = sum(nbytes(k.name, i) for i in shapes_of[k.name])
        times[k.name] = {"ms": ms[k.name], "launches": launches[k.name],
                         "shapes": [{"B": i[0].shape[0], "N": i[0].shape[1], "R": i[4].shape[2],
                                     "max_count": int(i[5].max())} for i in shapes_of[k.name]],
                         "live_pairs": sum(float(np.sum(live_counts(i) ** 2) * i[4].shape[2])
                                           for i in shapes_of[k.name]),
                         "fp32_instr": fp32, "sfu_ops": sfu, "bytes": nb,
                         **bound(fp32, sfu, nb, clock_mhz, n_sm),
                         "plain_ms": plain_ms[k.name],
                         "plain_shape": "the 32-tile case of aniso_kernels_vs_plain, tile by tile",
                         "library_ms": "n/a: no single PyTorch call computes it",
                         **({"parts": parts[k.name]} if k.name in parts else {})}
        entries.append({
            "name": k.name, "route": k.route,
            "source": str(k.source.relative_to(nvcc.CSRC_DIR.parents[1])),
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": max(r["abs"][k.name] for r in results.values()),
            "max_rel_err": max(max(r["rel"][k.name].values()) for r in results.values()),
            "ms": ms[k.name], "plain_ms": plain_ms[k.name],
            "bound_ms": times[k.name]["bound_ms"], "bound_by": times[k.name]["bound_by"],
            "library_ms": None})
    emit("aniso_times", kernels=times, power_limit=smi)
    if fused_vs_chunked:
        fused_vs_chunked_phase(
            "aniso_fused_vs_chunked", dev, smi,
            (ca.fused_forward_t_aniso, ca.fused_backward_aniso, ca.FUSED_BWD_T_ANISO,
             ca.FUSED_BWD_ANISO),
            (cca.chunked_forward_t_aniso, cca.chunked_backward_aniso, cca.CHUNKED_BWD_T_ANISO,
             cca.CHUNKED_BWD_ANISO),
            scene, cam.view_matrix, o, tile_dirs, bucket, TL, dense_in,
            forwards=((ca.fused_forward_aniso, ca.fused_forward_t_aniso),
                      (cca.chunked_forward_aniso, cca.chunked_forward_t_aniso),
                      {**{f"cli_frame0[{i}]": x for i, x in enumerate(cli_launch)},
                       "step": dense_in}))
    return entries


def compare_chunked_aniso_kernels(inp, dcol, c_k: int, erf_name="as5", exp_name="exact",
                                  rb: int = 128) -> dict:
    """Kernels 13-14 and their saved-T schedule (19-20: the forward-with-T
    and the saved-T backward) against their plain versions on `inp`, each
    held against a float64 run of the plain version (gate_vs_f64, as the
    dense and anisotropic cells' kernels: each output as close to float64 as
    the float32 plain version is, x2, or within TRAIN_REL of scale, doc and
    dinvd DOC_REL, colors KERNEL_ATOL); the saved-T and recompute backwards
    equal bit for bit (backwards_differ); T zero on dead rows; dead tiles
    get zero outputs. Reported as compare_chunked_kernels reports, with the
    plain versions' ms (one call each, tile by tile)."""
    import torch

    from sgrt_tpu_torch.ops import cuda_chunked_aniso as cca

    kw = dict(ck=c_k, erf_name=erf_name, exp_name=exp_name)
    colors = cca.chunked_forward_aniso(*inp, rb=rb, **kw)
    colors_t, t = cca.chunked_forward_t_aniso(*inp, rb=rb, **kw)
    g_t = cca.chunked_backward_aniso(*inp, dcol, t, rb=rb, **kw)
    grads = cca.chunked_backward_aniso(*inp, dcol, rb=rb, **kw)
    torch.cuda.synchronize()
    names = ("doc", "dinvd", "dmag", "dalbedo", "ddirs")
    for x in (colors, colors_t, t, *g_t, *grads):
        check(bool(torch.isfinite(x).all()), f"a chunked anisotropic kernel's output is not "
                                             f"finite ({erf_name}/{exp_name})")
    dead = torch.arange(inp[0].shape[1], device=t.device)[None, :] >= inp[5][:, None].long()
    check(bool((t.permute(0, 2, 1, 3)[dead] == 0).all()),
          "chunked anisotropic T is not 0 on dead rows")
    plain, plain_ms = {}, {}
    runs = {cca.CHUNKED_FWD_ANISO.name: (cca.chunked_forward_aniso_plain, ()),
            cca.CHUNKED_FWD_T_ANISO.name: (cca.chunked_forward_t_aniso_plain, ()),
            cca.CHUNKED_BWD_T_ANISO.name: (cca.chunked_backward_aniso_plain, (dcol, t)),
            cca.CHUNKED_BWD_ANISO.name: (cca.chunked_backward_aniso_plain, (dcol,))}
    for name, (fn, extra) in runs.items():
        t0 = time.perf_counter()
        plain[name] = per_tile(lambda *a: fn(*a, **kw), inp, *extra)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
    f64 = [x.double() if x.is_floating_point() else x for x in inp]
    ref_c, ref_t = per_tile(lambda *a: cca.chunked_forward_t_aniso_plain(*a, **kw), f64)
    ref_g = per_tile(lambda *a: cca.chunked_backward_aniso_plain(*a, **kw), f64, dcol.double(),
                     ref_t)
    fwd_t = plain[cca.CHUNKED_FWD_T_ANISO.name]
    outs = {cca.CHUNKED_FWD_ANISO.name: {"colors": (colors, plain[cca.CHUNKED_FWD_ANISO.name],
                                                    ref_c)},
            cca.CHUNKED_FWD_T_ANISO.name: {"colors": (colors_t, fwd_t[0], ref_c),
                                           "T": (t, fwd_t[1], ref_t)},
            cca.CHUNKED_BWD_T_ANISO.name: {n: (a, b, c) for n, a, b, c in
                                           zip(names, g_t, plain[cca.CHUNKED_BWD_T_ANISO.name],
                                               ref_g)},
            cca.CHUNKED_BWD_ANISO.name: {n: (a, b, c) for n, a, b, c in
                                         zip(names, grads, plain[cca.CHUNKED_BWD_ANISO.name],
                                             ref_g)}}
    rel, vs_f64, absd, over = gate_vs_f64(outs)
    rel["bwd_t_vs_bwd"] = {n: rel_err(a, b) for n, a, b in zip(names, g_t, grads)}
    over += backwards_differ(rel)
    for i in [i for i, c in enumerate(inp[5].tolist()) if c <= 0]:
        check(all(bool((x[i] == 0).all()) for x in (colors, colors_t, *g_t, *grads)),
              f"a dead tile's chunked anisotropic outputs are not zero ({erf_name}/{exp_name})")
    return {"rel": rel, "vs_f64": vs_f64, "abs": absd, "over_tolerance": over,
            "plain_ms": plain_ms,
            "shape": {"B": inp[0].shape[0], "N": inp[0].shape[1], "R": inp[4].shape[2],
                      "ck": c_k, "rb": rb, "max_count": int(inp[5].max())}}


def aniso_dense_phases(dev, smi: str, clock_mhz: float, n_sm: int, tmp: str,
                       fused_vs_chunked: bool = False) -> list:
    """The anisotropic dense cell (scripts/large_n.py --aniso at docs/
    LARGE_N.md's fitting size): tile grid and buckets, kernels 13-14
    against their plain versions and float64 (and kernels 9-12 on the
    sparse bucket's densest tiles), the bucketed frame and the
    --aniso CLI, the anisotropic slab train step with a profile, the
    kernels' times, and the crossover of the fused and chunked anisotropic
    backwards; with fused_vs_chunked (--only aniso_dense) also the fused
    anisotropic forwards beside the chunked ones at one chunk on the sparse
    bucket (aniso_dense_fwd_vs_chunked). Returns the kernel line's entries
    of kernels 13-14."""
    import torch

    from sgrt_tpu_torch import cli
    from sgrt_tpu_torch.models.gaussians import scene_from_vertices
    from sgrt_tpu_torch.ops import anisotropic as an
    from sgrt_tpu_torch.ops import cuda_aniso as ca
    from sgrt_tpu_torch.ops import cuda_chunked as cc
    from sgrt_tpu_torch.ops import cuda_chunked_aniso as cca
    from sgrt_tpu_torch.ops import cuda_kernel as ck
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.frame import auto_tile_grid, orbit_camera, probe_buckets
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.ops.scheduler import BucketConfig
    from sgrt_tpu_torch.ops.tiling import tile_membership
    from sgrt_tpu_torch.parallel.fit import adam, init_state, make_slab_frame_train_step
    from sgrt_tpu_torch.utils import nvcc

    S = DENSE_SIZE
    pts = sphere_points(DENSE_N)
    scene = an.from_isotropic(scene_from_vertices(pts, device=dev))
    scene = scene.replace(scale=scene.scale * torch.tensor([ADENSE_MULT], device=dev))
    proxy = an.iso_proxy(scene)

    # 1. shapes: the tile grid, the buckets, and each bucket's route
    t0 = time.perf_counter()
    tiles, capacity = auto_tile_grid(proxy, [DENSE_ANGLE], OFFSET, FOCAL, margin=DENSE_MARGIN,
                                     width=S, height=S)
    probed = probe_buckets(proxy, [DENSE_ANGLE], OFFSET, FOCAL, tiles, margin=DENSE_MARGIN)
    cams = {a: orbit_camera(a, OFFSET, FOCAL, S, S, device=dev)
            for a in (DENSE_ANGLE, DENSE_TARGET_ANGLE)}
    over_sparse = max(int(torch.sum(torch.sum(tile_membership(proxy, c.view_matrix, tiles,
                                                              focal_length=FOCAL), dim=-1)
                                    > ADENSE_CAP_SPARSE)) for c in cams.values())
    bucket = BucketConfig(-(-over_sparse // 64) * 64, capacity, ADENSE_CAP_SPARSE)
    routes = {}
    for name, cap in (("dense", bucket.cap_dense), ("sparse", bucket.cap_sparse)):
        chunked = cap > ca.MAX_BWD_CAPACITY_ANISO
        padded, c_k = cc.chunk_plan(cap)
        routes[name] = {"capacity": cap, "route": "chunked aniso" if chunked else "fused aniso",
                        "padded_capacity": cc.tile_renderer_aniso_for(cap)[0],
                        **({"chunk_plan": {"C": padded // c_k, "ck": c_k, "padded": padded}}
                           if chunked else {})}
    emit("aniso_dense_shapes", scene=f"sphere({DENSE_N}) x {list(ADENSE_MULT)}", size=S,
         tiles=list(tiles), capacity=capacity,
         chunk_plan=dict(zip(("padded", "ck"), cc.chunk_plan(capacity))),
         tiles_over_sparse_capacity=over_sparse, bucket_cfg=bucket._asdict(),
         probe_buckets_pick=probed._asdict(), buckets=routes,
         max_bwd_capacity_aniso=ca.MAX_BWD_CAPACITY_ANISO, seconds=time.perf_counter() - t0)
    check(routes["dense"]["route"] == "chunked aniso",
          f"the dense bucket ({bucket.cap_dense} rows) is not on the chunked route")

    cam = cams[DENSE_ANGLE]
    o, dirs = cam.rays()
    tile_dirs = _tile_rays(dirs, S, S, tiles)
    per_bucket = bucket_launches(scene, cam.view_matrix, o, tile_dirs, bucket, tiles)
    dense_in = per_bucket[0]
    n_d = dense_in[0].shape[1]
    c_k = cc.chunk_plan(n_d)[1]

    def cotangent(inp, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn((inp[0].shape[0], 3, inp[4].shape[2]), generator=g).to(dev)

    # 2. kernels 13-14 against their plain versions and float64: the densest
    # tile and seeded live ones; B = 1 in three chunks, the last partly live
    # (of the seeded tiles the one nearest ADENSE_B1_COUNT rows, cut, or
    # padded with inert rows: oc = -o, invd 1, magnitude 0); a dead tile; two
    # ray blocks; as3/fast (the last three on seeded tiles: the plain
    # versions' cost grows as count^2)
    cnt = live_counts(dense_in).astype(np.int64)
    rng = np.random.default_rng(4)
    dense_tile = int(np.argmax(cnt))
    live = [i for i in np.flatnonzero(cnt > 0) if i != dense_tile]
    sel = [dense_tile] + sorted(rng.choice(live, size=min(ADENSE_SUB_TILES - 1, len(live)),
                                           replace=False).tolist())
    sub = [t[torch.tensor(sel, device=dev)].contiguous() for t in dense_in]
    mid = min(range(1, len(sel)), key=lambda i: abs(int(cnt[sel[i]]) - ADENSE_B1_COUNT))
    c0 = int(cnt[sel[mid]])
    ck3 = -(-int(np.ceil(c0 / 2.5)) // 128) * 128
    one = [t[mid:mid + 1] for t in sub]
    near = min(range(1, len(sel)), key=lambda i: abs(int(cnt[sel[i]]) - APPROX_DENSE_COUNT))
    if 3 * ck3 <= n_d:
        one3 = [t[:, :3 * ck3].contiguous() if i < 4 else t for i, t in enumerate(one)]
    else:
        pad = 3 * ck3 - n_d
        fill = [(-o).expand(1, pad, 3), torch.ones(1, pad, 3, device=dev),
                torch.zeros(1, pad, device=dev), torch.zeros(1, pad, 3, device=dev)]
        one3 = [torch.cat([t, f], dim=1).contiguous() for t, f in zip(one[:4], fill)] + one[4:]
    dead = [t[1:3].clone() for t in sub]
    dead[5][0] = 0
    cases = {f"{len(sel)}_tiles": (sub, c_k, "as5", "exact", 128),
             "B1_three_chunks_last_partial": (one3, ck3, "as5", "exact", 128),
             "dead_tile": (dead, c_k, "as5", "exact", 128),
             "two_ray_blocks": ([t[1:3] for t in sub], c_k, "as5", "exact", 64),
             "one_tile_as3_fast": ([t[1:2] for t in sub], c_k, "as3", "fast", 128),
             **{f"one_tile_{e}_{x}": ([t[near:near + 1] for t in sub], c_k, e, x, 128)
                for e, x in APPROX_STACKS}}
    results = {}
    t0 = time.perf_counter()
    for i, (name, (inp, kk, e, x, rb)) in enumerate(cases.items()):
        results[name] = compare_chunked_aniso_kernels(inp, cotangent(inp, 90 + i), kk, e, x, rb)
    emit("aniso_dense_kernels_vs_plain", seconds=time.perf_counter() - t0,
         densest_count=int(cnt[dense_tile]), live_tiles=int((cnt > 0).sum()), cases=results)
    over = [f"{name}: {o}" for name, r in results.items() for o in r["over_tolerance"]]
    check(not over, f"a chunked anisotropic kernel disagrees with its plain version: {over}")
    # the sparse bucket's launch takes the fused anisotropic route (kernels
    # 9-12): its densest tiles against the plain versions and float64
    sparse_in = per_bucket[-1]
    top_s = np.argsort(-live_counts(sparse_in), kind="stable")[:SPARSE_TILES]
    sub_s = [t[torch.tensor(top_s.tolist(), device=dev)].contiguous() for t in sparse_in]
    sparse_case = compare_aniso_kernels(sub_s, cotangent(sub_s, 97))
    emit("aniso_dense_sparse_vs_plain", case=sparse_case)
    check(not sparse_case["over_tolerance"], "a fused anisotropic kernel disagrees with its "
          f"plain version on the sparse bucket: {sparse_case['over_tolerance']}")

    # 3. the bucketed frame and the --aniso CLI
    def frame():
        return an.render_tiled_aniso(scene, cam, tiles=tiles, capacity=capacity,
                                     backend="kernel", bucket_cfg=bucket)

    kernels.reset_launch_counts()
    frame_ms, ovf = [], []
    for _ in range(3):                        # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, ov = frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        ovf.append(int(ov))
    frame_launches = {k.name: k.launches for k in kernels.KERNELS}
    check(all(v == 0 for v in ovf), f"the anisotropic dense frame overflowed: {ovf}")
    check(bool(torch.isfinite(img).all()) and float(img.max()) > 0,
          "the anisotropic dense frame is not finite or black")
    check(frame_launches[cca.CHUNKED_FWD_ANISO.name] > 0,
          f"the anisotropic dense frame did not launch the chunked forward: {frame_launches}")
    obj = os.path.join(tmp, "sphere_aniso.obj")
    write_obj(obj, pts)
    png = os.path.join(tmp, "sphere_aniso.png")
    argv = ["--aniso", ",".join(str(m) for m in ADENSE_MULT), "-f", obj, "-w", str(S),
            "--height", str(S), "--tiles", f"{tiles[0]}x{tiles[1]}", "--frames", "1", "-q",
            "-o", png]
    stdout, stderr = io.StringIO(), io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = cli.main(argv)
    cli_launches = {k.name: k.launches for k in kernels.KERNELS}
    check(rc == 0, f"the anisotropic dense CLI run exited {rc}: {stderr.getvalue()[-2000:]}")
    check(cli_launches[cca.CHUNKED_FWD_ANISO.name] == 1 and "overflow" not in stderr.getvalue(),
          f"the anisotropic dense CLI run: {cli_launches}, {stderr.getvalue()[-2000:]}")
    check(int(read_png_rgba(png)[..., :3].max()) > 0, "the anisotropic dense CLI frame is black")
    emit("aniso_dense_frame", size=S, tiles=list(tiles), bucket_cfg=bucket._asdict(),
         frame_ms=frame_ms[1:], overflow=ovf, launches=frame_launches,
         mean_rgb=float(img.mean()), cli={"argv": argv[:12], "rc": rc,
                                          "stdout": stdout.getvalue().strip(),
                                          "launches": cli_launches},
         power_limit=smi)

    # 4. the anisotropic slab step against the target at 35 degrees
    target, ov = an.render_tiled_aniso(scene, cams[DENSE_TARGET_ANGLE], tiles=tiles,
                                       capacity=capacity, backend="kernel", bucket_cfg=bucket)
    check(int(ov) == 0, "the anisotropic dense target overflowed")
    slab = make_slab_frame_train_step(width=S, height=S, tiles=tiles, capacity=bucket.cap_dense,
                                      slab_tiles=ADENSE_SLAB_TILES, aniso=True)
    state = init_state(scene, adam(1e-3))
    fields = ("mu", "scale", "magnitude", "albedo")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss, ov = slab(state, cam.view_matrix, o, dirs, target)   # warms up
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    after1 = {f: getattr(state.scene, f).clone() for f in fields}
    losses, ovfs = [loss], [ov]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, loss, ov = slab(state, cam.view_matrix, o, dirs, target)
    losses.append(loss)
    ovfs.append(ov)
    last = {}                                 # the third step, under the profiler
    prof = profile_device(lambda _: last.update(out=slab(state, cam.view_matrix, o, dirs,
                                                         target)), range(1))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 2 * 1e3
    state, loss, ov = last["out"]
    losses.append(loss)
    ovfs.append(ov)
    slab_launches = {k.name: k.launches for k in kernels.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    check(all(int(v) == 0 for v in ovfs), "an anisotropic slab step overflowed")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the anisotropic slab step's loss did not fall: {losses}")
    check(slab_launches[cca.CHUNKED_FWD_T_ANISO.name] > 0
          and slab_launches[cca.CHUNKED_BWD_T_ANISO.name] > 0,
          f"the anisotropic slab step did not take the saved-T schedule: {slab_launches}")
    del state

    # the first step once more with the saved-T budget at 0: the recompute
    # backward (kernel 14) on the main path; its loss and update must equal
    # the saved-T step's (the same forward, gradients equal bit for bit)
    budget = cc.SAVE_T_CHUNKED_MAX_BYTES
    cc.SAVE_T_CHUNKED_MAX_BYTES = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_r, loss_r, ov_r = slab(init_state(scene, adam(1e-3)), cam.view_matrix, o, dirs,
                                     target)
        torch.cuda.synchronize()
        recompute_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cc.SAVE_T_CHUNKED_MAX_BYTES = budget
    recompute_launches = {k.name: k.launches for k in kernels.KERNELS}
    recompute_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = abs(float(loss_r) - losses[0]) / abs(losses[0])
    scene_diff = {f: float(((getattr(state_r.scene, f) - want).abs()
                            / (1e-6 + 1e-5 * want.abs())).max()) for f, want in after1.items()}
    del state_r, after1
    emit("aniso_dense_slab_step", slab_tiles=ADENSE_SLAB_TILES, capacity=bucket.cap_dense,
         steps=3, first_step_ms=first_ms, step_ms=step_ms,
         rays_per_s=S * S / (step_ms * 1e-3), losses=losses, launches=slab_launches,
         peak_memory_gb=peak_gb, profile_one_step=prof,
         save_t_budget_0={"step_ms": recompute_ms, "rays_per_s": S * S / (recompute_ms * 1e-3),
                          "loss": float(loss_r), "loss_rel_diff": loss_rel,
                          "scene_diff_over_tolerance": scene_diff,
                          "launches": recompute_launches, "peak_memory_gb": recompute_peak_gb},
         power_limit=smi)
    check(int(ov_r) == 0 and recompute_launches[cca.CHUNKED_BWD_ANISO.name] > 0
          and recompute_launches[cca.CHUNKED_BWD_T_ANISO.name] == 0,
          f"the step at saved-T budget 0 did not run the recompute backward: {recompute_launches}")
    check(loss_rel <= 1e-6 and all(v <= 1.0 for v in scene_diff.values()),
          f"the recompute slab step differs from the saved-T step: {loss_rel}, {scene_diff}")
    del slab, target

    # 5. times at the dense bucket's launch, one call each: every kernel ran
    # at these shapes in the frame and the slab steps, so they are warm
    dcol = cotangent(dense_in, 99)
    pb, qb = ck._block_sizes(c_k)
    kw = dict(ck=c_k, qb=qb)
    t_d = cca.chunked_forward_t_aniso(*dense_in, pb=pb, **kw)[1]
    ms = {cca.CHUNKED_FWD_ANISO.name: time_cuda(
              lambda: cca.chunked_forward_aniso(*dense_in, pb=pb, **kw), iters=1, warmup=0),
          cca.CHUNKED_FWD_T_ANISO.name: time_cuda(
              lambda: cca.chunked_forward_t_aniso(*dense_in, pb=pb, **kw), iters=1, warmup=0)}
    # the backwards, part by part: each chunk's pass A (recompute only), p
    # side, db sum and q side and the row sums by CUDA events; a backward's
    # time is their sum
    n_chunks = n_d // c_k
    parts, names = {}, ("pass_a", "p_side", "db_sum", "q_side")
    for k, t_arg in ((cca.CHUNKED_BWD_ANISO, None), (cca.CHUNKED_BWD_T_ANISO, t_d)):
        part_ms = torch.zeros(4 * n_chunks + 1)
        cca.chunked_backward_aniso(*dense_in, dcol, t_arg, part_ms=part_ms, **kw)
        pm = part_ms.tolist()
        parts[k.name] = {
            "chunks": [{f"{p}_ms": pm[4 * a + i] for i, p in enumerate(names)}
                       for a in range(n_chunks)],
            "rows_ddirs_ms": pm[-1],
            **{f"{p}_total_ms": sum(pm[4 * a + i] for a in range(n_chunks))
               for i, p in enumerate(names)}}
        ms[k.name] = sum(pm)
    del t_d
    b_, n_ = dense_in[2].shape
    r_ = dense_in[4].shape[2]
    rays3, rows10, t_bytes = 4 * 3 * b_ * r_, 4 * 10 * b_ * n_, ck.save_t_bytes(b_, n_, r_)
    nbytes = {cca.CHUNKED_FWD_ANISO.name: scene_bytes(dense_in) + rays3,
              cca.CHUNKED_FWD_T_ANISO.name: scene_bytes(dense_in) + rays3 + t_bytes,
              cca.CHUNKED_BWD_T_ANISO.name: scene_bytes(dense_in) + 2 * rays3 + rows10 + t_bytes,
              cca.CHUNKED_BWD_ANISO.name: scene_bytes(dense_in) + 2 * rays3 + rows10}
    ops = {cca.CHUNKED_FWD_ANISO.name: fwd_ops(dense_in),
           cca.CHUNKED_FWD_T_ANISO.name: fwd_ops(dense_in),
           cca.CHUNKED_BWD_T_ANISO.name: bwd_ops(dense_in, False),
           cca.CHUNKED_BWD_ANISO.name: bwd_ops(dense_in, True)}
    sub_case = results[f"{len(sel)}_tiles"]
    launches = {k: frame_launches[k] + cli_launches[k] + slab_launches[k]
                + recompute_launches[k] for k in frame_launches}
    times, entries = {}, []
    for k in (cca.CHUNKED_FWD_ANISO, cca.CHUNKED_BWD_ANISO, cca.CHUNKED_FWD_T_ANISO,
              cca.CHUNKED_BWD_T_ANISO):
        check(launches[k.name] > 0, f"{k.name} was not launched on an anisotropic dense main path")
        times[k.name] = {"ms": ms[k.name], "fp32_instr": ops[k.name][0],
                         "sfu_ops": ops[k.name][1], "bytes": nbytes[k.name],
                         **bound(*ops[k.name], nbytes[k.name], clock_mhz, n_sm),
                         "plain_ms": sub_case["plain_ms"][k.name],
                         "plain_shape": f"the {len(sel)}-tile case of "
                                        "aniso_dense_kernels_vs_plain, tile by tile",
                         "launches": launches[k.name],
                         "library_ms": "n/a: no single PyTorch call computes it"}
        entries.append({
            "name": k.name, "route": k.route,
            "source": str(k.source.relative_to(nvcc.CSRC_DIR.parents[1])),
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": max(r["abs"][k.name] for r in results.values()),
            "max_rel_err": max(max(r["rel"][k.name].values()) for r in results.values()),
            "ms": ms[k.name], "plain_ms": sub_case["plain_ms"][k.name],
            "bound_ms": times[k.name]["bound_ms"], "bound_by": times[k.name]["bound_by"],
            "library_ms": None})
    emit("aniso_dense_times", shape={"B": b_, "N": n_, "R": r_, "ck": c_k,
                                     "max_count": int(dense_in[5].max()),
                                     "live_pairs": float(np.sum(live_counts(dense_in) ** 2) * r_)},
         kernels=times, backward_parts=parts, power_limit=smi)

    if fused_vs_chunked:
        emit("aniso_dense_fwd_vs_chunked", power_limit=smi, forwards=forwards_vs_chunked(
            (ca.fused_forward_aniso, ca.fused_forward_t_aniso),
            (cca.chunked_forward_aniso, cca.chunked_forward_t_aniso),
            {"sparse_bucket": per_bucket[-1]}))

    # 6. the crossover of the two anisotropic routes: the fused saved-T
    # backward (as the step takes it) and the chunked backward on the
    # densest tiles cut to each count, one call each after a warm-up
    top = torch.argsort(dense_in[5], descending=True, stable=True)[:ADENSE_CROSS_TILES]
    dense8 = [t[top].contiguous() for t in dense_in]
    dcol8 = cotangent(dense8, 98)
    cross = []
    for c in ADENSE_CROSS_COUNTS:
        check(int(dense8[5].min()) >= c, f"a crossover tile holds fewer than {c} rows")
        inp = [t[:, :c].contiguous() for t in dense8[:4]] + [dense8[4],
                                                             torch.clamp(dense8[5], max=c)]
        pb_c, qb_c = ck._block_sizes(c)
        cap_c, ck_c = cc.chunk_plan(c)
        check(cap_c == c, f"the chunk plan of {c} rows pads them to {cap_c}")
        t_c = ca.fused_forward_t_aniso(*inp, pb=pb_c, qb=qb_c)[1]
        if c == ADENSE_CROSS_COUNTS[0]:
            ca.fused_backward_aniso(*inp, dcol8, t_c, qb=qb_c)
            cca.chunked_backward_aniso(*inp, dcol8, ck=ck_c, qb=qb_c)
        fused_ms, g_f = time_once(lambda: ca.fused_backward_aniso(*inp, dcol8, t_c, qb=qb_c))
        chunked_ms, g_c = time_once(lambda: cca.chunked_backward_aniso(*inp, dcol8, ck=ck_c,
                                                                       qb=qb_c))
        cross.append({"count": c, "ck": ck_c, "fused_bwd_t_aniso_ms": fused_ms,
                      "chunked_bwd_aniso_ms": chunked_ms,
                      "max_rel_diff": {n: rel_err(a, b) for n, a, b in
                                       zip(("doc", "dinvd", "dmag", "dalbedo", "ddirs"),
                                           g_c, g_f)}})
        del t_c, g_f, g_c
    emit("aniso_dense_crossover", tiles=ADENSE_CROSS_TILES, rays=dense8[4].shape[2],
         counts=cross, max_bwd_capacity_aniso=ca.MAX_BWD_CAPACITY_ANISO, power_limit=smi)
    return entries


def split_planes(tiled, o, tile_dirs, counts) -> list:
    """The split kernels' inputs (mb, co, sigma, inv, albedo, counts) from
    gathered tiles, as render_tiles_split makes them (prep_terms_t)."""
    import torch

    from sgrt_tpu_torch.ops.cuda_split import prep_terms_t

    with torch.no_grad():
        mb, _, co, inv = prep_terms_t(o[None, None, :], tile_dirs, tiled)
    return [mb.contiguous(), co.contiguous(), tiled.sigma.contiguous(), inv.contiguous(),
            tiled.albedo.contiguous(),
            torch.clamp(counts.to(torch.int32), max=mb.shape[1]).contiguous()]


def split_ops(inp, colors: bool, backward: bool) -> tuple[float, float]:
    """(FP32 instructions, SFU operations) of a split kernel's live work, at
    the fused kernels' per-(p, q, ray) counts without their prep: 5 erf taps
    per live pair, one base erf per (row, ray) of every row, 5 exps per live
    (p, ray); a backward adds the fused backward's pair pass (BWD_PAIR_*) and
    the base path's erf-and-gauss per (row, ray) of every row."""
    c, r = live_counts(inp), inp[0].shape[2]
    b, n = inp[2].shape
    taps = float(np.sum(5 * c * c) * r + b * n * r)
    exps = float(np.sum(5 * c) * r)
    fp32, sfu = TAP_FP32 * taps + EXP_FP32 * exps, TAP_SFU * taps + EXP_SFU * exps
    if backward:
        pairs = float(np.sum(c * c) * r)
        fp32 += BWD_PAIR_FP32 * pairs + (TAP_FP32 + 4) * b * n * r
        sfu += BWD_PAIR_SFU * pairs + TAP_SFU * b * n * r
    return fp32, sfu


def compare_split_kernels(inp, g, dcol, erf_name="as5", exp_name="exact", rb: int = 128,
                          pb: int = 16, qb: int = 32, plain_tolerance: bool = True) -> dict:
    """Kernels 15-18 against their plain versions on `inp` (split_planes'
    list) with the cotangents g (B,N,R) of tw and dcol (B,3,R) of the
    colors: every output on every row against the float32 plain version
    (max |kernel - plain| / max |plain|, within SPLIT_REL when
    plain_tolerance) and, through gate_vs_f64, against a float64 run of the
    plain version."""
    import torch

    from sgrt_tpu_torch.ops import cuda_split as cs

    planes, alb, cnt = inp[:4], inp[4], inp[5]
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    tw = cs.split_forward(*planes, cnt, rb=rb, pb=pb, qb=qb, **kw)
    g_tw = cs.split_backward(*planes, cnt, g, rb=rb, qb=qb, **kw)
    colors = cs.split_forward_color(*planes, alb, cnt, rb=rb, pb=pb, qb=qb, **kw)
    g_col = cs.split_backward_color(*planes, alb, cnt, dcol, rb=rb, qb=qb, **kw)
    torch.cuda.synchronize()
    for x in (tw, colors, *g_tw, *g_col):
        check(bool(torch.isfinite(x).all()), f"a split kernel's output is not finite "
                                             f"({erf_name}/{exp_name})")
    dead = torch.arange(tw.shape[1], device=tw.device)[None, :] >= cnt[:, None].long()
    check(bool((tw[dead] == 0).all()), "split tw is not 0 past the count")
    pin = [*planes, cnt]
    f64 = [x.double() for x in planes]
    p_tw = per_tile(lambda *a: cs.split_forward_plain(*a, **kw), pin)
    r_tw = per_tile(lambda *a: cs.split_forward_plain(*a, **kw), [*f64, cnt])
    p_g = per_tile(lambda *a: cs.split_backward_plain(*a, **kw), pin, g)
    r_g = per_tile(lambda *a: cs.split_backward_plain(*a, **kw), [*f64, cnt], g.double())
    p_c = per_tile(lambda *a: cs.split_forward_color_plain(*a, **kw), [*planes, alb, cnt])
    r_c = per_tile(lambda *a: cs.split_forward_color_plain(*a, **kw), [*f64, alb.double(), cnt])
    p_gc = per_tile(lambda *a: cs.split_backward_color_plain(*a, **kw), [*planes, alb, cnt], dcol)
    r_gc = per_tile(lambda *a: cs.split_backward_color_plain(*a, **kw),
                    [*f64, alb.double(), cnt], dcol.double())
    names = ("dmb", "dco", "dsigma", "dinv", "dalbedo")
    outs = {cs.SPLIT_FWD.name: {"tw": (tw, p_tw, r_tw)},
            cs.SPLIT_BWD.name: {n: (a, b, c) for n, a, b, c in zip(names, g_tw, p_g, r_g)},
            cs.SPLIT_FWD_COLOR.name: {"colors": (colors, p_c, r_c)},
            cs.SPLIT_BWD_COLOR.name: {n: (a, b, c) for n, a, b, c in zip(names, g_col, p_gc, r_gc)}}
    rel, vs_f64, absd, over = gate_vs_f64(outs)
    if plain_tolerance:
        over += [f"{k}.{o}: {v:.3g} vs the float32 plain version" for k, d in rel.items()
                 for o, v in d.items() if v > SPLIT_REL]
    for i in [i for i, c in enumerate(cnt.tolist()) if c <= 0]:
        check(bool((colors[i] == 0).all()) and bool((g_tw[2][i] == 0).all()),
              "a dead tile's split colors or dsigma are not zero")
    return {"rel": rel, "vs_f64": vs_f64, "abs": absd, "over_tolerance": over,
            "shape": {"B": tw.shape[0], "N": tw.shape[1], "R": tw.shape[2], "rb": rb, "pb": pb,
                      "qb": qb,
                      "counts": sorted(set(int(c) for c in cnt.tolist()))[-4:],
                      "max_count": int(cnt.max())}}


def split_phases(dev, smi: str, clock_mhz: float, n_sm: int) -> list:
    """The split kernels (15-18) at the training cell's 30-degree view:
    kernels against their plain versions and a float64 run of them, the
    split render route (prep_terms_t, colors_split) against the fused route
    in colors and scene gradients, the on-card verification entry point
    (sgrt_tpu_torch.verify, whose check 5 launches kernels 15-16), and the
    kernels' times. Returns the kernel line's entries of kernels 15-18."""
    import torch

    from sgrt_tpu_torch import verify
    from sgrt_tpu_torch.models.gaussians import GaussianScene, scene_from_vertices
    from sgrt_tpu_torch.ops import cuda_kernel as ck
    from sgrt_tpu_torch.ops import cuda_split as cs
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for
    from sgrt_tpu_torch.ops.cuda_kernel import _block_sizes, render_tiles_fused
    from sgrt_tpu_torch.ops.frame import orbit_camera, probe_capacity
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.ops.tiling import gather_tiles, tile_indices
    from sgrt_tpu_torch.utils import nvcc

    # 1. the training cell's 30-degree view at its padded capacity
    S = TRAIN_SIZE
    scene = scene_from_vertices(smoke_points(), device=dev)
    capacity = max(64, int(probe_capacity(scene, ANGLES, OFFSET, FOCAL, TRAIN_TILES) * 1.3))
    cap_pad, _ = tile_renderer_for(capacity)
    cam = orbit_camera(30.0, OFFSET, FOCAL, S, S, device=dev)
    o, dirs = cam.rays()
    tile_dirs = _tile_rays(dirs, S, S, TRAIN_TILES)
    idx, counts = tile_indices(scene, cam.view_matrix, TRAIN_TILES, cap_pad, focal_length=FOCAL)
    check(int(counts.max()) <= cap_pad, "the 30-degree view overflows the probed capacity")
    full = split_planes(gather_tiles(scene, idx), o, tile_dirs, counts)
    pb, qb = _block_sizes(cap_pad)
    cnt = full[5].cpu().numpy()
    rng = np.random.default_rng(3)
    dense = int(np.argmax(cnt))
    live = [i for i in np.flatnonzero(cnt > 0) if i != dense]
    sel = [dense] + sorted(rng.choice(live, size=min(SPLIT_SUB_TILES - 1, len(live)),
                                      replace=False).tolist())
    sub = [t[torch.tensor(sel, device=dev)].contiguous() for t in full]

    def cotangents(inp, seed):
        gen = torch.Generator().manual_seed(seed)
        b, n, r = inp[0].shape
        return (torch.randn((b, n, r), generator=gen).to(dev),
                torch.randn((b, 3, r), generator=gen).to(dev))

    # seeded planes with co non-zero on every row (base runs over all N),
    # counts below N, a dead tile and one clamped to N
    gen = torch.Generator().manual_seed(4)
    n = cap_pad
    sig = torch.rand((4, n), generator=gen) * 0.3 + 0.3
    seeded = [t.to(dev).contiguous() for t in (
        torch.randn((4, n, 128), generator=gen), torch.rand((4, n, 128), generator=gen) * 0.01,
        sig, 1.0 / (1.4142135623730951 * sig), torch.rand((4, n, 3), generator=gen),
        torch.tensor([n, 137, 0, 1000], dtype=torch.int32))]
    # the dense cell's densest tile: the 50k sphere at 512^2, 64x32 tiles, 30
    # degrees (4315 rows), padded to SPLIT_DENSE_CAP rows
    sphere = scene_from_vertices(sphere_points(DENSE_N), device=dev)
    cam_d = orbit_camera(DENSE_ANGLE, OFFSET, FOCAL, DENSE_SIZE, DENSE_SIZE, device=dev)
    o_d, dirs_d = cam_d.rays()
    idx_d, counts_d = tile_indices(sphere, cam_d.view_matrix, (64, 32), SPLIT_DENSE_CAP,
                                   focal_length=FOCAL)
    t_d = int(torch.argmax(counts_d))
    check(int(counts_d[t_d]) <= SPLIT_DENSE_CAP, "the dense tile overflows SPLIT_DENSE_CAP")
    dense_tile = split_planes(gather_tiles(sphere, idx_d[t_d:t_d + 1]), o_d,
                              _tile_rays(dirs_d, DENSE_SIZE, DENSE_SIZE, (64, 32))[t_d:t_d + 1],
                              counts_d[t_d:t_d + 1])
    # verify's check 5 (the main path's only tw_split) at its own inputs and
    # tw_split's default blocks, pb 16 and qb 32
    *check5, _ = verify.counts_case(dev)
    check5.insert(4, torch.rand((1, check5[0].shape[1], 3), generator=gen).to(dev))
    cases = {"view_32_tiles": (sub, "as5", "exact", 128, pb, 32, True),
             "coeff_past_count": (seeded, "as5", "exact", 128, pb, 32, True),
             "two_ray_blocks": ([t[:8] for t in sub], "as5", "exact", 64, pb, 32, True),
             "one_tile_as3_fast": ([t[:1] for t in sub], "as3", "fast", 128, pb, 32, True),
             **{f"one_tile_{e}_{x}": ([t[:1] for t in sub], e, x, 128, pb, 32, True)
                for e, x in APPROX_STACKS},
             "dense_tile": (dense_tile, "as5", "exact", 128, pb, 32, False),
             "verify_check5": (check5, "as5", "exact", 128, 16, 32, True)}
    results = {}
    t0 = time.perf_counter()
    for i, (name, (inp, e, x, rb, pb_c, qb_c, tol)) in enumerate(cases.items()):
        g, dcol = cotangents(inp, 50 + i)
        results[name] = compare_split_kernels(inp, g, dcol, e, x, rb, pb_c, qb_c, tol)
    emit("split_kernels_vs_plain", tolerance_rel=SPLIT_REL, seconds=time.perf_counter() - t0,
         densest_count=int(cnt.max()), dense_tile_count=int(counts_d[t_d]), cases=results)
    over = [f"{name}: {o}" for name, r in results.items() for o in r["over_tolerance"]]
    check(not over, f"a split kernel disagrees with its plain version: {over}")

    # 2. main path: the split render route at full width, fwd and bwd,
    # against the fused route (kernels 2-3) in colors and scene gradients
    fields = ("mu", "sigma", "magnitude", "albedo")
    w = torch.randn((idx.shape[0], tile_dirs.shape[1], 3),
                    generator=torch.Generator().manual_seed(5)).to(dev)

    def route(render):
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_(True) for f in fields}
        colors = render(gather_tiles(GaussianScene(**leaves), idx), o, tile_dirs, counts)
        torch.sum(colors * w).backward()
        torch.cuda.synchronize()
        return colors.detach(), {f: leaves[f].grad for f in fields}

    c_fused, g_fused = route(render_tiles_fused)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    c_split, g_split = route(cs.render_tiles_split)
    route_s = time.perf_counter() - t0
    route_launches = {k.name: k.launches for k in kernels.KERNELS}
    check(route_launches[cs.SPLIT_FWD_COLOR.name] > 0 and route_launches[cs.SPLIT_BWD_COLOR.name] > 0,
          f"the split route did not launch kernels 17-18: {route_launches}")
    # Tolerance, the Watch-list's float32 floor (ROADMAP; tests/
    # test_torch_frame.py): two float32 evaluations of the Gaussian exponent
    # that round mb or |oc|^2 one step apart differ by up to 2 ulp(|oc|^2) /
    # (2 sigma^2) of co, relative; the colors and every gradient are sums of
    # terms that carry it. prep_terms_t rounds mb and |oc|^2 as the fused
    # kernels do, so the routes should sit well inside it.
    oc2 = float(torch.max(torch.sum((scene.mu - o) ** 2, dim=-1)))
    ulp = 2.0 ** (np.floor(np.log2(oc2)) - 23)
    floor_rel = 2 * ulp / (2 * float(scene.sigma.min()) ** 2)
    rel = {"colors": rel_err(c_split, c_fused),
           **{f: rel_err(g_split[f], g_fused[f]) for f in fields}}
    emit("split_route", shape={"B": idx.shape[0], "N": cap_pad, "R": tile_dirs.shape[1]},
         seconds=route_s, launches=route_launches, rel_vs_fused=rel, tolerance_rel=floor_rel,
         max_oc_sq=oc2)
    check(all(v <= floor_rel for v in rel.values()),
          f"the split route differs from the fused route: {rel} (floor {floor_rel:.3g})")

    # 3. the on-card verification entry point (full checks)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = verify.run_checks(quick=False, device=dev)
    verify_s = time.perf_counter() - t0
    verify_launches = {k.name: k.launches for k in kernels.KERNELS}
    emit("verify", seconds=verify_s, launches=verify_launches, **report)
    check(report["parity_ok"], f"sgrt_tpu_torch.verify failed: {report['checks']}")
    check(verify_launches[cs.SPLIT_FWD.name] > 0 and verify_launches[cs.SPLIT_BWD.name] > 0,
          f"verify's check 5 did not launch kernels 15-16: {verify_launches}")

    # 4. times at full width (the route's blocks), plain ms on the subset
    g, dcol = cotangents(full, 60)
    planes, alb, cnt_t = full[:4], full[4], full[5]
    runs = {cs.SPLIT_FWD: lambda: cs.split_forward(*planes, cnt_t, pb=pb, qb=qb),
            cs.SPLIT_BWD: lambda: cs.split_backward(*planes, cnt_t, g, qb=qb),
            cs.SPLIT_FWD_COLOR: lambda: cs.split_forward_color(*planes, alb, cnt_t, pb=pb, qb=qb),
            cs.SPLIT_BWD_COLOR: lambda: cs.split_backward_color(*planes, alb, cnt_t, dcol, qb=qb)}
    g_s, dcol_s = cotangents(sub, 61)
    plain_runs = {cs.SPLIT_FWD: lambda: cs.split_forward_plain(*sub[:4], sub[5]),
                  cs.SPLIT_BWD: lambda: cs.split_backward_plain(*sub[:4], sub[5], g_s),
                  cs.SPLIT_FWD_COLOR: lambda: cs.split_forward_color_plain(*sub),
                  cs.SPLIT_BWD_COLOR: lambda: cs.split_backward_color_plain(*sub, dcol_s)}
    plane = 4 * full[0].numel()
    rows = 4 * full[2].numel()
    # bytes, each input read once and each output written once: the planes
    # (mb, co; g or dmb, dco; tw), per-row sigma, inv (albedo) and the rays'
    # dcol / colors
    rays3 = 4 * 3 * full[0].shape[0] * full[0].shape[2]
    nbytes = {cs.SPLIT_FWD: 3 * plane + 2 * rows, cs.SPLIT_BWD: 5 * plane + 4 * rows,
              cs.SPLIT_FWD_COLOR: 2 * plane + 5 * rows + rays3,
              cs.SPLIT_BWD_COLOR: 4 * plane + 10 * rows + rays3}
    times, entries = {}, []
    launches = {cs.SPLIT_FWD: verify_launches[cs.SPLIT_FWD.name],
                cs.SPLIT_BWD: verify_launches[cs.SPLIT_BWD.name],
                cs.SPLIT_FWD_COLOR: route_launches[cs.SPLIT_FWD_COLOR.name],
                cs.SPLIT_BWD_COLOR: route_launches[cs.SPLIT_BWD_COLOR.name]}
    for k, fn in runs.items():
        ms = time_cuda(fn, iters=5, warmup=1)
        plain_ms = time_cuda(plain_runs[k], iters=1, warmup=0)
        fp32, sfu = split_ops(full, k in (cs.SPLIT_FWD_COLOR, cs.SPLIT_BWD_COLOR),
                              k in (cs.SPLIT_BWD, cs.SPLIT_BWD_COLOR))
        b = bound(fp32, sfu, nbytes[k], clock_mhz, n_sm)
        times[k.name] = {"ms": ms, "plain_ms": plain_ms, "fp32_instr": fp32, "sfu_ops": sfu,
                         "bytes": nbytes[k], **b, "launches": launches[k],
                         "library_ms": "n/a: no single PyTorch call computes it"}
        entries.append({
            "name": k.name, "route": k.route,
            "source": str(k.source.relative_to(nvcc.CSRC_DIR.parents[1])),
            "replaces": k.replaces, "launches": launches[k],
            "max_abs_err": max(r["abs"][k.name] for r in results.values()),
            "max_rel_err": max(max(r["rel"][k.name].values()) for r in results.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None})
    # each kernel's launches by device time (torch.profiler, one call) and
    # its peak memory above what the inputs hold; each backward's parts
    # (csrc/chunked.cu at one chunk: the forward-with-T, p side, db sum, q
    # side and rows kernel, by CUDA events, one call); kernels 1, 2 and 4
    # (the fused forward, forward-with-T and recompute backward) on the same
    # gathered tiles as the yardsticks of the same pair work
    part_runs = {
        cs.SPLIT_BWD: lambda pm: cs.split_backward(*planes, cnt_t, g, qb=qb, part_ms=pm),
        cs.SPLIT_BWD_COLOR: lambda pm: cs.split_backward_color(*planes, alb, cnt_t, dcol, qb=qb,
                                                               part_ms=pm)}
    for k in runs:
        if k in part_runs:
            pm = torch.zeros(5)
            part_runs[k](pm)
            times[k.name]["parts"] = one_chunk_parts(pm)
        times[k.name]["profile"] = profile_device(lambda _, fn=runs[k]: fn(), [0])
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs[k]()
        torch.cuda.synchronize()
        times[k.name]["peak_memory_gb"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    fused_inp = launch_inputs(gather_tiles(scene, idx), o, tile_dirs, counts)
    yard_parts = torch.zeros(5)
    ck.fused_backward(*fused_inp, dcol, qb=qb, part_ms=yard_parts)
    yard_runs = {ck.FUSED_FWD: lambda: ck.fused_forward(*fused_inp, pb=pb, qb=qb),
                 ck.FUSED_FWD_T: lambda: ck.fused_forward_t(*fused_inp, pb=pb, qb=qb),
                 ck.FUSED_BWD: lambda: ck.fused_backward(*fused_inp, dcol, qb=qb)}
    yardsticks = {k.name: {"ms": time_cuda(fn, iters=5, warmup=1)} for k, fn in yard_runs.items()}
    yardsticks[ck.FUSED_BWD.name]["parts"] = one_chunk_parts(yard_parts)
    emit("split_times", shape={"B": full[0].shape[0], "N": full[0].shape[1],
                               "R": full[0].shape[2], "max_count": int(cnt.max()), "pb": pb,
                               "qb": qb},
         plain_shape=f"the {len(sel)}-tile subset", kernels=times, yardsticks=yardsticks,
         power_limit=smi)
    return entries


def _terms_matmul(o, dirs, scene, erf_fn, exp_fn):
    """The torch route's per-(ray, Gaussian) terms (ops/render.py,
    _ray_gaussian_terms) with mu_bar as one matrix product and |oc|^2 as
    torch.sum, the form that route had before it took the kernels'
    rounding; kept only to time against it (--torch-route)."""
    import torch

    from sgrt_tpu_torch.ops.render import INV_SQRT_2_PI, SQRT_2

    oc = scene.mu - o
    oc_sq = torch.sum(oc * oc, dim=-1)
    mu_bar = dirs @ oc.transpose(-1, -2)
    inv_2s2 = 1.0 / (2.0 * scene.sigma**2)
    cbar = scene.magnitude[..., None, :] * exp_fn(
        -(oc_sq[..., None, :] - mu_bar**2) * inv_2s2[..., None, :])
    coeff = (scene.sigma * INV_SQRT_2_PI)[..., None, :] * cbar
    inv = 1.0 / (SQRT_2 * scene.sigma)
    base = torch.sum(coeff * erf_fn(-mu_bar * inv[..., None, :]), dim=-1)
    return mu_bar, cbar, coeff, inv, base


def torch_route_times(dev, smi: str) -> None:
    """The torch route (backend="torch") with its terms as ordered products
    (ops/render.py, as the kernels round them) and as the matrix product
    (_terms_matmul), at the training cell: the 30-degree frame and the
    north-star train step (Adam included), in the order matmul, ordered,
    ordered, matmul; ms by CUDA events and the step's peak memory."""
    import torch

    from sgrt_tpu_torch.models.gaussians import scene_from_vertices
    from sgrt_tpu_torch.ops import render as render_mod
    from sgrt_tpu_torch.ops.frame import orbit_camera, probe_capacity, render_orbit_frame
    from sgrt_tpu_torch.parallel.fit import adam, init_state, make_frame_train_step

    S = TRAIN_SIZE
    scene = scene_from_vertices(smoke_points(), device=dev)
    capacity = max(64, int(probe_capacity(scene, ANGLES, OFFSET, FOCAL, TRAIN_TILES) * 1.3))
    cam = orbit_camera(30.0, OFFSET, FOCAL, S, S, device=dev)
    o, dirs = cam.rays()
    kw = dict(width=S, height=S, tiles=TRAIN_TILES, capacity=capacity, backend="torch")
    with torch.no_grad():
        target, _ = render_orbit_frame(scene, 35.0, OFFSET, FOCAL, **kw)
    step = make_frame_train_step(**kw)
    forms = {"matmul": _terms_matmul, "ordered": render_mod._ray_gaussian_terms}
    runs = []
    try:
        for form in ("matmul", "ordered", "ordered", "matmul"):
            render_mod._ray_gaussian_terms = forms[form]
            with torch.no_grad():
                frame_ms = time_cuda(
                    lambda: render_orbit_frame(scene, 30.0, OFFSET, FOCAL, **kw), 3, 1)
            state = init_state(scene, adam(1e-3))
            step(state, cam.view_matrix, o, dirs, target)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_ms = time_cuda(lambda: step(state, cam.view_matrix, o, dirs, target), 3, 0)
            runs.append({"terms": form, "frame_ms": frame_ms, "step_ms": step_ms,
                         "step_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    finally:
        render_mod._ray_gaussian_terms = forms["ordered"]
    emit("torch_route_terms", size=S, tiles=list(TRAIN_TILES), capacity=capacity, runs=runs,
         power_limit=smi)


def serving_frame0(scene, dev) -> tuple:
    """Frame 0 of the serving path (the CLI's tiled orbit at SIZE, TILES
    tiles): the probed capacity, the capacity the router pads it to, and
    the fused forward's launch inputs."""
    from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for
    from sgrt_tpu_torch.ops.frame import orbit_camera, probe_capacity
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.ops.tiling import gather_tiles, tile_indices

    capacity = max(32, int(probe_capacity(scene, ANGLES, OFFSET, FOCAL, TILES) * 1.25))
    cap, _ = tile_renderer_for(capacity)
    cam = orbit_camera(0.0, OFFSET, FOCAL, SIZE, SIZE, device=dev)
    o, dirs = cam.rays()
    idx, counts = tile_indices(scene, cam.view_matrix, TILES, cap, focal_length=FOCAL)
    check(int(counts.max()) <= cap, "frame 0 overflows the probed capacity")
    return capacity, cap, launch_inputs(gather_tiles(scene, idx), o,
                                        _tile_rays(dirs, SIZE, SIZE, TILES), counts)


def serving_phases(dev, smi: str, clock_mhz: float, n_sm: int) -> dict:
    """The serving path: the fused forwards against their plain versions
    and float64 on frame 0, the CLI's 8-frame orbit, the untiled route, a
    reference frame, and the kernel's times. Returns the kernel line's
    entry of the fused forward."""
    import torch

    from sgrt_tpu_torch import cli
    from sgrt_tpu_torch.models.gaussians import grid_scene, scene_from_vertices
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.cuda_kernel import (FUSED_FWD, _block_sizes,
                                                fused_forward, fused_forward_plain)
    from sgrt_tpu_torch.ops.frame import render_orbit_frame
    from sgrt_tpu_torch.utils import nvcc

    # 1. kernel vs plain on frame 0 of the smoke scene
    scene = scene_from_vertices(smoke_points(), device=dev)
    capacity, cap, frame_in = serving_frame0(scene, dev)
    pb, qb = _block_sizes(cap)
    cnt = frame_in[5].cpu().numpy()
    dense = int(np.argmax(cnt))
    live = [i for i in np.flatnonzero(cnt > 0) if i != dense]
    rng = np.random.default_rng(1)
    pick = [dense] + sorted(rng.choice(live, size=min(31, len(live)), replace=False).tolist())
    sel = torch.tensor(pick, device=dev)
    sub = [t[sel].contiguous() for t in frame_in]
    one = [t[:1] for t in sub]
    cases = {f"{erf_name}/{exp_name}": compare_fused_forwards(rows, erf_name, exp_name)
             for erf_name, exp_name, rows in (("as5", "exact", sub), ("as3", "fast", one),
                                              *((e, x, one) for e, x in APPROX_STACKS))}
    errs = {name: c["abs"][FUSED_FWD.name] for name, c in cases.items()}
    emit("kernel_vs_plain", kernel=FUSED_FWD.name, capacity=capacity, padded_capacity=cap,
         tiles=len(pick), densest_tile=dense, densest_count=int(cnt[dense]),
         live_tiles=int((cnt > 0).sum()), max_abs_err=errs, atol=KERNEL_ATOL, cases=cases)
    over = [f"{name}: {o}" for name, c in cases.items() for o in c["over_tolerance"]]
    check(not over, f"a fused forward disagrees with its plain version on frame 0: {over}")

    # 2. main path: the CLI renders an 8-frame orbit through the kernel
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "cube_cloud.obj")
        write_obj(obj, smoke_points())
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
        check(main_launches[FUSED_FWD.name] > 0,
              f"the forward kernel was not launched on the serving path: {main_launches}")
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

    # 3. times at the main path's shapes (frame 0: all tiles, padded capacity)
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

    return {"name": FUSED_FWD.name, "route": FUSED_FWD.route,
            "source": str(FUSED_FWD.source.relative_to(nvcc.CSRC_DIR.parents[1])),
            "replaces": FUSED_FWD.replaces, "launches": main_launches[FUSED_FWD.name],
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": "operations" if bound_s > t_bytes else "bytes", "library_ms": None}


def approx_phases(dev, smi: str, clock_mhz: float, n_sm: int, obj: str) -> None:
    """Every erf and exp name on the kernels' main paths: the reference's
    img-error at its own 256x256 per stack (MSE against the oracle under
    tests/test_img_error.py's bounds, the forward kernel launched once a
    stack); per timed stack the serving CLI's orbit and kernel 1 at its
    frame 0, and kernels 2 and 3 at the training view, each beside its
    bound; the north-star train step under spline_mirror/spline on the
    saved-T schedule and at a saved-T budget of 0."""
    import torch

    from sgrt_tpu_torch import cli
    from sgrt_tpu_torch.models.camera import Camera
    from sgrt_tpu_torch.models.gaussians import grid_scene, scene_from_vertices
    from sgrt_tpu_torch.ops import cuda_kernel as ck
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.cuda_chunked import tile_renderer_for
    from sgrt_tpu_torch.ops.frame import orbit_camera, probe_buckets, probe_capacity
    from sgrt_tpu_torch.ops.frame import render_orbit_frame
    from sgrt_tpu_torch.ops.reference import render_rays_reference
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.ops.tiling import gather_tiles, tile_indices
    from sgrt_tpu_torch.parallel.fit import adam, init_state, make_frame_train_step

    # 1. img-error: the 16x16 grid (sigma 1/4, magnitude 3) seen from z = -4
    grid = grid_scene(16, sigma=0.25, magnitude=3.0, device=dev)
    cam = Camera.create(position=(0.0, 0.0, -4.0), width=IMG_ERROR_SIZE,
                        height=IMG_ERROR_SIZE, device=dev)
    o, dirs = cam.rays()
    t0 = time.perf_counter()
    ref = render_rays_reference(o, dirs, grid, chunk=256)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    check(bool(torch.isfinite(ref).all()), "the img-error oracle is not finite")
    stacks = {}
    for e, x, limit in IMG_ERROR_STACKS:
        kernels.reset_launch_counts()
        img = ck.render_rays_fused_impl(o, dirs, grid, erf_name=e, exp_name=x)
        torch.cuda.synchronize()
        stacks[f"{e}/{x}"] = {"mse": float(torch.mean((img - ref) ** 2)), "bound": limit,
                              "launches": {k.name: k.launches for k in kernels.KERNELS
                                           if k.launches},
                              "finite": bool(torch.isfinite(img).all()),
                              "max": float(img.abs().max())}
    emit("approx_img_error", size=IMG_ERROR_SIZE, scene="grid_scene(16, sigma=0.25, "
         "magnitude=3.0)", oracle_seconds=oracle_s, stacks=stacks)
    bad = [k for k, v in stacks.items() if not (v["finite"] and v["mse"] <= v["bound"]
                                                and v["max"] > 0.01
                                                and v["launches"] == {ck.FUSED_FWD.name: 1})]
    check(not bad, f"an img-error stack is over its bound or missed the kernel: {bad}")

    # 2. serving per stack: the CLI's orbit (the serving main path) and
    # kernel 1 at frame 0
    scene = scene_from_vertices(smoke_points(), device=dev)
    _, cap, frame_in = serving_frame0(scene, dev)
    pb, qb = ck._block_sizes(cap)
    b_, n_ = frame_in[1].shape
    f_bytes = 4 * (b_ * n_ * 8 + 2 * b_ * 3 * frame_in[4].shape[2] + b_)
    # kernels 2 and 3 at the training view (the north-star step's tiles at
    # its probed capacity, camera at 30 degrees)
    S = TRAIN_SIZE
    capacity = max(64, int(probe_capacity(scene, ANGLES, OFFSET, FOCAL, TRAIN_TILES) * 1.3))
    cap_t, _ = tile_renderer_for(capacity)
    tcam = orbit_camera(30.0, OFFSET, FOCAL, S, S, device=dev)
    to, tdirs = tcam.rays()
    idx, counts = tile_indices(scene, tcam.view_matrix, TRAIN_TILES, cap_t, focal_length=FOCAL)
    train_in = launch_inputs(gather_tiles(scene, idx), to, _tile_rays(tdirs, S, S, TRAIN_TILES),
                             counts)
    tpb, tqb = ck._block_sizes(cap_t)
    dcol = torch.randn((train_in[0].shape[0], 3, train_in[4].shape[2]),
                       generator=torch.Generator().manual_seed(80)).to(dev)
    t_bytes = ck.save_t_bytes(train_in[0].shape[0], train_in[0].shape[1], train_in[4].shape[2])
    rays3 = 4 * 3 * train_in[0].shape[0] * train_in[4].shape[2]
    rows8 = 4 * 8 * train_in[0].shape[0] * train_in[0].shape[1]
    per_stack = {}
    for e, x in TIMED_STACKS:
        png = os.path.join(os.path.dirname(obj), f"orbit_{e}_{x}.png")
        argv = ["-f", obj, "-w", str(SIZE), "--height", str(SIZE), "--tiles",
                f"{TILES[0]}x{TILES[1]}", "--frames", str(FRAMES), "-q", "-o", png,
                "--erf", e, "--exp", x]
        stdout, stderr = io.StringIO(), io.StringIO()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = cli.main(argv)
        launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
        check(rc == 0, f"cli --erf {e} --exp {x} exited {rc}: {stderr.getvalue()[-2000:]}")
        check(set(launches) == {ck.FUSED_FWD.name},
              f"cli --erf {e} --exp {x} did not run the forward kernel alone: {launches}")
        check("overflow" not in stderr.getvalue(), stderr.getvalue()[-2000:])
        avg = re.search(r"AVG\. TIME: ([\d.]+) ms", stdout.getvalue())
        check(avg is not None, f"no AVG. TIME line: {stdout.getvalue()!r}")
        imgs = [read_png_rgba(png.replace(".png", f"_{i}.png")) for i in range(1, FRAMES + 1)]
        check(all(int(im[..., :3].max()) > 0 for im in imgs), f"a {e}/{x} frame is black")
        kw = dict(erf_name=e, exp_name=x)
        ms1 = time_cuda(lambda: ck.fused_forward(*frame_in, pb=pb, qb=qb, **kw), iters=10)
        colors, t = ck.fused_forward_t(*train_in, pb=tpb, qb=tqb, **kw)
        ms2 = time_cuda(lambda: ck.fused_forward_t(*train_in, pb=tpb, qb=tqb, **kw), iters=5)
        ms3 = time_cuda(lambda: ck.fused_backward(*train_in, dcol, t, qb=tqb, **kw), iters=5)
        grads = ck.fused_backward(*train_in, dcol, t, qb=tqb, **kw)
        check(all(bool(torch.isfinite(g).all()) for g in (colors, t, *grads)),
              f"a training kernel's output is not finite under {e}/{x}")
        per_stack[f"{e}/{x}"] = {
            "cli_avg_time_ms": float(avg.group(1)), "cli_launches": launches,
            "mean_rgb": [round(float(im[..., :3].mean()), 3) for im in imgs],
            ck.FUSED_FWD.name: {"ms": ms1, **bound(*fwd_ops(frame_in, e, x), f_bytes,
                                                   clock_mhz, n_sm)},
            ck.FUSED_FWD_T.name: {"ms": ms2, **bound(*fwd_ops(train_in, e, x),
                                                     scene_bytes(train_in) + rays3 + t_bytes,
                                                     clock_mhz, n_sm)},
            ck.FUSED_BWD_T.name: {"ms": ms3, **bound(*bwd_ops(train_in, False, e, x),
                                                     scene_bytes(train_in) + 2 * rays3 + rows8
                                                     + t_bytes, clock_mhz, n_sm)}}
    emit("approx_times", serving_shape={"B": b_, "N": n_, "R": frame_in[4].shape[2]},
         train_shape={"B": train_in[0].shape[0], "N": train_in[0].shape[1],
                      "R": train_in[4].shape[2]}, stacks=per_stack, power_limit=smi)

    # 3. the north-star train step under spline_mirror/spline: saved-T,
    # then at a saved-T budget of 0 (the recompute backward)
    e, x = "spline_mirror", "spline"
    bucket = probe_buckets(scene, ANGLES, OFFSET, FOCAL, TRAIN_TILES, margin=1.3)
    target, ovf = render_orbit_frame(scene, 35.0, OFFSET, FOCAL, width=S, height=S,
                                     tiles=TRAIN_TILES, capacity=capacity, backend="kernel",
                                     bucket_cfg=bucket, erf_name=e, exp_name=x)
    check(int(ovf) == 0, "the target frame overflowed")
    runs = {}
    budget = ck.SAVE_T_MAX_BYTES
    for name, limit, steps in (("saved_t", budget, 5), ("recompute", 0, 3)):
        ck.SAVE_T_MAX_BYTES = limit
        try:
            step = make_frame_train_step(width=S, height=S, tiles=TRAIN_TILES,
                                         capacity=capacity, backend="kernel", erf_name=e,
                                         exp_name=x, bucket_cfg=bucket)
            state = init_state(scene, adam(1e-3))
            kernels.reset_launch_counts()
            losses = []
            for i in range(steps):
                if i == 1:   # the first step warms up
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                state, loss, ovf = step(state, tcam.view_matrix, to, tdirs, target)
                check(int(ovf) == 0, "a train step overflowed")
                losses.append(loss)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
            losses = [float(v) for v in losses]
        finally:
            ck.SAVE_T_MAX_BYTES = budget
        params = [state.scene.mu, state.scene.sigma, state.scene.magnitude,
                  state.scene.albedo]
        runs[name] = {"losses": losses, "step_ms": step_ms,
                      "launches": {k.name: k.launches for k in kernels.KERNELS if k.launches},
                      "finite": all(np.isfinite(losses)) and all(bool(torch.isfinite(p).all())
                                                                  for p in params)}
    emit("approx_train_step", stack=f"{e}/{x}", runs=runs, power_limit=smi)
    for name, r in runs.items():
        check(r["finite"] and r["losses"][-1] < r["losses"][0],
              f"the {e}/{x} train step ({name}) is not finite or its loss did not fall: {r}")
    check(runs["saved_t"]["launches"].get(ck.FUSED_BWD_T.name, 0) > 0
          and runs["recompute"]["launches"].get(ck.FUSED_BWD.name, 0) > 0
          and ck.FUSED_BWD_T.name not in runs["recompute"]["launches"],
          f"the {e}/{x} train steps missed a backward kernel: {runs}")
    np.testing.assert_allclose(runs["recompute"]["losses"], runs["saved_t"]["losses"][:3],
                               rtol=1e-4)


def two_bucket_config(scene, tiles, margin: float):
    """A two-bucket BucketConfig over the sample ANGLES (the densest eighth
    of the tiles at the worst count, the rest at the worst count outside
    it, both x margin), for when probe_buckets' cost model keeps one."""
    import torch

    from sgrt_tpu_torch.ops.frame import orbit_camera
    from sgrt_tpu_torch.ops.scheduler import BucketConfig
    from sgrt_tpu_torch.ops.tiling import as_grid, tile_membership

    t2 = as_grid(tiles)[0] * as_grid(tiles)[1]
    worst = None
    for a in ANGLES:
        view = orbit_camera(a, OFFSET, FOCAL, 8, 8, device=scene.device).view_matrix
        c = torch.sort(torch.sum(tile_membership(scene, view, tiles, focal_length=FOCAL),
                                 dim=-1), descending=True).values
        worst = c if worst is None else torch.maximum(worst, c)
    worst = worst.cpu().numpy()
    n_dense = t2 // 8
    return BucketConfig(n_dense, max(32, int(worst[0] * margin)),
                        max(32, int(worst[n_dense] * margin)))


def frontends_phases(dev, smi: str, clock_mhz: float, n_sm: int) -> dict:
    """The front ends a user of one card reaches beside the CLI: the batched
    orbit at the serving cell (8 frames in one launch of kernel 1, each
    frame equal to the per-frame render; the per-frame loop and the batched
    call timed in turns, with their device profiles), the bucketed batched
    orbit at the training cell's size with a partial batch, render_tiled
    against the kernel route on frame 0, the viewer over HTTP (isotropic
    tiled and untiled, anisotropic tiled at sx=3, after an edit), and the
    native PNG writer against the Python encoder. Returns the batched
    launch of kernel 1, for its entry of the kernel line."""
    import threading
    import urllib.request

    import torch

    from sgrt_tpu_torch import viewer
    from sgrt_tpu_torch.models.gaussians import scene_from_vertices
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.cuda_aniso import FUSED_FWD_ANISO
    from sgrt_tpu_torch.ops.cuda_chunked_aniso import CHUNKED_FWD_ANISO
    from sgrt_tpu_torch.ops.cuda_kernel import FUSED_FWD, _block_sizes, fused_forward
    from sgrt_tpu_torch.ops.frame import (orbit_camera, probe_buckets, render_orbit_frame,
                                          render_orbit_frames_batched)
    from sgrt_tpu_torch.ops.render import _tile_rays, render_tiled
    from sgrt_tpu_torch.ops.tiling import gather_tiles, tile_indices
    from sgrt_tpu_torch.utils import native
    from sgrt_tpu_torch.utils.image import encode_png, to_rgba_u8

    scene = scene_from_vertices(smoke_points(), device=dev)
    capacity, cap, _ = serving_frame0(scene, dev)
    angles = [i * 360.0 / FRAMES for i in range(FRAMES)]
    kw = dict(width=SIZE, height=SIZE, tiles=TILES, capacity=capacity)

    def loop():
        return [render_orbit_frame(scene, a, OFFSET, FOCAL, backend="kernel", **kw)
                for a in angles]

    def batched():
        return render_orbit_frames_batched(scene, angles, OFFSET, FOCAL, batch_frames=FRAMES,
                                           **kw)

    # 1. the batched orbit at the serving cell: one launch, frames equal
    per_frame = loop()
    kernels.reset_launch_counts()
    imgs, ovf = batched()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    check(launches == {FUSED_FWD.name: 1},
          f"the batched orbit did not run kernel 1 once: {launches}")
    check(int(ovf) == 0 and all(int(o) == 0 for _, o in per_frame), "the orbit overflowed")
    equal = [bool(torch.equal(imgs[i], im)) for i, (im, _) in enumerate(per_frame)]
    check(all(equal), f"batched frames differ from the per-frame renders: {equal}")
    check(all(float(im.max()) > 0.05 for im, _ in per_frame), "an orbit frame is black")

    # kernel 1's batched launch beside the per-frame one (frame 0), by CUDA
    # events, against the per-frame launches' colors
    inputs = []
    for a in angles:
        cam = orbit_camera(a, OFFSET, FOCAL, SIZE, SIZE, device=dev)
        o, dirs = cam.rays()
        idx, counts = tile_indices(scene, cam.view_matrix, TILES, cap, focal_length=FOCAL)
        inputs.append(launch_inputs(gather_tiles(scene, idx), o,
                                    _tile_rays(dirs, SIZE, SIZE, TILES), counts))
    big = [torch.cat(ts).contiguous() for ts in zip(*inputs)]
    pb, qb = _block_sizes(cap)
    colors = fused_forward(*big, pb=pb, qb=qb)
    one = torch.cat([fused_forward(*inp, pb=pb, qb=qb) for inp in inputs])
    check(bool(torch.equal(colors, one)), "kernel 1's batched launch differs from its "
          "per-frame launches")
    b_big, n_big = big[1].shape
    r_big = big[4].shape[2]
    ms_big = time_cuda(lambda: fused_forward(*big, pb=pb, qb=qb), iters=5)
    ms_one = time_cuda(lambda: fused_forward(*inputs[0], pb=pb, qb=qb), iters=20)
    bytes_big = scene_bytes(big) + 4 * 3 * b_big * r_big
    batched_launch = {"shape": {"B": b_big, "N": n_big, "R": r_big}, "frames": FRAMES,
                      "ms": ms_big, "ms_per_frame": ms_big / FRAMES, "per_frame_launch_ms": ms_one,
                      "gathered_mb": sum(t.numel() * t.element_size() for t in big) / 1e6,
                      **bound(*fwd_ops(big), bytes_big, clock_mhz, n_sm)}

    # the per-frame loop and the batched call in turns, 8 frames a round
    batched(), loop()                       # warm up both
    rounds = {"loop": [], "batched": []}
    for r in range(6):
        for name in (("loop", "batched") if r % 2 == 0 else ("batched", "loop")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (loop if name == "loop" else batched)()
            torch.cuda.synchronize()
            rounds[name].append((time.perf_counter() - t0) * 1e3 / FRAMES)
    turns = {name: {"ms_per_frame": v, "median_ms_per_frame": float(np.median(v)),
                    "spread": (max(v) - min(v)) / float(np.median(v))}
             for name, v in rounds.items()}
    turns["loop"]["profile"] = profile_device(
        lambda a: render_orbit_frame(scene, a, OFFSET, FOCAL, backend="kernel", **kw), angles)
    turns["batched"]["profile"] = profile_device(lambda _: batched(), [0])
    emit("frontends_orbit", size=SIZE, tiles=list(TILES), capacity=capacity,
         padded_capacity=cap, frames=FRAMES, batch_frames=FRAMES, launches=launches,
         frames_equal=equal, batched_launch=batched_launch, turns=turns, power_limit=smi)

    # 2. the bucketed batched orbit at the training cell's size: 5 frames in
    # batches of 3 (the last partial), each frame equal to the per-frame
    # bucketed render
    S, tangles = TRAIN_SIZE, [0.0, 25.0, 50.0, 75.0, 100.0]
    probed = probe_buckets(scene, ANGLES, OFFSET, FOCAL, TRAIN_TILES, margin=1.2)
    cfgs = {"probed": probed}
    if not probed.n_dense:
        cfgs["two_buckets"] = two_bucket_config(scene, TRAIN_TILES, 1.2)
    bucketed = {}
    for name, cfg in cfgs.items():
        bkw = dict(width=S, height=S, tiles=TRAIN_TILES, capacity=cfg.cap_dense, bucket_cfg=cfg)
        ref = [render_orbit_frame(scene, a, OFFSET, FOCAL, backend="kernel", **bkw)
               for a in tangles]
        kernels.reset_launch_counts()
        b_imgs, b_ovf = render_orbit_frames_batched(scene, tangles, OFFSET, FOCAL,
                                                    batch_frames=3, **bkw)
        torch.cuda.synchronize()
        b_launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
        b_equal = [bool(torch.equal(b_imgs[i], im)) for i, (im, _) in enumerate(ref)]
        bucketed[name] = {"config": list(cfg), "launches": b_launches, "frames_equal": b_equal,
                          "overflow": int(b_ovf), "per_frame_overflow": [int(o) for _, o in ref]}
        check(all(b_equal), f"bucketed batched frames ({name}) differ: {b_equal}")
        check(int(b_ovf) == sum(int(o) for _, o in ref), f"bucketed overflow: {bucketed}")
        want = 2 * (2 if cfg.n_dense else 1)      # two batches of one or two launches
        check(sum(b_launches.values()) == want, f"bucketed batched launches ({name}): "
              f"{b_launches}, want {want}")
    emit("frontends_bucketed_orbit", size=S, tiles=list(TRAIN_TILES), frames=len(tangles),
         batch_frames=3, runs=bucketed)

    # 3. render_tiled (the plain renderer, tiled and culled) on frame 0
    cam0 = orbit_camera(0.0, OFFSET, FOCAL, SIZE, SIZE, device=dev)
    t0 = time.perf_counter()
    tiled_img = render_tiled(scene, cam0, tiles=TILES, tile_batch=8)
    torch.cuda.synchronize()
    tiled_s = time.perf_counter() - t0
    tiled_err = float((tiled_img - per_frame[0][0]).abs().max())
    emit("frontends_render_tiled", size=SIZE, tiles=list(TILES), seconds=tiled_s,
         max_abs_err_vs_kernel_route=tiled_err, bound=2.0 / 255.0)
    check(tiled_err <= 2.0 / 255.0, f"render_tiled differs from the kernel route by {tiled_err}")

    # 4. the viewer over HTTP on the card
    srv = viewer.make_server(scene, width=VIEWER_SIZE, height=VIEWER_SIZE, tiles=VIEWER_TILES,
                             port=0)
    stage = srv.RequestHandlerClass.scene_stage
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    views = {}
    try:
        kernels.reset_launch_counts()
        for name, query, edit in (("iso_tiled", "angle=30&tiled=1", None),
                                  ("iso_untiled", "angle=30&tiled=0", None),
                                  ("aniso_tiled_sx3", "angle=30&tiled=1&sx=3", None),
                                  ("after_edit", "angle=30&tiled=1", "index=0&magnitude=4")):
            if edit:
                with urllib.request.urlopen(f"{base}/edit?{edit}", timeout=300) as r:
                    check(json.loads(r.read())["ok"], f"viewer edit {edit} failed")
            with urllib.request.urlopen(f"{base}/render?{query}", timeout=300) as r:
                headers, body = dict(r.headers), r.read()
            png = decode_png_rgba(body, name)
            q = dict(kv.split("=") for kv in query.split("&"))
            direct, _ = viewer.render_query(stage.snapshot(), q, VIEWER_SIZE, VIEWER_SIZE,
                                            VIEWER_TILES, srv.RequestHandlerClass.tile_capacity)
            views[name] = {"render_ms": float(headers["X-Render-Ms"]),
                           "overflow": int(headers["X-Overflow"]),
                           "max_rgb": int(png[..., :3].max()),
                           "equals_direct": bool(np.array_equal(
                               png, to_rgba_u8(direct.cpu().numpy())))}
        v_launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    emit("frontends_viewer", size=VIEWER_SIZE, tiles=VIEWER_TILES, capacity=srv.RequestHandlerClass.tile_capacity,
         views=views, launches=v_launches)
    bad = [n for n, v in views.items()
           if not (v["overflow"] == 0 and v["max_rgb"] > 0 and v["equals_direct"])]
    check(not bad, f"viewer images overflowed, are black or differ from direct renders: {bad}")
    check(v_launches.get(FUSED_FWD.name, 0) > 0 and v_launches.get(FUSED_FWD_ANISO.name, 0)
          + v_launches.get(CHUNKED_FWD_ANISO.name, 0) > 0,
          f"the viewer missed kernel 1 or the anisotropic forward: {v_launches}")

    # 5. native PNG output of the orbit's 8 frames against the Python encoder
    frames = np.stack([to_rgba_u8(im.cpu().numpy()) for im in imgs])
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"n{i}.png") for i in range(FRAMES)]
        t0 = time.perf_counter()
        wrote = native.write_pngs_native(paths, frames)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = [encode_png(f) for f in frames]
        python_s = time.perf_counter() - t0
        same = wrote and all(np.array_equal(read_png_rgba(p), f) for p, f in zip(paths, frames))
        py_ok = all(np.array_equal(decode_png_rgba(b, "python"), f)
                    for b, f in zip(py, frames))
    emit("frontends_native", library_loaded=native.available(), error=native.load_error(),
         library=str(native.library_path()), native_wrote=wrote,
         native_pixels_equal=bool(same), python_pixels_equal=bool(py_ok),
         native_seconds=native_s if wrote else None, python_seconds=python_s)
    check(py_ok and (same or not wrote), "a PNG writer's pixels differ from the frames")
    return batched_launch


def only_phases(names, dev, smi: str, clock_mhz: float, n_sm: int) -> int:
    """`--only a,b`: the named phase groups alone (for work on one path),
    then the kernel line of their kernels."""
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "cube_cloud.obj")
        write_obj(obj, smoke_points())
        groups = {"serving": lambda: [serving_phases(dev, smi, clock_mhz, n_sm)],
                  "train": lambda: train_phases(dev, smi, clock_mhz, n_sm, obj,
                                               fused_vs_chunked=True),
                  "dense": lambda: dense_phases(dev, smi, clock_mhz, n_sm, tmp),
                  "aniso": lambda: aniso_phases(dev, smi, clock_mhz, n_sm, obj,
                                                fused_vs_chunked=True),
                  "aniso_dense": lambda: aniso_dense_phases(dev, smi, clock_mhz, n_sm, tmp,
                                                            fused_vs_chunked=True),
                  "split": lambda: split_phases(dev, smi, clock_mhz, n_sm),
                  "approx": lambda: approx_phases(dev, smi, clock_mhz, n_sm, obj) or [],
                  # its batched launch of kernel 1 is in its frontends_orbit line
                  "frontends": lambda: frontends_phases(dev, smi, clock_mhz, n_sm) and []}
        for name in names:
            entries += groups[name]()
    print(json.dumps({"kernels": entries}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2

    from sgrt_tpu_torch.ops import kernels
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
    if sys.argv[1:] == ["--torch-route"]:
        torch_route_times(dev, smi)
        return 0

    # 2. build every kernel from the checkout's sources, all nvcc at once
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    for k in kernels.KERNELS:
        ptxas = [ln.strip() for ln in nvcc.build_log(k.source).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        emit("build", kernel=k.name, source=str(k.source.relative_to(nvcc.CSRC_DIR.parents[1])),
             seconds=round(build_s, 2), ptxas=ptxas)
    kernel_resources_phase()
    # the native host library (PNG, GIF and obj I/O) with g++; without it
    # the Python paths serve
    from sgrt_tpu_torch.utils import native

    t0 = time.perf_counter()
    emit("build_native", loaded=native.available(), seconds=time.perf_counter() - t0,
         error=native.load_error(), library=str(native.library_path()))
    if sys.argv[1:2] == ["--only"]:
        return only_phases(sys.argv[2].split(","), dev, smi, clock_mhz, n_sm)

    # 3. the serving path; 4. the training path; 5. the dense cell; 6. the
    # anisotropic cell; 7. the anisotropic dense cell; 8. every erf and exp
    # name on the main paths; 9. the split kernels and the verification
    # entry point
    with tempfile.TemporaryDirectory() as tmp:
        entries = [serving_phases(dev, smi, clock_mhz, n_sm)]
        obj = os.path.join(tmp, "cube_cloud.obj")
        write_obj(obj, smoke_points())
        entries += train_phases(dev, smi, clock_mhz, n_sm, obj)
        entries += dense_phases(dev, smi, clock_mhz, n_sm, tmp)
        entries += aniso_phases(dev, smi, clock_mhz, n_sm, obj)
        entries += aniso_dense_phases(dev, smi, clock_mhz, n_sm, tmp)
        approx_phases(dev, smi, clock_mhz, n_sm, obj)
    entries += split_phases(dev, smi, clock_mhz, n_sm)
    # 10. the entry points beside the CLI: the batched orbit (its launch of
    # kernel 1 goes into kernel 1's entry), render_tiled, the viewer, native
    entries[0]["batched_launch"] = frontends_phases(dev, smi, clock_mhz, n_sm)

    # 11. the kernel line
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
