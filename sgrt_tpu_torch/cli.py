"""Command-line renderer — flag-compatible with the reference binary and with
`python -m sgrt_tpu` (PyTorch port of sgrt_tpu.cli).

Mirrors `volumetric-ray-tracer` (src/volumetric-ray-tracer/main.cpp:28-184):
same flags (including `-h` meaning *height*, so help is `--help` only), same
default scene (4x4 grid), same orbit loop, same TIME/AVG. TIME output format
(main.cpp:310-316). Modes 1-4 render untiled, modes 5-8 tiled.
`-t/--with-threads` is accepted and ignored.

Usage:  python -m sgrt_tpu_torch [options]
"""

from __future__ import annotations

import argparse
import sys
import time


def _tile_spec(v: str):
    if "x" in v:
        tx, ty = v.split("x")
        return int(tx), int(ty)
    return int(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sgrt_tpu_torch",
        description="Volumetric Gaussian ray tracer on an NVIDIA GPU (PyTorch + CUDA)",
        add_help=False,
    )
    p.add_argument("--help", action="help", help="Show this help message.")
    p.add_argument("--file", "-f", default=None, help="Load gaussians as vertices from <file> (.obj).")
    p.add_argument("--output", "-o", default=None, help="Write image to <file> in PNG format.")
    p.add_argument("--grid", "-g", nargs="?", const=4, type=int, default=None,
                   help="Render a grid of <dim>x<dim> gaussians (default 4). Overridden by --file.")
    p.add_argument("--width", "-w", type=int, default=None, help="Image width.")
    p.add_argument("--height", "-h", type=int, default=None, help="Image height.")
    p.add_argument("--with-threads", "-t", type=int, default=1,
                   help="Accepted for compatibility; ignored.")
    p.add_argument("--quiet", "-q", action="store_true",
                   help="Render without displaying (prints TIME/AVG. TIME).")
    p.add_argument("--frames", type=int, default=1, help="Render <count> frames.")
    p.add_argument("--tiles", type=_tile_spec, default=16,
                   help="Tiles per axis: a count (square grid) or TXxTY "
                        "(rectangular, e.g. 16x32).")
    p.add_argument("--rotation", "-r", type=float, default=360.0,
                   help="Total viewing-angle change distributed over --frames.")
    p.add_argument("--initial-rotation", "-i", type=float, default=0.0,
                   help="Initial rotation in degrees.")
    p.add_argument("--camera-offset", "-c", type=float, default=-4.0,
                   help="Camera position along the Z axis.")
    p.add_argument("--focal-length", type=float, default=1.0, help="Camera focal length.")
    p.add_argument("--mode", "-m", type=int, default=8, choices=range(1, 9),
                   help="1-4: untiled; 5-8: tiled.")
    p.add_argument("--capacity", type=int, default=None,
                   help="Static per-tile Gaussian capacity (default: auto per scene).")
    p.add_argument("--backend", choices=("kernel", "torch"), default="kernel",
                   help="Hot-loop backend: the fused CUDA kernel or plain tensor ops.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device to render on (cpu runs the kernel's plain version).")
    p.add_argument("--erf", default="as5",
                   choices=("exact", "as5", "as3", "taylor", "spline", "spline_mirror"),
                   help="erf implementation (as3 = the reference's production A&S choice; "
                        "the CUDA kernels implement every name, exact as as5).")
    p.add_argument("--exp", default="exact",
                   choices=("exact", "fast", "spline"),
                   help="exp implementation for the transmittance exponentials "
                        "(fast = the reference's Schraudolph fast_exp; the CUDA "
                        "kernels implement every name).")
    p.add_argument("--gif", default=None,
                   help="Write all frames as an animated GIF to <file>.")
    p.add_argument("--aniso", default=None, metavar="SX,SY,SZ",
                   help="Anisotropic Gaussians: scale each Gaussian's sigma per axis by "
                        "SX,SY,SZ and render through the anisotropic kernels.")
    return p


def _render_aniso_frame(aniso_scene, angle, args, width, height, use_tiling, capacity,
                        bucket_cfg):
    """One orbit frame of an anisotropic scene → (image, overflow): tiled
    (and bucketed, on the kernel backend) through render_tiled_aniso;
    untiled through the anisotropic kernels as one tile, or the plain
    renderer."""
    import torch

    from sgrt_tpu_torch.ops import anisotropic as an
    from sgrt_tpu_torch.ops.frame import orbit_camera

    cam = orbit_camera(angle, args.camera_offset, args.focal_length, width, height,
                       device=aniso_scene.device)
    if use_tiling:
        return an.render_tiled_aniso(aniso_scene, cam, tiles=args.tiles,
                                     capacity=capacity or 1, backend=args.backend,
                                     erf_name=args.erf, exp_name=args.exp,
                                     bucket_cfg=bucket_cfg)
    if args.backend == "kernel":
        from sgrt_tpu_torch.ops.cuda_render import render_rays

        o, dirs = cam.rays()
        img = render_rays(o, dirs, aniso_scene, erf_name=args.erf,
                          exp_name=args.exp).reshape(height, width, 3)
    else:
        img = an.render_aniso(aniso_scene, cam, erf_name=args.erf, exp_name=args.exp)
    return img, torch.zeros((), dtype=torch.int32, device=img.device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from sgrt_tpu_torch.models.gaussians import grid_scene, scene_from_obj
    from sgrt_tpu_torch.ops.frame import probe_capacity, render_orbit_frame
    from sgrt_tpu_torch.ops.tiling import as_grid
    from sgrt_tpu_torch.utils.image import write_gif, write_png

    width = args.width or args.height or 256
    height = args.height or args.width or 256

    if args.file is not None:
        scene = scene_from_obj(args.file, device=args.device)
    else:
        scene = grid_scene(args.grid if args.grid is not None else 4,
                           device=args.device)

    use_tiling = args.mode >= 5
    tx, ty = as_grid(args.tiles)
    if use_tiling and (width % tx or height % ty):
        print(f"error: {width}x{height} not divisible into {tx}x{ty} tiles", file=sys.stderr)
        return 1

    aniso_scene = None
    if args.aniso:
        from sgrt_tpu_torch.ops import anisotropic as an

        sf = [float(x) for x in args.aniso.split(",")]
        if len(sf) != 3:
            print("error: --aniso expects SX,SY,SZ", file=sys.stderr)
            return 1
        aniso_scene = an.from_isotropic(scene)
        aniso_scene = aniso_scene.replace(
            scale=aniso_scene.scale * torch.tensor([sf], device=scene.device))
        # capacity probing (and tiling) uses the conservative max-scale
        # footprint
        scene = an.iso_proxy(aniso_scene)

    capacity = args.capacity
    bucket_cfg = None
    if use_tiling and capacity is None:
        # one capacity for the whole orbit, probed at sample angles
        probe_angles = [args.initial_rotation + d
                        for d in (0.0, 30.0, 45.0, 60.0, 90.0)]
        probe = probe_capacity(scene, probe_angles, args.camera_offset,
                               args.focal_length, args.tiles)
        capacity = max(32, int(probe * 1.25))
        if args.backend == "kernel" and aniso_scene is not None:
            # the bucketed anisotropic forward, probed on the max-scale proxy
            from sgrt_tpu_torch.ops.frame import probe_buckets

            bucket_cfg = probe_buckets(scene, probe_angles, args.camera_offset,
                                       args.focal_length, args.tiles, margin=1.25)

    angle_change = args.rotation / args.frames
    total_time = 0.0
    gif_frames = [] if args.gif else None
    for frame in range(1, args.frames + 1):
        angle = args.initial_rotation + (frame - 1) * angle_change
        t0 = time.perf_counter()
        if aniso_scene is not None:
            img, overflow = _render_aniso_frame(aniso_scene, angle, args, width, height,
                                                use_tiling, capacity, bucket_cfg)
        else:
            img, overflow = render_orbit_frame(
                scene,
                angle,
                args.camera_offset,
                args.focal_length,
                width=width,
                height=height,
                tiles=args.tiles,
                capacity=capacity or 1,
                use_tiling=use_tiling,
                backend=args.backend,
                erf_name=args.erf,
                exp_name=args.exp,
            )
        # the copy to the host waits for the device
        img_np = img.cpu().numpy()
        dt = (time.perf_counter() - t0) * 1000.0

        if use_tiling and int(overflow) > 0:
            print(
                f"warning: tile capacity {capacity} overflowed on "
                f"{int(overflow)} tiles (Gaussians dropped); pass --capacity",
                file=sys.stderr,
            )

        if args.output:
            stem, _, ext = args.output.rpartition(".")
            name = f"{stem}_{frame}.{ext}" if args.frames > 1 else args.output
            write_png(name, img_np)
        if gif_frames is not None:
            gif_frames.append(img_np)

        if args.frames == 1:
            print(f"TIME: {dt} ms")
        total_time += dt

    if args.frames > 1:
        print(f"AVG. TIME: {total_time / args.frames} ms ({args.frames} frames)")
    if gif_frames is not None:
        write_gif(args.gif, np.stack(gif_frames))
    return 0


if __name__ == "__main__":
    sys.exit(main())
