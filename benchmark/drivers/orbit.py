"""The `orbit` driver: the CLI's loop (cli.py:165-200), what a rendering or
viewer user waits on.

Set-up: the configuration's scene from the seed, the cell's pinned
capacity and buckets over the orbit's F angles (i 360/F degrees), one
frame rendered to warm up. Window: a closed loop with one frame in flight:
each frame is one render_orbit_frame call at the next angle and the copy
of its image to the host, timed from the call to the image on the host.
attempted: frames started; failed: frames that raised or returned
overflow > 0. A run's windows continue one orbit: frame i is at angle
i mod F.

The check: a reservoir, drawn from the seed, keeps a uniform sample of
4 x `frames` of the completed frames' images (the i-th completed frame
replaces a kept one with probability 4 frames / i), whatever the window's
rate; the last frame is kept too. Once the windows have closed, `frames`
of the kept frames are drawn, `pixels` pixels in each, in tiles drawn by
their live member count (the work), and the plain reference renders those
pixels in float64.

Parameters (the cell's file): width, height, tiles, frames_per_orbit,
buckets (benchmark/program.py), check {frames, pixels}.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks, program, scenes, work
from benchmark.reference import render as ref_render


class OrbitCell:
    def __init__(self, ctx):
        from sgrt_tpu_torch.ops.frame import render_orbit_frame

        p, cam = ctx.params, ctx.config["camera"]
        self.ctx = ctx
        self.w, self.h, self.tiles = int(p["width"]), int(p["height"]), tuple(p["tiles"])
        self.offset, self.focal = float(cam["offset"]), float(cam["focal_length"])
        f = int(p["frames_per_orbit"])
        self.angles = [i * 360.0 / f for i in range(f)]
        self.fields = scenes.make_scene(ctx.config["scene"],
                                        scenes.generator(ctx.seed, ctx.device), ctx.device)
        self.scene = program.scene_of(self.fields)
        ctx.mark("scene")
        self.cap, self.buckets = program.pinned_buckets(
            self.scene, self.angles, offset=self.offset, focal=self.focal, tiles=self.tiles,
            width=self.w, height=self.h, rule=p["buckets"])
        self.render = lambda a: render_orbit_frame(
            self.scene, a, self.offset, self.focal, width=self.w, height=self.h,
            tiles=self.tiles, capacity=self.cap, backend="kernel", bucket_cfg=self.buckets)
        ctx.mark("buckets")
        self.render(self.angles[0])[0].cpu()
        ctx.mark("first_frame")
        self.rng = np.random.default_rng(ctx.seed)
        self.room = 4 * int(p["check"]["frames"])
        self.kept, self.last = [], None       # the reservoir: [(frame, image)]
        self.i = self.done = 0                # frames started, completed

    def reset_counters(self):
        program.reset_launches()

    def launches(self):
        return program.launches()

    def _keep(self, i, img):
        """Algorithm R: the done-th completed frame replaces a kept one with
        probability room / done."""
        self.last = (i, img)
        if len(self.kept) < self.room:
            self.kept.append((i, img))
            return
        j = int(self.rng.integers(0, self.done))
        if j < self.room:
            self.kept[j] = (i, img)

    def window(self, ctx):
        f = len(self.angles)
        lat, overflows, frames = [], [], []
        started, raised = 0, 0
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while time.perf_counter() < deadline:
            i = self.i
            self.i += 1
            started += 1
            tc = time.perf_counter()
            try:
                with ctx.span("frame_call"):
                    img, ovf = self.render(self.angles[i % f])
                with ctx.span("image_to_host"):
                    img_np = img.cpu().numpy()
            except (RuntimeError, ValueError):
                raised += 1
                continue
            lat.append(time.perf_counter() - tc)
            overflows.append(ovf)
            frames.append(i)
            self.done += 1
            self._keep(i, img_np)
        t1 = time.perf_counter()
        over = int(torch.count_nonzero(torch.stack(overflows))) if overflows else 0
        done = started - raised
        return {"attempted": started, "failed": raised + over, "completed": done,
                "window_s": t1 - t0, "rays": done * self.w * self.h, "latencies_s": lat,
                "frames": frames}

    def _counts(self, angle):
        view = ref_render.orbit_view(angle, self.offset, self.focal, self.ctx.device)[1]
        mu, sigma = self.fields[0], self.fields[1]
        return ref_render.tile_counts(mu, sigma, view, self.tiles, self.focal).cpu().numpy()

    def work(self, record):
        """Per traced frame, the forward's work from the benchmark's own
        culling of the scene at that frame's view."""
        rays = (self.w // self.tiles[0]) * (self.h // self.tiles[1])
        f, per_angle = len(self.angles), {}
        out = []
        for i in record["frames"]:
            a = i % f
            if a not in per_angle:
                per_angle[a] = work.forward_work(self._counts(self.angles[a]), rays)
            out.append({"fwd": per_angle[a]})
        return out

    def free(self):
        del self.render, self.scene

    def check(self):
        f = len(self.angles)
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        n = min(int(self.ctx.params["check"]["frames"]), len(kept))
        chosen = self.rng.choice(sorted(kept), size=n, replace=False)
        gap = 0.0
        for i in sorted(chosen.tolist()):
            angle = self.angles[i % f]
            pix = checks.sample_pixels(self._counts(angle), self.rng,
                                       int(self.ctx.params["check"]["pixels"]),
                                       width=self.w, height=self.h, tiles=self.tiles)
            ref = ref_render.render_pixels(self.fields, angle, pix, width=self.w,
                                           height=self.h, tiles=self.tiles,
                                           offset=self.offset, focal=self.focal)
            got = torch.from_numpy(kept[i].reshape(-1, 3)[pix])
            gap = max(gap, checks.pixel_gap(got, ref.cpu()))
        return {"pixel_gap": gap}


def make(ctx):
    return OrbitCell(ctx)
