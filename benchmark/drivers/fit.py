"""The `fit` driver: fit_cli's loop (fit_cli.py:89-156), what a fitting
user runs.

Set-up: the configuration's scene (the truth) from the seed; V orbit views
at i 360/V degrees; targets the program's renders of the truth at those
views; the start the truth with mu + N(0, noise); Adam(lr) over mu, sigma,
magnitude and albedo; the program's make_frame_train_step at the cell's
size, tiles and pinned buckets. The first `check_steps` steps (views 0, 1,
2: rows that all differ) run through the window's own call in set-up; the
check reads their losses, the first gradient from Adam's first moment after
step 1 (m = (1 - b1) g), and the scene's change after them. Once the
windows have closed, one more step, the next view in turn, runs through
the same call from the state they left; the check reads its loss, its
gradient from Adam's first moments before and after it
(g = (m1 - b1 m0) / (1 - b1)), and the change it made, and the reference
follows that step from the same scene, moments and step count.

Window: a closed loop, one step after the other with no synchronise in
between, each step on the next view in turn with its rays made anew; it
ends in a synchronise. attempted: steps started; failed: steps that raised
or returned overflow > 0 (Gaussians dropped).

Parameters (the cell's file): width, height, tiles, views, noise, lr,
buckets (benchmark/program.py), check_steps.
"""

from __future__ import annotations

import time

import torch

from benchmark import checks, program, scenes, work
from benchmark.reference import render as ref_render
from benchmark.reference.fit import FIELDS, fit_reference, late_step_reference

B1 = 0.9


class FitCell:
    def __init__(self, ctx):
        from sgrt_tpu_torch.ops.frame import orbit_camera, render_orbit_frame
        from sgrt_tpu_torch.parallel.fit import adam, init_state, make_frame_train_step

        p, cam = ctx.params, ctx.config["camera"]
        self.ctx = ctx
        self.w, self.h, self.tiles = int(p["width"]), int(p["height"]), tuple(p["tiles"])
        self.offset, self.focal = float(cam["offset"]), float(cam["focal_length"])
        self.lr = float(p["lr"])
        dev = ctx.device
        self.truth, self.start = scenes.fit_inputs(ctx.config["scene"], float(p["noise"]),
                                                   ctx.seed, dev)
        self.angles = [i * 360.0 / int(p["views"]) for i in range(int(p["views"]))]
        truth = program.scene_of(self.truth)
        ctx.mark("scene")
        self.cap, self.buckets = program.pinned_buckets(
            truth, self.angles, offset=self.offset, focal=self.focal, tiles=self.tiles,
            width=self.w, height=self.h, rule=p["buckets"])
        ctx.mark("buckets")
        with torch.no_grad():
            self.targets = [render_orbit_frame(
                truth, a, self.offset, self.focal, width=self.w, height=self.h,
                tiles=self.tiles, capacity=self.cap, backend="kernel",
                bucket_cfg=self.buckets)[0] for a in self.angles]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ctx.mark("targets")
        self.cams = [orbit_camera(a, self.offset, self.focal, self.w, self.h, device=dev)
                     for a in self.angles]
        self.step = make_frame_train_step(width=self.w, height=self.h, tiles=self.tiles,
                                          capacity=self.cap, bucket_cfg=self.buckets,
                                          trainable=FIELDS, focal_length=self.focal)
        self.state = init_state(program.scene_of(self.start), adam(self.lr))
        # the first steps: set-up, warm-up and what the check follows
        n = int(p["check_steps"])
        losses = []
        for i in range(n):
            losses.append(self._step(i)[0])
            ctx.mark(f"step{i + 1}")
            if i == 0:
                opt = self.state.opt_state    # no moment yet: no gradient was applied
                self.grad1 = {f: (opt.state[q]["exp_avg"] / (1 - B1)).detach().clone()
                              if "exp_avg" in opt.state.get(q, {}) else torch.zeros_like(q)
                              for f, q in zip(FIELDS, opt.param_groups[0]["params"])}
        self.change = {f: (getattr(self.state.scene, f) - s).detach().clone()
                       for f, s in zip(FIELDS, self.start)}
        self.losses = [float(v) for v in losses]
        self.i = self.applied = n             # steps started, steps that returned

    def _step(self, i):
        cam = self.cams[i % len(self.cams)]
        with self.ctx.span("camera_rays"):
            o, dirs = cam.rays()
        with self.ctx.span("step_call"):
            self.state, loss, overflow = self.step(self.state, cam.view_matrix, o, dirs,
                                                   self.targets[i % len(self.cams)])
        return loss, overflow

    def reset_counters(self):
        program.reset_launches()

    def launches(self):
        return program.launches()

    def window(self, ctx):
        overflows, self.snaps, started, raised = [], [], 0, 0
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while time.perf_counter() < deadline:
            started += 1
            if ctx.trace:      # the scene this step tiles, for its work
                with ctx.span("work_snapshot"):
                    s = self.state.scene
                    self.snaps.append((self.i % len(self.cams), s.mu.detach().clone(),
                                       s.sigma.detach().clone()))
            try:
                _, ovf = self._step(self.i)
            except (RuntimeError, ValueError):
                raised += 1
                if ctx.trace:
                    self.snaps.pop()
                continue
            finally:
                self.i += 1
            self.applied += 1
            overflows.append(ovf)
        with ctx.span("sync"):
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
        t1 = time.perf_counter()
        over = int(torch.count_nonzero(torch.stack(overflows))) if overflows else 0
        done = started - raised
        return {"attempted": started, "failed": raised + over, "completed": done,
                "window_s": t1 - t0, "rays": done * self.w * self.h}

    def work(self, record):
        """Per traced step, the forward-with-T's and the backward's work,
        from the benchmark's own culling of that step's scene and view."""
        rays = (self.w // self.tiles[0]) * (self.h // self.tiles[1])
        views = [ref_render.orbit_view(a, self.offset, self.focal, self.ctx.device)[1]
                 for a in self.angles]
        out = []
        for v, mu, sigma in self.snaps:
            counts = ref_render.tile_counts(mu, sigma, views[v], self.tiles, self.focal)
            c = counts.cpu().numpy()
            out.append({"fwd": work.forward_work(c, rays, store_t=True),
                        "bwd": work.backward_work(c, rays)})
        return out

    def _moments(self):
        """Adam's first and second moments, zeros where it holds none."""
        opt = self.state.opt_state
        params = opt.param_groups[0]["params"]
        return tuple({f: opt.state.get(q, {}).get(key, torch.zeros_like(q)).detach().clone()
                      for f, q in zip(FIELDS, params)} for key in ("exp_avg", "exp_avg_sq"))

    def late_step(self):
        """The step after the windows, from the state they left: what the
        check follows of them."""
        s = self.state.scene
        before = {f: getattr(s, f).detach().clone() for f in FIELDS}
        m0, v0 = self._moments()
        view, t = self.i % len(self.cams), self.applied + 1
        loss, _ = self._step(self.i)
        m1, _ = self._moments()
        self.late = {
            "view": view, "t": t, "scene": tuple(before[f] for f in FIELDS),
            "m": tuple(m0[f] for f in FIELDS), "v": tuple(v0[f] for f in FIELDS),
            "loss": float(loss),
            "grad": {f: (m1[f].double() - B1 * m0[f].double()) / (1 - B1) for f in FIELDS},
            "change": {f: getattr(s, f).detach().double() - before[f].double()
                       for f in FIELDS}}

    def free(self):
        """Once the windows have closed: the step the check follows, then
        the program's state freed."""
        self.late_step()
        del self.state, self.step, self.targets, self.cams, self.snaps

    def reference_kw(self):
        return dict(width=self.w, height=self.h, tiles=self.tiles, offset=self.offset,
                    focal=self.focal, lr=self.lr)

    def late_reference(self, **extra):
        late = self.late
        return late_step_reference(self.truth, late["scene"], late["m"], late["v"],
                                   late["t"], self.angles[late["view"]],
                                   **self.reference_kw(), **extra)

    def check(self):
        n = int(self.ctx.params["check_steps"])
        ref = fit_reference(self.truth, self.start, self.angles, steps=n,
                            **self.reference_kw())
        prog = {"losses": self.losses, "grad1": self.grad1, "change": self.change}
        return {**checks.fit_numbers(prog, ref),
                **checks.late_numbers(self.late, self.late_reference())}


def make(ctx):
    return FitCell(ctx)
