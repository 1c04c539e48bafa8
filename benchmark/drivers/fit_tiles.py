"""The `fit_tiles` driver: the `fit` driver's loop and window
(benchmark/drivers/fit.py's FitCell), checked tile by tile, for a fit whose
whole frame the plain reference cannot follow within a run.

The checked steps are set-up's `check_steps` steps (views 0, 1, 2) and the
step after the windows, each run through the window's own step from the
program's own state, snapshotted before it (scene, Adam's moments, step
count), with the step's per-tile outputs requested (the step's per_tile)
for every tile. `check_tiles` tiles drawn from the seed by live count,
`check_dense` of them from the dense bucket (the n_dense tiles of most
members), are compared with the reference; all of them add up to the
scene's gradient. The timed window never requests them. Once the windows
have closed, the plain reference (benchmark/reference/fit_tiles.py)
follows each drawn tile from the snapshotted scene, adds every tile's
member gradients into the scene in float64, and takes Adam's step from
the program's own summed gradient (the scene's .grad after the step) and
moments. Numbers, each the worst over the checked steps:

  tile_color_gap   the largest absolute gap of a tile's colors
  tile_loss_gap    the largest relative gap of a tile's loss (its sum of
                   squares over H*W*3, each side against its own target)
  tile_member_gap  the members one side culls and the other not, over the
                   reference's member count
  tile_grad_gap    the worst field's norm of the difference of a tile's
                   member gradients, matched member by member (zero where
                   a side lacks the member), over the larger of that
                   field's and the median field's reference norm
  sum_grad_gap     the same of the scene's gradient (.grad) against every
                   tile's member gradients added up: the gather's
                   transpose, which no tile shows
  change_gap       the worst field's gap of the norms of Adam's change of
                   the whole scene (checks.leaf_gaps), over the fields
                   whose gradient is at least a thousandth of the median
                   field's (checks.fit_numbers' rule)
  overflow         tiles over capacity at the checked steps, plus the
                   window's failed steps (overflowed or raised)

Parameters (the cell's file): the fit's, and check_tiles, check_dense.
"""

from __future__ import annotations

import inspect
import statistics

import numpy as np
import torch

from benchmark import checks
from benchmark.drivers.fit import FitCell
from benchmark.reference import render as ref_render
from benchmark.reference.fit import FIELDS
from benchmark.reference.fit_tiles import adam_change, scatter_tiles, tile_reference

TILE_NUMBERS = ("tile_color_gap", "tile_loss_gap", "tile_member_gap", "tile_grad_gap")


def diff_gap(prog: dict, ref: dict, leaves) -> float:
    """Worst leaf of |prog_leaf - ref_leaf| over the larger of the
    reference leaf's norm and the median leaf's norm."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in leaves}
    med = statistics.median(norms.values())
    return max(float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
               / max(norms[k], med, 1e-300) for k in leaves)


def on_members(members, grads: dict, union) -> dict:
    """grads at `members` placed at their rows of `union` (sorted), zeros
    elsewhere, in float64."""
    at = torch.searchsorted(union, members)
    return {f: g.new_zeros((union.numel(),) + tuple(g.shape[1:]), dtype=torch.float64)
            .index_copy_(0, at, g.double()) for f, g in grads.items()}


def tile_numbers(prog: dict, ref: dict) -> dict:
    """A checked step's tile numbers: prog and ref {tile: {"colors",
    "loss", "members", "grads"}}."""
    out = dict.fromkeys(TILE_NUMBERS, 0.0)
    for t, got in prog.items():
        want = ref[t]
        mine, theirs = got["members"].to(want["members"].device), want["members"]
        union = torch.unique(torch.cat([mine, theirs]))
        fields = list(want["grads"])
        numbers = {
            "tile_color_gap": checks.pixel_gap(got["colors"], want["colors"]),
            "tile_loss_gap": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "tile_member_gap": (2 * union.numel() - mine.numel() - theirs.numel())
            / max(theirs.numel(), 1),
            "tile_grad_gap": diff_gap(
                on_members(mine, {f: got["grads"][f].to(mine.device) for f in fields}, union),
                on_members(theirs, want["grads"], union), fields) if union.numel() else 0.0}
        out = {k: max(out[k], v) for k, v in numbers.items()}
    return out


def change_number(change: dict, ref_change: dict, grad: dict) -> float:
    """change_gap of one step: leaf_gaps over the fields that move by more
    than round-off (gradient norm at least 1e-3 of the median field's)."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grad.items()}
    med = statistics.median(norms.values())
    return checks.leaf_gaps(change, ref_change, [k for k in norms if norms[k] >= 1e-3 * med])


class FitTilesCell(FitCell):
    def __init__(self, ctx):
        from sgrt_tpu_torch.parallel.fit import make_frame_value_and_grad

        if "per_tile" not in inspect.signature(make_frame_value_and_grad(
                width=8, height=8, tiles=1, capacity=8, backend="torch")).parameters:
            raise RuntimeError("the program's frame step gives no per-tile outputs")
        p = ctx.params
        self.rng = np.random.default_rng(ctx.seed)
        self.n_dense = int(p["buckets"]["n_dense"])
        self.all_tiles = range(int(p["tiles"][0]) * int(p["tiles"][1]))
        self.n_tiles, self.n_from_dense = int(p["check_tiles"]), int(p["check_dense"])
        self.checked, self.window_failed, self.checking = [], 0, True
        super().__init__(ctx)        # set-up's steps, checked
        self.checking = False

    def _step(self, i):
        return self._checked_step(i) if self.checking else super()._step(i)

    def draw_tiles(self, mu, sigma, view) -> list[int]:
        """check_tiles tiles drawn by live count (the benchmark's culling of
        the scene this step tiles), check_dense of them from the dense
        bucket, the rest from all other tiles."""
        counts = ref_render.tile_counts(mu, sigma, view, self.tiles, self.focal).cpu().numpy()
        order = [int(t) for t in np.argsort(-counts, kind="stable") if counts[t] > 0]

        def draw(pool, n):
            n = min(n, len(pool))
            if n <= 0:
                return []
            w = counts[pool].astype(np.float64)
            return self.rng.choice(pool, size=n, replace=False, p=w / w.sum()).tolist()

        picks = draw(order[:self.n_dense], self.n_from_dense)
        picks += draw([t for t in order if t not in picks], self.n_tiles - len(picks))
        return [int(t) for t in picks]

    def _checked_step(self, i):
        v = i % len(self.cams)
        cam, s = self.cams[v], self.state.scene
        before = tuple(getattr(s, f).detach().clone() for f in FIELDS)
        m, vv = self._moments()
        t = self.state.step + 1
        tiles = self.draw_tiles(s.mu.detach(), s.sigma.detach(), cam.view_matrix)
        o, dirs = cam.rays()
        outs = dict.fromkeys(self.all_tiles)
        self.state, loss, overflow = self.step(self.state, cam.view_matrix, o, dirs,
                                               self.targets[v], per_tile=outs)
        target = ref_render.tile_rays(self.targets[v].reshape(-1, 3), self.w, self.h,
                                      self.tiles)
        norm = float(self.w * self.h * 3)
        s = self.state.scene
        self.checked.append({
            "view": v, "t": t, "scene": before, "overflow": int(overflow),
            "m": tuple(m[f] for f in FIELDS), "v": tuple(vv[f] for f in FIELDS),
            "grad": {f: getattr(s, f).grad.detach().clone() for f in FIELDS},
            "change": {f: getattr(s, f).detach() - b for f, b in zip(FIELDS, before)},
            "tiles": {k: {"colors": outs[k].colors, "members": outs[k].members,
                          "grads": outs[k].grads,
                          "loss": float(torch.sum((outs[k].colors - target[k]) ** 2)) / norm}
                      for k in tiles},
            # every tile's rows, kept on the host: the window's peak memory is the program's
            "members": torch.cat([out.members for out in outs.values()]).cpu(),
            "member_grads": {f: torch.cat([out.grads[f] for out in outs.values()]).cpu()
                             for f in FIELDS}})
        return loss, overflow

    def window(self, ctx):
        record = super().window(ctx)
        self.window_failed += int(record["failed"])
        return record

    def late_step(self):
        """The step after the windows, from the state they left, checked."""
        self.checking = True
        try:
            self._step(self.i)
        finally:
            self.checking = False

    def numbers(self, reference=None, change_dtype=torch.float64) -> dict:
        """The check's numbers. reference(record) → {tile: ...} in the
        program's place (the control), else the program's own outputs;
        Adam's change of the reference in change_dtype."""
        out = dict.fromkeys(TILE_NUMBERS + ("sum_grad_gap", "change_gap"), 0.0)
        overflow = self.window_failed
        for rec in self.checked:
            overflow += rec["overflow"]
            ref = self.tile_reference(rec)
            prog = rec["tiles"] if reference is None else reference(rec)
            for k, val in tile_numbers(prog, ref).items():
                out[k] = max(out[k], val)
            summed = scatter_tiles(rec["scene"][0].shape[0], rec["members"],
                                   rec["member_grads"])
            grad = {f: g.cpu() for f, g in rec["grad"].items()}
            out["sum_grad_gap"] = max(out["sum_grad_gap"], diff_gap(grad, summed, list(summed)))
            want = adam_change(rec["scene"], rec["grad"], rec["m"], rec["v"], rec["t"],
                               lr=self.lr)
            got = rec["change"] if reference is None else adam_change(
                rec["scene"], rec["grad"], rec["m"], rec["v"], rec["t"], lr=self.lr,
                dtype=change_dtype)
            out["change_gap"] = max(out["change_gap"], change_number(got, want, rec["grad"]))
        return {**out, "overflow": float(overflow)}

    def tile_reference(self, rec, **extra):
        kw = dict(width=self.w, height=self.h, tiles=self.tiles, offset=self.offset,
                  focal=self.focal)
        return tile_reference(self.truth, rec["scene"], self.angles[rec["view"]],
                              list(rec["tiles"]), **kw, **extra)

    def control(self) -> dict:
        """The numbers with the reference in float32, TF32 operands, in the
        program's place."""
        return self.numbers(lambda rec: self.tile_reference(rec, dtype=torch.float32,
                                                            tf32=True),
                            change_dtype=torch.float32)

    def check(self):
        return self.numbers()


def make(ctx):
    return FitTilesCell(ctx)
