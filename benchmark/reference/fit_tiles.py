"""The plain reference of a fit checked tile by tile: for some tiles of one
step, each tile's target from the true scene, its colors from the scene as
it stands, and the gradient of its share of the frame loss (its sum of
squares over H*W*3) with respect to its own culled members; the scene's
gradient as the sum of given tiles' shares; and Adam's step from a given
gradient and given moments.

It builds on reference/render.py (its camera, culling and renderer) and
imports nothing of the program. A tile's gradient is taken by autograd
through render.ray_colors over a few of the tile's rays at a time: the
loss is a sum over rays, so the rays' gradients add up to the tile's, and
a group of rays keeps its pairwise intermediates (three (rays, 5 C, C)
tensors for C members) under `budget` elements.

dtype float64 is the check; float32 with tf32=True (the operands of the
matrix products rounded to TF32's 10-bit mantissa) is its control.
"""

from __future__ import annotations

import torch

from benchmark.reference.fit import FIELDS, _adam
from benchmark.reference.render import camera_rays, membership, orbit_view, ray_colors, tile_rays

PAIR_TENSORS = 3 * 5          # kept per (ray, member, member): 3 tensors of 5 samples


def _members(fields, member_row):
    """A tile's culled members: their indices (k,) and their rows, each
    field with a leading axis of 1 (one group) for ray_colors."""
    idx = member_row.nonzero().reshape(-1)
    return idx, [f[idx][None] for f in fields]


def _colors(position, dirs, rows, tf32):
    return ray_colors(position, dirs[None], *rows, tf32=tf32)[0]


def tile_reference(truth, scene, angle: float, tile_ids, *, width: int, height: int, tiles,
                   offset: float, focal: float, dtype=torch.float64, tf32: bool = False,
                   trainable=FIELDS, budget: float = 2.5e9):
    """For each tile of `tile_ids` at the orbit view `angle`: its target
    (the truth's colors), its colors at `scene`, its loss share and the
    gradient of that share at its members. truth, scene: (mu, sigma,
    magnitude, albedo) float32 tensors; each culled in float32 as
    render.membership does, rendered in `dtype`.
    → {tile: {"target", "colors" (P, 3), "loss" (float), "members" (k,)
    int64, "grads" {field: (k, ...)}}}."""
    dev = truth[0].device
    position, view = orbit_view(angle, offset, focal, dev)
    tdirs = tile_rays(camera_rays(position, view, width, height), width, height, tiles)
    m_truth = membership(truth[0], truth[1], view, tiles, focal)
    m_scene = membership(scene[0], scene[1], view, tiles, focal)
    truth_d = [f.detach().to(dtype) for f in truth]
    scene_d = [f.detach().to(dtype) for f in scene]
    norm = float(width * height * 3)
    out = {}
    for t in (int(i) for i in tile_ids):
        dirs = tdirs[t]
        with torch.no_grad():
            target = _colors(position, dirs, _members(truth_d, m_truth[t])[1], tf32)
        idx, rows = _members(scene_d, m_scene[t])
        leaves = [r.clone().requires_grad_(name in trainable) for r, name in zip(rows, FIELDS)]
        wrt = [j for j, name in enumerate(FIELDS) if name in trainable]
        per = max(1, int(budget // (PAIR_TENSORS * max(1, idx.numel()) ** 2)))
        colors, loss = [], 0.0
        grads = [torch.zeros_like(leaves[j]) for j in wrt]
        for r0 in range(0, dirs.shape[0], per):
            c = _colors(position, dirs[r0:r0 + per], leaves, tf32)
            part = torch.sum((c - target[r0:r0 + per]) ** 2) / norm
            if idx.numel():
                for g, d in zip(grads, torch.autograd.grad(part, [leaves[j] for j in wrt])):
                    g += d
            colors.append(c.detach())
            loss += float(part.detach())
        out[t] = {"target": target, "colors": torch.cat(colors), "loss": loss, "members": idx,
                  "grads": {FIELDS[j]: g[0] for j, g in zip(wrt, grads)}}
    return out


def scatter_tiles(n: int, members, grads, dtype=torch.float64):
    """The scene's gradient as the sum of its tiles' shares: every tile's
    member gradients added into an n-row scene at its members. members
    (L,) int64 and grads {field: (L, ...)}: all tiles' rows, one after
    another. → {field: (n, ...)} in dtype."""
    return {f: g.new_zeros((n,) + tuple(g.shape[1:]), dtype=dtype).index_add_(
        0, members, g.to(dtype)) for f, g in grads.items()}


def adam_change(scene, grads, m, v, t: int, *, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, dtype=torch.float64):
    """Adam's change of the scene in its step t (counted from 1), from the
    gradient `grads` ({field: tensor}) and the moments m, v before it.
    scene, m, v: (mu, sigma, magnitude, albedo) tuples. → {field: change}."""
    params = [f.detach().to(dtype).clone() for f in scene]
    m = [f.detach().to(dtype).clone() for f in m]
    v = [f.detach().to(dtype).clone() for f in v]
    _adam(params, m, v, {k: g.detach().to(dtype) for k, g in grads.items()}, t, lr=lr, b1=b1,
          b2=b2, eps=eps)
    return {name: params[j] - scene[j].detach().to(dtype) for j, name in enumerate(FIELDS)}
