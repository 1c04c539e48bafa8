"""The plain reference of a fitting run: targets rendered from the true
scene, then Adam on the mean squared error of whole frames, each step's
tiles culled from the scene as it stands, the gradient by autograd through
reference/render.py. It follows a fit's first steps from its start, or one
step from a state the fit reached. Imports nothing of the program."""

from __future__ import annotations

import torch

from benchmark.reference.render import (
    camera_rays,
    membership,
    orbit_view,
    render_tiles,
    tile_rays,
)

FIELDS = ("mu", "sigma", "magnitude", "albedo")


def _frame(scene, cam, *, width, height, tiles, focal, tf32, grad, keep=None):
    """(colors (T, P, 3), member (T, N)) of one frame; keep (T,) bool: only
    those tiles are rendered and the rest left 0 (a planted fault)."""
    position, view, tdirs = cam
    member = membership(scene[0], scene[1], view, tiles, focal)
    if keep is not None:
        member = member & keep[:, None]
    return render_tiles(position, tdirs, scene, member, tf32=tf32, grad=grad), member


def _camera(angle, *, offset, focal, width, height, tiles, dev):
    position, view = orbit_view(angle, offset, focal, dev)
    return position, view, tile_rays(camera_rays(position, view, width, height),
                                     width, height, tiles)


def _keep(tiles, dev, half_batch):
    t2 = tiles[0] * tiles[1]
    return torch.arange(t2, device=dev) < t2 // 2 if half_batch else None


def _target(truth, cam, dtype, **kw):
    with torch.no_grad():
        return _frame(tuple(f.to(dtype) for f in truth), cam, grad=False, **kw)[0]


def _loss_and_grads(params, cam, target, keep, trainable, **kw):
    """(loss, {field: gradient}) of one step's frame at params."""
    leaves = [p.clone().requires_grad_(name in trainable) for p, name in zip(params, FIELDS)]
    colors, _ = _frame(leaves, cam, grad=True, keep=keep, **kw)
    diff = colors - target
    if keep is not None:
        diff = diff[keep]
    loss = torch.mean(diff * diff)
    wrt = [name for name in FIELDS if name in trainable]
    grads = torch.autograd.grad(loss, [leaves[FIELDS.index(n)] for n in wrt])
    return float(loss.detach()), {n: g.detach() for n, g in zip(wrt, grads)}


def _adam(params, m, v, grads, t, *, lr, b1, b2, eps):
    """Adam's update of step t (counted from 1) in place of params, m, v."""
    for j, name in enumerate(FIELDS):
        if name not in grads:
            continue
        g = grads[name]
        m[j] = b1 * m[j] + (1 - b1) * g
        v[j] = b2 * v[j] + (1 - b2) * g * g
        m_hat = m[j] / (1 - b1 ** t)
        v_hat = v[j] / (1 - b2 ** t)
        params[j] = params[j] - lr * m_hat / (torch.sqrt(v_hat) + eps)


def fit_reference(truth, start, angles, *, steps: int, width: int, height: int, tiles,
                  offset: float, focal: float, lr: float, trainable=FIELDS,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  dtype=torch.float64, tf32: bool = False, half_batch: bool = False):
    """Follow `steps` Adam steps of the fit from `start`, step i on view
    angles[i]. truth, start: (mu, sigma, magnitude, albedo) float32 tensors.
    → {"losses": [...], "grad1": {field: tensor}, "change": {field: tensor}}:
    each step's loss, the first step's gradient, and the scene after the
    steps less the start. half_batch: each step's loss is the mean over
    the first half of the tiles only (a planted fault)."""
    dev = truth[0].device
    kw = dict(width=width, height=height, tiles=tiles, focal=focal, tf32=tf32)
    cams = [_camera(a, offset=offset, focal=focal, width=width, height=height, tiles=tiles,
                    dev=dev) for a in angles[:steps]]
    keep = _keep(tiles, dev, half_batch)
    targets = [_target(truth, cam, dtype, **kw) for cam in cams]
    params = [f.detach().to(dtype).clone() for f in start]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, grad1 = [], {}
    for i in range(steps):
        loss, grads = _loss_and_grads(params, cams[i], targets[i], keep, trainable, **kw)
        losses.append(loss)
        if i == 0:
            grad1 = grads
        _adam(params, m, v, grads, i + 1, lr=lr, b1=b1, b2=b2, eps=eps)
    change = {name: params[j] - start[j].to(dtype) for j, name in enumerate(FIELDS)}
    return {"losses": losses, "grad1": grad1, "change": change}


def late_step_reference(truth, scene, m, v, t: int, angle: float, *, width: int,
                        height: int, tiles, offset: float, focal: float, lr: float,
                        trainable=FIELDS, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, dtype=torch.float64, tf32: bool = False,
                        half_batch: bool = False):
    """Follow one Adam step, the t-th (counted from 1), on view `angle` from
    a fit's state: scene (mu, sigma, magnitude, albedo) and Adam's moments
    m, v, each a tuple of float32 tensors in that order.
    → {"loss": float, "grad": {field: tensor}, "change": {field: tensor}}."""
    dev = truth[0].device
    kw = dict(width=width, height=height, tiles=tiles, focal=focal, tf32=tf32)
    cam = _camera(angle, offset=offset, focal=focal, width=width, height=height, tiles=tiles,
                  dev=dev)
    target = _target(truth, cam, dtype, **kw)
    params = [f.detach().to(dtype).clone() for f in scene]
    m = [f.detach().to(dtype).clone() for f in m]
    v = [f.detach().to(dtype).clone() for f in v]
    loss, grads = _loss_and_grads(params, cam, target, _keep(tiles, dev, half_batch),
                                  trainable, **kw)
    _adam(params, m, v, grads, t, lr=lr, b1=b1, b2=b2, eps=eps)
    change = {name: params[j] - scene[j].to(dtype) for j, name in enumerate(FIELDS)}
    return {"loss": loss, "grad": grads, "change": change}
