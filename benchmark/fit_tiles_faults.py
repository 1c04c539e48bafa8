"""Faults planted in the program's dense fit path, among the readings the
`fit_tiles` cell's limits are set from; each must read not correct. A
fault is a function plant(setattr) that breaks the program in place
through setattr(obj, name, value): pytest's monkeypatch.setattr, or
benchmark/control_fit_tiles.py's, which undoes it. The dense bucket is the
chunked route (capacities above MAX_MONOLITHIC_CAPACITY).

  half_dense    the dense bucket's launch renders the first half of its
                tiles; the rest read black and carry no gradient
  one_chunk     every dense tile's count clamped to one chunk
                (DEFAULT_CHUNK rows): the rows of later chunks are dropped
  stale_t       the saved-T backward handed, at every launch, the T of the
                first launch it saw (set-up's first step)
  adam_skipped  the gradient handed to the scene, Adam's update left out
  dense_unscattered
                the dense bucket's gathered rows cut from the scene's
                graph: their tiles render and differentiate as before, but
                the gather's transpose adds nothing of them into the scene
  short_reach   the tiles cull at 2.5 projected sigmas instead of 3.3: the
                members near a tile's edge are dropped
"""

from __future__ import annotations

import importlib


def _dense_operands(setattr, change):
    """tile_renderer_for whose chunked renderer runs as change(render,
    tiled, o, d, counts)."""
    from sgrt_tpu_torch.ops import cuda_chunked

    real = cuda_chunked.tile_renderer_for

    def patched(capacity, **kw):
        cap, fn = real(capacity, **kw)
        if capacity <= cuda_chunked.MAX_MONOLITHIC_CAPACITY:
            return cap, fn
        return cap, lambda *a: change(fn, *a)

    setattr(cuda_chunked, "tile_renderer_for", patched)


def half_dense(setattr):
    import torch

    def first_half(fn, tiled, o, d, counts):
        colors = fn(tiled, o, d, counts)
        keep = torch.arange(colors.shape[0], device=colors.device) < colors.shape[0] // 2
        return colors * keep[:, None, None]

    _dense_operands(setattr, first_half)


def one_chunk(setattr):
    import torch

    from sgrt_tpu_torch.ops import cuda_chunked

    _dense_operands(setattr, lambda fn, tiled, o, d, counts: fn(
        tiled, o, d, torch.clamp(counts, max=cuda_chunked.DEFAULT_CHUNK)))


def stale_t(setattr):
    from sgrt_tpu_torch.ops import cuda_chunked

    real, first = cuda_chunked.chunked_backward, []

    def stale(*a, t_saved=None, **kw):
        a = list(a)
        t = a.pop(7) if len(a) > 7 else t_saved
        if t is not None:
            if not first:
                first.append(t)
            t = first[0]
        return real(*a, t, **kw)

    setattr(cuda_chunked, "chunked_backward", stale)


def adam_skipped(setattr):
    fit = importlib.import_module("sgrt_tpu_torch.parallel.fit")

    def no_update(state, grads, trainable):
        for f in trainable:
            getattr(state.scene, f).grad = getattr(grads, f)
        state.step += 1

    setattr(fit, "_apply_updates", no_update)


def dense_unscattered(setattr):
    from sgrt_tpu_torch.ops import cuda_chunked, scheduler

    real = scheduler.gather_tiles

    def cut(scene, idx):
        rows = real(scene, idx)
        if idx.shape[1] <= cuda_chunked.MAX_MONOLITHIC_CAPACITY:
            return rows
        return type(rows)(**{f: getattr(rows, f).detach().requires_grad_(
            getattr(rows, f).requires_grad) for f in ("mu", "sigma", "magnitude", "albedo")})

    setattr(scheduler, "gather_tiles", cut)


def short_reach(setattr):
    from sgrt_tpu_torch.ops import tiling

    real = tiling.project_gaussians

    def shrunk(*a, **kw):
        mu2, sigma_p, valid = real(*a, **kw)
        return mu2, sigma_p * (2.5 / 3.3), valid

    setattr(tiling, "project_gaussians", shrunk)


FAULTS = {"half_dense": half_dense, "one_chunk": one_chunk, "stale_t": stale_t,
          "adam_skipped": adam_skipped, "dense_unscattered": dense_unscattered,
          "short_reach": short_reach}
