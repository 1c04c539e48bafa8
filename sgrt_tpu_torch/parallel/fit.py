"""Differentiable scene fitting (PyTorch port of sgrt_tpu.parallel.fit).

Optimize Gaussian means / sigmas / magnitudes / albedos against target
pixels by gradient descent. The tiled frame step is the north-star
training configuration: per-frame re-tiling (no gradient), gather, the
fused CUDA forward and its analytic backward (ops.cuda_render.TileRender),
the gather's transpose as a scatter-add of tile gradients into the scene,
then an Adam step.

Optimizers: where the JAX package takes an optax transformation, the port
takes a factory params → torch.optim.Optimizer (`adam(lr)` is the
counterpart of optax.adam(lr)). A torch optimizer holds both the update
rule and its state, so only init_state takes the factory: it builds the
optimizer over the scene's four fields and keeps it in the state, and the
step builders take no optimizer. A train step hands the optimizer the
gradients of the trainable fields only, so the other fields get no
gradient and no update and stay bit-identical, as optax's zero-gradient
Adam update leaves them. Steps update the state in place and return it.

make_slab_frame_train_step is the fitting-scale step: one forward and
backward per slab of count-sorted tiles, gradients summed across slabs,
Adam applied once, for isotropic or (aniso=True) anisotropic scenes.
make_aniso_frame_train_step fits anisotropic scenes
(ops.anisotropic.AnisoScene: per-axis scales) through the fused
anisotropic kernels, or the chunked ones above MAX_BWD_CAPACITY_ANISO.
init_state and the steps take either scene class and work over its
dataclass fields.

Over a mesh (parallel.mesh: one process a rank in a torch.distributed
group) the scene is replicated: init_state broadcasts it from rank 0, and
every rank applies the same update to the same gradients. The untiled step
takes each rank's shard of the rays; the frame steps compute the same
tiling on every rank and render and differentiate each rank's contiguous
1/D of the tiles (of each bucket, in the scheduler's interleave). The
step's one collective is an all-reduce of one flat buffer, the loss and
the scene's N x 8 gradient floats: a mean of the ranks' means (every rank
holds as many tiles or rays), or for the slab step a sum of the ranks'
sums. Gloo and NCCL both give every rank the same sum bit for bit, so the
ranks' scenes stay equal bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops.anisotropic import FIELDS as ANISO_FIELDS
from sgrt_tpu_torch.ops.frame import BACKENDS
from sgrt_tpu_torch.ops.render import _radiance_block, _tile_rays, render_rays_impl
from sgrt_tpu_torch.ops.tiling import tile_indices
from sgrt_tpu_torch.parallel.mesh import replicate, shard_rays
from sgrt_tpu_torch.utils.trace import span

FIELDS = ("mu", "sigma", "magnitude", "albedo")


def scene_fields(scene) -> tuple[str, ...]:
    """The field names of a scene dataclass (GaussianScene or AnisoScene),
    in order."""
    return tuple(f.name for f in dataclasses.fields(scene))


@dataclasses.dataclass
class FitState:
    scene: GaussianScene                 # or AnisoScene; leaf tensors, updated in place
    opt_state: torch.optim.Optimizer     # over the scene's four fields
    step: int = 0


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The counterpart of optax.adam(lr, b1, b2, eps): a factory that
    builds torch.optim.Adam over the given parameters (the same update,
    lr * m_hat / (sqrt(v_hat) + eps))."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(b1, b2), eps=eps)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _check_bwd_capacity(capacity, bucket_cfg, backend) -> None:
    """Fail when the step is built, not in its first launch. Capacities up
    to MAX_MONOLITHIC_CAPACITY (anisotropic: MAX_BWD_CAPACITY_ANISO) take
    the fused kernels, above it the chunked kernels (ops.cuda_chunked,
    ops.cuda_chunked_aniso), whose ceiling is MAX_CHUNKED_CAPACITY: only
    beyond that is the tile grid too coarse for the scene."""
    if backend != "kernel":
        return
    from sgrt_tpu_torch.ops.cuda_chunked import MAX_CHUNKED_CAPACITY

    caps = [capacity]
    if bucket_cfg is not None:
        caps += [bucket_cfg.cap_dense, bucket_cfg.cap_sparse]
    worst = max(caps)
    if worst > MAX_CHUNKED_CAPACITY:
        raise ValueError(
            f"per-tile capacity {worst} exceeds even the chunked backward "
            f"kernel's ceiling ({MAX_CHUNKED_CAPACITY}); use a finer tile grid "
            "so fewer Gaussians land in each tile (ops.frame.auto_tile_grid)")


def init_state(scene, optimizer, mesh=None) -> FitState:
    """A fit state over copies of the scene's fields (the caller's scene is
    never updated), with the optimizer built over them. scene is a
    GaussianScene or an AnisoScene. With a mesh, every rank starts from
    rank 0's scene (one broadcast)."""
    if mesh is not None:
        scene = replicate(mesh, scene)
    fields = scene_fields(scene)
    scene = type(scene)(**{f: getattr(scene, f).detach().clone() for f in fields})
    return FitState(scene, optimizer([getattr(scene, f) for f in fields]), 0)


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def _apply_updates(state: FitState, grads, trainable) -> None:
    """One optimizer step: the trainable fields get their gradients, the
    others none (the optimizer skips them)."""
    with span("optimizer"):
        for f in scene_fields(state.scene):
            getattr(state.scene, f).grad = getattr(grads, f) if f in trainable else None
        state.opt_state.step()
    state.step += 1


class TileOutput(NamedTuple):
    """One tile of a frame step, handed over on request (vg's per_tile)."""
    colors: torch.Tensor     # (P, 3), the tile's rays in tile order
    members: torch.Tensor    # (k,) int64: the scene indices of its live rows, ascending
    grads: dict              # trainable field → (k, ...): the gradient of the tile's
                             # share of the frame loss at its members


def _value_and_grad(loss_of, scene, trainable, at=None):
    """loss_of(masked scene) → (loss, aux); returns ((loss, aux), grads,
    at_grads): grads a scene of the same class, gradients of the trainable
    fields, zeros for the frozen ones (the JAX package's stop_gradient
    mask); at_grads the gradients at the tensors that at() returns once
    loss_of has run (tensors of its graph), from the same autograd call,
    [] when at is None."""
    fields = scene_fields(scene)
    leaves = {f: getattr(scene, f).detach().requires_grad_(f in trainable) for f in fields}
    loss, aux = loss_of(type(scene)(**leaves))
    wrt = [f for f in fields if f in trainable]
    extra = list(at()) if at is not None and wrt else []
    got, at_grads = {}, []
    if wrt:
        with span("backward"):
            g = torch.autograd.grad(loss, [leaves[f] for f in wrt] + extra)
        got, at_grads = dict(zip(wrt, g)), list(g[len(wrt):])
    grads = type(scene)(**{f: got.get(f, torch.zeros_like(leaves[f])) for f in fields})
    return (loss.detach(), aux), grads, at_grads


def _tile_outputs(want, colors, rows, at_grads, wrt, n):
    """{tile id: TileOutput} of the tiles `want`. colors (M, P, 3) in
    the order of rows, per bucket (tile ids, indices, gathered scene);
    at_grads the gradients at each bucket's gathered fields `wrt`, bucket
    after bucket. Waits for the device."""
    want, out, pos, k = {int(t) for t in want}, {}, 0, 0
    for ids, idx, _ in rows:
        live = idx != n
        sizes = live.sum(1).tolist()
        members = idx[live].long().split(sizes)
        grads = {f: g[live].split(sizes) for f, g in zip(wrt, at_grads[k:k + len(wrt)])}
        k += len(wrt)
        for p, t in enumerate(ids.tolist()):
            if t in want:
                out[t] = TileOutput(colors[pos + p].detach(), members[p],
                                    {f: g[p] for f, g in grads.items()})
        pos += ids.numel()
    if len(out) != len(want):
        raise ValueError(f"no such tiles in the frame: {sorted(want - set(out))}")
    return out


def _reduce_over_mesh(mesh, loss, grads, *, mean: bool = True):
    """The loss and gradients summed over the mesh (mean=True: averaged)
    by one all-reduce of one flat buffer; unchanged without a mesh."""
    if mesh is None:
        return loss, grads
    fields = scene_fields(grads)
    out = mesh.all_reduce([loss, *(getattr(grads, f) for f in fields)], mean=mean)
    return out[0], type(grads)(**dict(zip(fields, out[1:])))


def make_train_step(mesh=None, loss_fn: Callable = l2_loss,
                    q_block: int = 128, ray_block: int = 2048,
                    trainable: tuple[str, ...] = FIELDS, backend: str = "torch"):
    """Untiled train step: step(state, o, dirs, target) → (state, loss).

    backend="kernel" renders through the fused kernel and its analytic
    backward (ops.cuda_render.render_rays; the JAX package's
    "pallas"); "torch" differentiates the plain renderer by autograd
    (ops.render; the JAX package's "xla"). With a mesh, dirs and target are
    this rank's shards (parallel.mesh.shard_rays), and the loss and the
    gradients are their means over the mesh."""
    _check_backend(backend)

    def step(state: FitState, o, dirs, target):
        def loss_of(scene):
            if backend == "kernel":
                from sgrt_tpu_torch.ops.cuda_render import render_rays

                colors = render_rays(o, dirs, scene)
            else:
                colors = render_rays_impl(o, dirs, scene, q_block, ray_block)
            return loss_fn(colors, target), None

        (loss, _), grads, _ = _value_and_grad(loss_of, state.scene, trainable)
        loss, grads = _reduce_over_mesh(mesh, loss, grads)
        _apply_updates(state, grads, trainable)
        return state, loss

    return step


def _torch_tile_render(tiled: GaussianScene, o, d, q_block: int, tile_batch: int):
    """Per-tile plain render for training: tiles in batches, each batch
    checkpointed, so the backward recomputes a batch's pairwise
    intermediates instead of keeping every batch's (the JAX package's
    _xla_tile_render)."""
    t2 = d.shape[0]
    tb = min(tile_batch, t2)
    while t2 % tb:
        tb -= 1
    k = tiled.sigma.shape[1]
    q_block = min(q_block, k)
    while k % q_block:
        q_block -= 1

    def batch(mu, sigma, mag, alb, dirs):
        return _radiance_block(o, dirs, GaussianScene(mu, sigma, mag, alb), q_block)

    return torch.cat([
        checkpoint(batch, *(getattr(tiled, f)[t:t + tb] for f in FIELDS), d[t:t + tb],
                   use_reentrant=False)
        for t in range(0, t2, tb)])


def make_frame_value_and_grad(*, width: int = 256, height: int = 256, tiles=16,
                              capacity: int = 128, backend: str = "kernel",
                              erf_name: str = "as5", exp_name: str = "exact",
                              trainable: tuple[str, ...] = FIELDS, bucket_cfg=None,
                              focal_length=1.0, q_block: int = 128, tile_batch: int = 16,
                              mesh=None, aniso: bool = False):
    """Frame loss and gradient: vg(scene, view, o, dirs, target) → ((loss,
    overflow), grads), grads a scene of the same class (zeros for frozen
    fields). The gradient core of the frame steps, exposed so callers can
    compare raw gradients across backends or meshes without an optimizer.

    backend="kernel" routes tiles through tile_renderer_for (the fused
    kernels, or the chunked ones above MAX_MONOLITHIC_CAPACITY); aniso=True
    takes an AnisoScene, culled on its iso_proxy (the row geometry
    ops.cuda_render.ANISO). bucket_cfg with n_dense > 0 renders a dense
    and a sparse bucket (ops.scheduler.make_bucketed_renderer); a config
    with n_dense = 0 renders one launch at max(capacity, cap_dense), the
    probed capacity. backend="torch" differentiates the plain per-tile
    renderer (q_block, tile_batch) and, as the JAX package's "xla" route,
    ignores bucket_cfg and erf_name/exp_name. Tile indices carry no
    gradient; overflow counts the frame's tiles over capacity.

    With a mesh, dirs and target are the whole frame's on every rank: every
    rank computes the whole frame's tiling and the loss and gradients of
    its contiguous 1/D of the tiles (of each bucket, in the scheduler's
    interleave), then their means over the mesh by one all-reduce; every
    rank holds as many tiles, so the mean of the ranks' means is the
    frame's. A tile count, or bucket sizes, the mesh does not divide raise
    ValueError. mesh None is one rank holding every tile.

    vg(..., per_tile=d), d a dict keyed by tile ids, also sets d[tile] to
    that tile's TileOutput: its colors, its members and the gradient of its
    share of the frame loss (its sum of squares over H*W*3) at its members,
    taken at the gathered rows in the same autograd call: what the gather's
    transpose scatters into the scene. Without the request vg runs the same
    launches and returns the same tensors; with a mesh the request raises
    ValueError."""
    from sgrt_tpu_torch.ops import cuda_chunked
    from sgrt_tpu_torch.ops.cuda_render import ANISO, ISO
    from sgrt_tpu_torch.ops.tiling import as_grid

    _check_backend(backend)
    geometry = ANISO if aniso else ISO
    if backend != "kernel":
        bucket_cfg = None
    elif bucket_cfg is not None and not bucket_cfg.n_dense:
        capacity, bucket_cfg = max(capacity, bucket_cfg.cap_dense), None
    _check_bwd_capacity(capacity, bucket_cfg, backend)
    tx, ty = as_grid(tiles)
    mine = slice(None) if mesh is None else mesh.shard(tx * ty)

    def mean_over_mesh(loss_of, scene, per_tile, held):
        """The loss and gradients, means over the mesh; on request per_tile
        filled from held, the (colors, rows) that loss_of keeps."""
        at = wrt = None
        if per_tile is not None:
            if mesh is not None:
                raise ValueError("per-tile outputs are not given over a mesh")
            wrt = [f for f in scene_fields(scene) if f in trainable]
            at = lambda: [getattr(r, f) for _, _, r in held[0][1] for f in wrt]  # noqa: E731
        (loss, overflow), grads, at_grads = _value_and_grad(loss_of, scene, trainable, at)
        if per_tile is not None:
            per_tile.update(_tile_outputs(per_tile, *held[0], at_grads, wrt,
                                          scene.mu.shape[0]))
        loss, grads = _reduce_over_mesh(mesh, loss, grads)
        return (loss, overflow), grads

    if bucket_cfg is not None:
        from sgrt_tpu_torch.ops.scheduler import make_bucketed_renderer

        render_mine = make_bucketed_renderer(bucket_cfg, tiles=tiles, aniso=aniso, mesh=mesh,
                                             erf_name=erf_name, exp_name=exp_name,
                                             focal_length=focal_length)

        def vg(scene, view, o, dirs, target, per_tile=None):
            with span("tiling"):
                d = _tile_rays(dirs, height, width, tiles)
                tgt = _tile_rays(target.reshape(-1, 3), height, width, tiles)
            held = []

            def loss_of(s):
                out = render_mine(s, view, o, d)
                if per_tile is not None:
                    held.append((out.colors, out.rows))
                return torch.mean((out.colors - tgt[out.ids]) ** 2), out.overflow

            return mean_over_mesh(loss_of, scene, per_tile, held)

        return vg

    if backend == "kernel":
        capacity, render = cuda_chunked.tile_renderer_for(
            capacity, geometry=geometry, erf_name=erf_name, exp_name=exp_name)
    else:
        from sgrt_tpu_torch.ops.cuda_kernel import _block_sizes

        _, qb = _block_sizes(capacity)
        capacity = -(-capacity // qb) * qb

        def render(tiled, o, d, counts):
            return _torch_tile_render(tiled, o, d, min(q_block, capacity), tile_batch)

    def vg(scene, view, o, dirs, target, per_tile=None):
        with torch.no_grad():
            idx, counts = tile_indices(geometry.proxy(scene), view, tiles, capacity,
                                       focal_length=focal_length)
        with span("tiling"):
            overflow = torch.sum(counts > capacity, dtype=torch.int32)
            d = _tile_rays(dirs, height, width, tiles)[mine]
            tgt = _tile_rays(target.reshape(-1, 3), height, width, tiles)[mine]
        held = []

        def loss_of(s):
            rows = geometry.gather(s, idx[mine])
            colors = render(rows, o, d, counts[mine])
            if per_tile is not None:
                ids = torch.arange(tx * ty, device=idx.device)[mine]
                held.append((colors, [(ids, idx[mine], rows)]))
            return torch.mean((colors - tgt) ** 2), overflow

        return mean_over_mesh(loss_of, scene, per_tile, held)

    return vg


def _step_of(vg, trainable):
    """The frame step around vg: step(state, view, o, dirs, target,
    per_tile=None) → (state, loss, overflow), the update applied in place;
    per_tile as vg's."""
    def step(state: FitState, view, o, dirs, target, per_tile=None):
        (loss, overflow), grads = vg(state.scene, view, o, dirs, target, per_tile=per_tile)
        _apply_updates(state, grads, trainable)
        return state, loss, overflow

    return step


def make_frame_train_step(*, width: int = 256, height: int = 256,
                          tiles=16, capacity: int = 128, mesh=None, backend: str = "kernel",
                          erf_name: str = "as5", exp_name: str = "exact",
                          trainable: tuple[str, ...] = FIELDS, bucket_cfg=None,
                          focal_length=1.0):
    """Tiled whole-frame train step, the north-star fwd+bwd configuration:
    step(state, view, o, dirs, target_image) → (state, loss, overflow).

    Per-frame re-tiling (no gradient), gather, fused forward and analytic
    backward, scatter-add of the tile gradients back to the scene (the
    gather's transpose), Adam. overflow (0-d int32) counts tiles whose true
    member count exceeded their capacity this step: nonzero means
    Gaussians were dropped from the loss and its gradients, and callers
    must check it (fit_cli warns). bucket_cfg: dense/sparse capacity
    bucketing of tiles (ops.scheduler). With a mesh, dirs and target are
    the whole frame's on every rank, and the tiles are split over the
    ranks (make_frame_value_and_grad)."""
    return _step_of(make_frame_value_and_grad(
        width=width, height=height, tiles=tiles, capacity=capacity, backend=backend,
        erf_name=erf_name, exp_name=exp_name, trainable=trainable, bucket_cfg=bucket_cfg,
        focal_length=focal_length, mesh=mesh), trainable)


def make_slab_frame_train_step(*, width: int = 512, height: int = 512, tiles=(64, 32),
                               capacity: int = 4096, slab_tiles: int = 64, mesh=None,
                               erf_name: str = "as5", exp_name: str = "exact",
                               trainable: tuple[str, ...] | None = None, aniso: bool = False,
                               focal_length=1.0):
    """Host-slabbed train step for fitting-scale dense scenes:
    step(state, view, o, dirs, target) → (state, loss, overflow).

    The tiles, sorted by count (densest first, a stable sort so that tiles
    of equal count keep their order, as jnp.argsort does), are cut into
    slabs of `slab_tiles` (the largest divisor of the tile count not above
    it that the mesh size divides). Each slab runs one forward and backward
    through tile_renderer_for (the chunked kernels above
    MAX_MONOLITHIC_CAPACITY) on its sum-of-squares loss; the slabs' losses
    and gradients add exactly, since the frame loss is a sum over pixels,
    and Adam applies once to their sum over H*W*3. A slab's saved-T
    residual and scratch are freed before the next slab, so slab_tiles
    bounds the step's memory.

    With a mesh each rank takes its contiguous 1/D of every slab (the slab
    is a count-sorted range, so the ranks' shares carry near-equal counts),
    sums its slabs' losses and gradients, and one SUM all-reduce adds the
    ranks' sums before the update. A tile count the mesh does not divide
    raises ValueError.

    aniso=True fits an ops.anisotropic.AnisoScene the same way, on the row
    geometry ops.cuda_render.ANISO: tiles from the max-scale proxy
    (iso_proxy), the anisotropic gather, and tile_renderer_for's anisotropic
    route (the chunked anisotropic kernels above MAX_BWD_CAPACITY_ANISO)."""
    from sgrt_tpu_torch.ops import cuda_chunked
    from sgrt_tpu_torch.ops.cuda_render import ANISO, ISO
    from sgrt_tpu_torch.ops.tiling import as_grid

    _check_bwd_capacity(capacity, None, "kernel")
    geometry = ANISO if aniso else ISO
    capacity, render = cuda_chunked.tile_renderer_for(capacity, geometry=geometry,
                                                      erf_name=erf_name, exp_name=exp_name)
    fields = geometry.fields
    trainable = fields if trainable is None else trainable
    tx, ty = as_grid(tiles)
    t2 = tx * ty
    n_dev, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if t2 % n_dev:
        raise ValueError(f"tile count {t2} not divisible by the mesh ({n_dev} ranks)")
    slab_tiles = max(n_dev, min(slab_tiles, t2))
    while t2 % slab_tiles or slab_tiles % n_dev:
        slab_tiles -= 1      # the largest divisor of t2 that the mesh divides
    per_rank = slab_tiles // n_dev
    norm = float(height * width * 3)

    def step(state: FitState, view, o, dirs, target):
        with torch.no_grad():
            idx, counts = tile_indices(geometry.proxy(state.scene), view, tiles, capacity,
                                       focal_length=focal_length)
            order = torch.argsort(-counts, stable=True)
            overflow = torch.sum(counts > capacity, dtype=torch.int32)
        idx, counts = idx[order], counts[order]
        d = _tile_rays(dirs, height, width, tiles)[order]
        tgt = _tile_rays(target.reshape(-1, 3), height, width, tiles)[order]
        total, grads = None, None
        for s0 in range(rank * per_rank, t2, slab_tiles):
            sl = slice(s0, s0 + per_rank)

            def loss_of(sc):
                colors = render(geometry.gather(sc, idx[sl]), o, d[sl], counts[sl])
                return torch.sum((colors - tgt[sl]) ** 2), None

            (loss, _), g, _ = _value_and_grad(loss_of, state.scene, trainable)
            if total is None:
                total, grads = loss, g
            else:
                total = total + loss
                grads = type(g)(**{f: getattr(grads, f) + getattr(g, f) for f in fields})
        total, grads = _reduce_over_mesh(mesh, total, grads, mean=False)
        grads = type(grads)(**{f: getattr(grads, f) / norm for f in fields})
        _apply_updates(state, grads, trainable)
        return state, total / norm, overflow

    return step


def make_aniso_frame_train_step(*, width: int = 256, height: int = 256, tiles=16,
                                capacity: int = 128, mesh=None, erf_name: str = "as5",
                                exp_name: str = "exact",
                                trainable: tuple[str, ...] = ANISO_FIELDS, bucket_cfg=None,
                                focal_length=1.0):
    """Tiled whole-frame train step for anisotropic scenes, the
    diagonal-covariance sibling of make_frame_train_step:
    step(state, view, o, dirs, target) → (state, loss, overflow), state.scene
    an ops.anisotropic.AnisoScene.

    Per-frame re-tiling on the conservative max-scale footprint (iso_proxy,
    no gradient), the packed 10-column gather, the anisotropic kernels'
    forward and analytic backward (ops.cuda_aniso, saved-T chosen by
    SAVE_T_MAX_BYTES, or ops.cuda_chunked_aniso; gradients include the
    per-axis scales), the gather's transpose as a scatter-add, Adam.
    bucket_cfg: dense/sparse capacity bucketing as in the isotropic step,
    bucket membership from the iso_proxy counts; a config with n_dense = 0
    renders one launch at max(capacity, cap_dense). Capacities route through
    tile_renderer_for: above MAX_BWD_CAPACITY_ANISO to the chunked
    anisotropic kernels (recompute backward), and above
    MAX_CHUNKED_CAPACITY the step refuses to build. With a mesh the tiles
    (each bucket) are split over the ranks as in make_frame_train_step."""
    return _step_of(make_frame_value_and_grad(
        width=width, height=height, tiles=tiles, capacity=capacity, erf_name=erf_name,
        exp_name=exp_name, trainable=trainable, bucket_cfg=bucket_cfg,
        focal_length=focal_length, mesh=mesh, aniso=True), trainable)


def fit(scene: GaussianScene, o, dirs, target, steps: int = 200,
        learning_rate: float = 1e-2, mesh=None, optimizer=None,
        callback: Callable[[int, float], None] | None = None,
        checkpoint_dir: str | None = None, checkpoint_every: int = 100,
        **step_kwargs) -> tuple[GaussianScene, list]:
    """Fit a scene to target ray colors with the untiled step → (fitted
    scene, loss history). checkpoint_dir saves every `checkpoint_every`
    steps and at the end (resumable with utils.checkpoint.restore_fit).

    With a mesh, dirs and target are the whole batch on every rank (each
    rank fits its shard_rays share); rank 0 alone writes the checkpoints,
    and every rank waits for each write at a barrier."""
    step_fn = make_train_step(mesh=mesh, **step_kwargs)
    state = init_state(scene, optimizer or adam(learning_rate), mesh)
    if mesh is not None:
        dirs, target = shard_rays(mesh, dirs, target)
    mgr = None
    if checkpoint_dir is not None and (mesh is None or mesh.rank == 0):
        from sgrt_tpu_torch.utils.checkpoint import make_manager

        mgr = make_manager(checkpoint_dir)

    def save(state):
        if mgr is not None:
            mgr.save(state.step, state)
        if mesh is not None:
            mesh.barrier()

    losses = []
    for i in range(steps):
        state, loss = step_fn(state, o, dirs, target)
        losses.append(loss)      # read once at the end: no wait per step
        if callback is not None:
            callback(i, float(loss))
        if checkpoint_dir is not None and (i + 1) % checkpoint_every == 0:
            save(state)
    if checkpoint_dir is not None:
        save(state)
    return state.scene, [float(v) for v in losses]
