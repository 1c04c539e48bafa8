"""The differentiable render on csrc/chunked.cu's kernels, for both row
geometries and both chunkings (PyTorch port of the JAX package's
_make_fused_op, _make_fused_aniso_op, _make_chunked_op and
_make_chunked_aniso_op).

Every per-tile kernel is one template of csrc/chunked.cu over a row
geometry (IsoGeo, AnisoGeo) and a chunk size ck, a fused kernel being the
chunked one at ck = N, so the routes differ only in data: a Geometry
record each (ISO, ANISO; geometry_of picks one by the scene's class), one
autograd op (TileRender) and its front doors for batched operands
(render_batched), gathered tiles (render_tiles) and a flat ray batch
(render_rays). ops.cuda_chunked.tile_renderer_for routes a capacity of
either geometry to one chunk or to chunk_plan's chunks.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable

import torch

from sgrt_tpu_torch.models.gaussians import GaussianScene, pad_scene
from sgrt_tpu_torch.ops import anisotropic, cuda_aniso, cuda_chunked, cuda_kernel
from sgrt_tpu_torch.ops import cuda_chunked_aniso
from sgrt_tpu_torch.ops.cuda_kernel import _block_sizes, _kernel_erf_name, save_t_bytes
from sgrt_tpu_torch.ops.render import _unit_pad
from sgrt_tpu_torch.ops.tiling import gather_tiles
from sgrt_tpu_torch.utils.trace import count_saved_t, span


@dataclasses.dataclass(frozen=True)
class Wrappers:
    """The forward, forward-with-T and backward wrappers of one geometry at
    one chunking, by name in their module. They are looked up at each
    launch, so that a wrapper replaced in its module is the one launched."""

    module: types.ModuleType
    forward: str
    forward_t: str
    backward: str

    def get(self, which: str) -> Callable:
        return getattr(self.module, getattr(self, which))


def _invd(scene) -> torch.Tensor:
    """invd = scale^-2, formed here so that autograd gives d scale."""
    return 1.0 / (scene.scale * scene.scale)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """What one row geometry of the kernels takes from a scene, and the
    kernels that render it."""

    scene: type                         # GaussianScene or ops.anisotropic.AnisoScene
    fields: tuple[str, ...]             # the scene's fields, in order
    operand: Callable                   # scene → the kernels' shape operand: sigma (..., N)
                                        # or invd = scale^-2 (..., N, 3)
    gather: Callable                    # (scene, idx (T2, K)) → tiles with (T2, K) axes
    proxy: Callable                     # scene → the GaussianScene its tiles are culled on
    pad: Callable                       # (scene, multiple) → padded with inert rows
    ceiling: Callable[[], int]          # the most rows one chunk renders, read at each routing
    fused: Wrappers                     # at one chunk
    chunked: Wrappers                   # at C = N / ck chunks


ISO = Geometry(
    GaussianScene, ("mu", "sigma", "magnitude", "albedo"), lambda s: s.sigma,
    gather_tiles, lambda s: s, pad_scene, lambda: cuda_chunked.MAX_MONOLITHIC_CAPACITY,
    Wrappers(cuda_kernel, "fused_forward", "fused_forward_t", "fused_backward"),
    Wrappers(cuda_chunked, "chunked_forward", "chunked_forward_t", "chunked_backward"))
ANISO = Geometry(
    anisotropic.AnisoScene, anisotropic.FIELDS, _invd, anisotropic.gather_tiles_aniso,
    anisotropic.iso_proxy, anisotropic.pad_scene_aniso,
    lambda: cuda_aniso.MAX_BWD_CAPACITY_ANISO,
    Wrappers(cuda_aniso, "fused_forward_aniso", "fused_forward_t_aniso", "fused_backward_aniso"),
    Wrappers(cuda_chunked_aniso, "chunked_forward_aniso", "chunked_forward_t_aniso",
             "chunked_backward_aniso"))


def geometry_of(scene) -> Geometry:
    """The row geometry of a scene, by its class."""
    for geometry in (ISO, ANISO):
        if isinstance(scene, geometry.scene):
            return geometry
    raise TypeError(f"no row geometry renders a {type(scene).__name__}")


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Opts:
    wrappers: Wrappers       # of the geometry, at this chunking
    ck: int | None           # rows a chunk; None: one chunk (the fused wrappers)
    rb: int
    pb: int
    qb: int
    erf_name: str
    exp_name: str
    save_t: bool

    def kw(self, **more) -> dict:
        chunk = {} if self.ck is None else {"ck": self.ck}
        return dict(rb=self.rb, qb=self.qb, erf_name=self.erf_name, exp_name=self.exp_name,
                    **chunk, **more)


class TileRender(torch.autograd.Function):
    """colors = forward(oc, shape, mag, albedo, dirs_t, counts) with the
    analytic backward, over the wrappers in opts: shape is sigma for
    isotropic rows, invd = scale^-2 for anisotropic ones. save_t: the
    forward also writes T and the backward reads it instead of recomputing
    pass A. Gradients flow to oc, shape, mag, albedo and the ray
    directions; counts gets None."""

    @staticmethod
    def forward(ctx, oc, shape, mag, albedo, dirs_t, counts, opts: _Opts):
        inputs = (oc, shape, mag, albedo, dirs_t, counts)
        if opts.save_t:
            colors, t = opts.wrappers.get("forward_t")(*inputs, **opts.kw(pb=opts.pb))
            ctx.save_for_backward(*inputs, t)
        else:
            colors = opts.wrappers.get("forward")(*inputs, **opts.kw(pb=opts.pb))
            ctx.save_for_backward(*inputs)
        ctx.opts = opts
        return colors

    @staticmethod
    def backward(ctx, dcol):
        with span("launch"):
            inputs = list(ctx.saved_tensors)
            t = inputs.pop() if ctx.opts.save_t else None
            grads = ctx.opts.wrappers.get("backward")(*inputs, dcol.contiguous(), t,
                                                       **ctx.opts.kw())
        return (*grads, None, None)


def _blocks(n: int, r: int, ck: int | None, rb: int, pb: int, qb: int):
    """The JAX package's block rules → (ck, rb, pb, qb): rb | R, pb and qb
    multiples of 8, each first taken at most its axis, dividing N (ck None)
    or ck, which is rounded up to a multiple of 128, capped at N and divides
    N, with N at most MAX_CHUNKED_CAPACITY."""
    rb = min(rb, r)
    if ck is None:
        pb, qb = min(pb, n), min(qb, n)
        if r % rb or n % pb or n % qb or pb % 8 or qb % 8:
            raise ValueError(f"shape (R={r}, N={n}) not divisible by blocks "
                             f"(rb={rb}, pb={pb}, qb={qb})")
        return ck, rb, pb, qb
    ck = min(-(-ck // 128) * 128, n)
    pb, qb = min(pb, ck), min(qb, ck)
    if n % ck or ck % pb or ck % qb or r % rb or pb % 8 or qb % 8 or ck % 128:
        raise ValueError(f"shape (R={r}, N={n}) not divisible by chunk/blocks "
                         f"(ck={ck}, rb={rb}, pb={pb}, qb={qb}; "
                         "ck must be a multiple of 128)")
    if n > cuda_chunked.MAX_CHUNKED_CAPACITY:
        raise ValueError(f"padded capacity {n} exceeds MAX_CHUNKED_CAPACITY "
                         f"({cuda_chunked.MAX_CHUNKED_CAPACITY}); use a finer tile grid")
    return ck, rb, pb, qb


# ---------------------------------------------------------------------------
# the front doors
# ---------------------------------------------------------------------------

def render_batched(scene_oc, shape, mag, albedo, dirs_t, counts=None, *,
                   geometry: Geometry = ISO, ck: int | None = None, rb: int = 128,
                   pb: int = 8, qb: int = 32, erf_name: str = "as5",
                   exp_name: str = "exact", save_t: bool | None = None):
    """Batched render: oc (B,N,3), shape (the geometry's operand: sigma
    (B,N) or invd (B,N,3)), mag (B,N), albedo (B,N,3), dirs_t (B,3,R) →
    colors (B,3,R), at one chunk (ck None: the fused kernels) or at C = N /
    ck chunks (the chunked kernels), under _blocks' rules. Counts default
    to N and are clamped to N. When grad is enabled and an input requires
    it, the render goes through TileRender; otherwise the forward kernel
    runs alone. save_t=None saves T when its 20*B*N*R bytes fit the
    chunking's budget: ops.cuda_kernel.SAVE_T_MAX_BYTES at one chunk,
    ops.cuda_chunked.SAVE_T_CHUNKED_MAX_BYTES chunked."""
    b, n, _ = scene_oc.shape
    r = dirs_t.shape[2]
    ck, rb, pb, qb = _blocks(n, r, ck, rb, pb, qb)
    if counts is None:
        counts = torch.full((b,), n, dtype=torch.int32, device=scene_oc.device)
    counts = torch.clamp(counts.to(torch.int32), max=n)
    inputs = (scene_oc, shape, mag, albedo, dirs_t)
    wrappers = geometry.fused if ck is None else geometry.chunked
    opts = _Opts(wrappers, ck, rb, pb, qb, _kernel_erf_name(erf_name), exp_name, False)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return wrappers.get("forward")(*inputs, counts, **opts.kw(pb=pb))
    if save_t is None:
        budget = (cuda_kernel.SAVE_T_MAX_BYTES if ck is None
                  else cuda_chunked.SAVE_T_CHUNKED_MAX_BYTES)
        save_t = save_t_bytes(b, n, r) <= budget
    count_saved_t(save_t_bytes(b, n, r), bool(save_t))
    return TileRender.apply(*inputs, counts, dataclasses.replace(opts, save_t=bool(save_t)))


def render_tiles(tiled, o, tile_dirs, counts=None, *, ck: int | None = None, rb: int = 128,
                 pb: int | None = None, qb: int | None = None, erf_name: str = "as5",
                 exp_name: str = "exact", save_t: bool | None = None) -> torch.Tensor:
    """Per-tile render of gathered tiles of either geometry: fields (T2,
    K, ...), tile_dirs (T2, P, 3), counts (T2,) → colors (T2, P, 3); o one
    (3,) origin or a per-tile (T2, 3) batch; ck as render_batched's; pb and
    qb default to the JAX package's block sizes of K, or of a chunk.
    Differentiable with respect to the fields and the rays."""
    geometry = geometry_of(tiled)
    k = tiled.mu.shape[1]
    dpb, dqb = _block_sizes(k if ck is None else min(k, ck))
    pb = dpb if pb is None else pb
    qb = dqb if qb is None else qb
    with span("launch"):
        o_b = o[None, None, :] if o.dim() == 1 else o[:, None, :]
        oc = (tiled.mu - o_b).contiguous()                   # (T2, K, 3)
        dirs_t = tile_dirs.transpose(1, 2).contiguous()       # (T2, 3, P)
        colors_t = render_batched(
            oc, geometry.operand(tiled).contiguous(), tiled.magnitude.contiguous(),
            tiled.albedo.contiguous(), dirs_t, counts, geometry=geometry, ck=ck, rb=rb, pb=pb,
            qb=qb, erf_name=erf_name, exp_name=exp_name, save_t=save_t)   # (T2, 3, P)
        return colors_t.transpose(1, 2)


def render_rays(o, dirs, scene, *, rb: int = 128, pb: int | None = None, qb: int | None = None,
                erf_name: str = "as5", exp_name: str = "exact") -> torch.Tensor:
    """A flat ray batch of a scene of either geometry as one tile at one
    chunk: dirs (R,3) → colors (R,3), the scene padded with inert rows to a
    multiple of max(pb, qb), the rays to a multiple of rb with a unit
    direction (ops.render._unit_pad). Differentiable."""
    geometry = geometry_of(scene)
    n_live = scene.n
    dpb, dqb = _block_sizes(n_live)
    pb = dpb if pb is None else pb
    qb = dqb if qb is None else qb
    scene = geometry.pad(scene, max(pb, qb))
    r = dirs.shape[0]
    rb = min(rb, r)
    dirs_p = _unit_pad(dirs, (-r) % rb)
    counts = torch.full((1,), n_live, dtype=torch.int32, device=dirs.device)
    oc = (scene.mu - o[None, :]).contiguous()
    colors_t = render_batched(
        oc[None], geometry.operand(scene)[None].contiguous(), scene.magnitude[None].contiguous(),
        scene.albedo[None].contiguous(), dirs_p.T[None].contiguous(), counts,
        geometry=geometry, rb=rb, pb=pb, qb=qb, erf_name=erf_name,
        exp_name=exp_name)[0]   # (3, R)
    return colors_t.T[:r]
