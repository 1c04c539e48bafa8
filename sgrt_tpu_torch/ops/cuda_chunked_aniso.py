"""The chunked anisotropic renderer and its analytic backward on
hand-written CUDA kernels (PyTorch port of sgrt_tpu.ops.pallas_chunked_aniso).

The fused anisotropic op's function (ops.cuda_aniso) with the Gaussian axis
cut into C = N / ck chunks of ck rows, for per-tile capacities above
MAX_BWD_CAPACITY_ANISO; exact for the reason ops.cuda_chunked gives (the
transmittance exponent is additive over Gaussians). Two kernels, each with
a wrapper that launches it for tensors on the card (or raises) and runs its
plain version for tensors on the CPU:

    chunked_forward_aniso   csrc/fused_fwd.cu    colors  (_chunked_fwd_aniso_kernel)
    chunked_backward_aniso  csrc/chunked_bwd.cu  the VJP, recomputing T
                                                 (_chunked_bwd_aniso_kernel)

The forward launches the fused anisotropic forward's entry point
(sgrt_fused_fwd_aniso) with its own launch count, for the reason the
isotropic chunked forward does (ops.cuda_chunked): the TPU chunks only
because a dense tile's rows do not fit VMEM, and fused_fwd.cu already
splits the p axis over 32-row blocks. The backward is csrc/chunked_bwd.cu's
p-side/q-side split over AnisoGeo rows (sgrt_chunked_bwd_aniso). The JAX
package has no saved-T variant of this route (recompute is its schedule at
chunked scale, pallas_chunked_aniso.py:19-22), and neither has the port.

The plain versions are the fused anisotropic ones behind the chunk-count
contract. The JAX package's packed (B, 16, N) operand is TPU lane padding;
the kernels take the fused anisotropic kernels' unpacked operands, and
invd = scale^-2 is formed by the caller so that autograd gives d scale.
"""

from __future__ import annotations

import torch

from sgrt_tpu_torch.ops.anisotropic import AnisoScene
from sgrt_tpu_torch.ops.cuda_aniso import (
    _aniso_shapes,
    fused_backward_aniso_plain,
    fused_forward_aniso_plain,
)
from sgrt_tpu_torch.ops.cuda_chunked import (
    DEFAULT_CHUNK,
    _check_chunks,
    _chunked_backward_launch,
    _chunked_blocks,
    _ChunkedOpts,
)
from sgrt_tpu_torch.ops.cuda_kernel import (
    CudaKernel,
    _block_sizes,
    _check_inputs,
    _forward_launch,
    _kernel_erf_name,
)

_TPU = "sgrt_tpu/ops/pallas_chunked_aniso.py"
CHUNKED_FWD_ANISO = CudaKernel("chunked_fwd_aniso", "fused_fwd.cu", "sgrt_fused_fwd_aniso",
                               f"{_TPU}:78", 8, 8)
CHUNKED_BWD_ANISO = CudaKernel("chunked_bwd_aniso", "chunked_bwd.cu", "sgrt_chunked_bwd_aniso",
                               f"{_TPU}:199", 13, 8)


# ---------------------------------------------------------------------------
# plain versions: the fused anisotropic ones, behind the chunk-count contract
# ---------------------------------------------------------------------------

def chunked_forward_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, *, ck: int,
                                erf_name: str = "as5", exp_name: str = "exact") -> torch.Tensor:
    """The chunked anisotropic forward kernel's function in tensor ops:
    colors (B,3,R)."""
    _check_chunks(oc.shape[1], ck)
    return fused_forward_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, erf_name=erf_name,
                                     exp_name=exp_name)


def chunked_backward_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, dcol, *, ck: int,
                                 erf_name: str = "as5", exp_name: str = "exact"):
    """The chunked anisotropic backward kernel's function in tensor ops,
    recomputing T: (doc, dinvd, dmag, dalbedo, ddirs)."""
    _check_chunks(oc.shape[1], ck)
    return fused_backward_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, dcol,
                                      erf_name=erf_name, exp_name=exp_name)


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors (or raise), the plain version for CPU
# ---------------------------------------------------------------------------

def chunked_forward_aniso(oc, invd, mag, albedo, dirs_t, counts, *, ck: int, rb: int = 128,
                          pb: int = 8, qb: int = 32, erf_name: str = "as5",
                          exp_name: str = "exact") -> torch.Tensor:
    """Wrapper of the chunked anisotropic forward kernel: oc, invd (B,N,3),
    mag (B,N), albedo (B,N,3), dirs_t (B,3,R), counts (B,) → colors
    (B,3,R). CUDA tensors go to the kernel (which raises for what it does
    not take), CPU tensors to chunked_forward_aniso_plain."""
    args = (oc, invd, mag, albedo, dirs_t, counts)
    _check_chunks(oc.shape[1], ck)
    if not _check_inputs("chunked_forward_aniso", _aniso_shapes(*args), oc.device):
        return chunked_forward_aniso_plain(*args, ck=ck, erf_name=erf_name, exp_name=exp_name)
    return _forward_launch(CHUNKED_FWD_ANISO, args, None, rb=rb, pb=pb, qb=qb,
                           erf_name=erf_name, exp_name=exp_name)


def chunked_backward_aniso(oc, invd, mag, albedo, dirs_t, counts, dcol, *, ck: int,
                           rb: int = 128, qb: int = 32, erf_name: str = "as5",
                           exp_name: str = "exact"):
    """Wrapper of the chunked anisotropic backward kernel: the VJP for the
    cotangent dcol (B,3,R), recomputing T → (doc (B,N,3), dinvd (B,N,3),
    dmag (B,N), dalbedo (B,N,3), ddirs (B,3,R)). CPU tensors go to
    chunked_backward_aniso_plain. rb caps the rays per block; qb is the rows
    staged per shared-memory pass, the forward's, so that the recomputed T
    is the forward's bit for bit."""
    args = (oc, invd, mag, albedo, dirs_t, counts)
    want = _aniso_shapes(*args)
    b, n, _ = oc.shape
    _check_chunks(n, ck)
    want["dcol"] = (dcol, (b, 3, dirs_t.shape[-1]))
    if not _check_inputs("chunked_backward_aniso", want, oc.device):
        return chunked_backward_aniso_plain(*args, dcol, ck=ck, erf_name=erf_name,
                                            exp_name=exp_name)
    return _chunked_backward_launch(CHUNKED_BWD_ANISO, args, dcol, None, ck=ck, rb=rb, qb=qb,
                                    erf_name=erf_name, exp_name=exp_name)


# ---------------------------------------------------------------------------
# the differentiable op and the render entry points
# ---------------------------------------------------------------------------

class ChunkedRenderAniso(torch.autograd.Function):
    """colors = chunked anisotropic forward(oc, invd, mag, albedo, dirs_t,
    counts) with the analytic backward, which recomputes T (the counterpart
    of the JAX package's _make_chunked_aniso_op). Gradients flow to oc,
    invd, mag, albedo and the ray directions; counts gets None."""

    @staticmethod
    def forward(ctx, oc, invd, mag, albedo, dirs_t, counts, opts: _ChunkedOpts):
        colors = chunked_forward_aniso(oc, invd, mag, albedo, dirs_t, counts, ck=opts.ck,
                                       rb=opts.rb, pb=opts.pb, qb=opts.qb,
                                       erf_name=opts.erf_name, exp_name=opts.exp_name)
        ctx.save_for_backward(oc, invd, mag, albedo, dirs_t, counts)
        ctx.opts = opts
        return colors

    @staticmethod
    def backward(ctx, dcol):
        o = ctx.opts
        grads = chunked_backward_aniso(*ctx.saved_tensors, dcol.contiguous(), ck=o.ck,
                                       rb=o.rb_bwd, qb=o.qb, erf_name=o.erf_name,
                                       exp_name=o.exp_name)
        return (*grads, None, None)


def render_fused_chunked_aniso(scene_oc, invd, mag, albedo, dirs_t, counts=None, *,
                               ck: int = DEFAULT_CHUNK, rb: int = 128, pb: int = 8,
                               qb: int = 32, rb_bwd: int | None = None,
                               erf_name: str = "as5", exp_name: str = "exact"):
    """Chunked anisotropic render: oc (B,N,3), invd (B,N,3) = scale^-2, mag
    (B,N), albedo (B,N,3), dirs_t (B,3,R) → colors (B,3,R), the Gaussian
    axis cut into C = N/ck chunks, with the JAX package's block rules
    (ops.cuda_chunked._chunked_blocks); counts default to N and are clamped
    to N. Differentiable through ChunkedRenderAniso (d invd and d dirs
    included) when grad is enabled and an input requires it; otherwise it
    launches the forward kernel alone."""
    erf_name = _kernel_erf_name(erf_name)
    b, n, _ = scene_oc.shape
    ck, rb, rb_bwd, pb, qb = _chunked_blocks(n, dirs_t.shape[2], ck, rb, rb_bwd, pb, qb)
    if counts is None:
        counts = torch.full((b,), n, dtype=torch.int32, device=scene_oc.device)
    counts = torch.clamp(counts.to(torch.int32), max=n)
    inputs = (scene_oc, invd, mag, albedo, dirs_t)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return chunked_forward_aniso(*inputs, counts, ck=ck, rb=rb, pb=pb, qb=qb,
                                     erf_name=erf_name, exp_name=exp_name)
    opts = _ChunkedOpts(ck, rb, rb_bwd, pb, qb, erf_name, exp_name, False)
    return ChunkedRenderAniso.apply(*inputs, counts, opts)


def render_tiles_chunked_aniso(tiled: AnisoScene, o, tile_dirs, counts=None, *,
                               ck: int = DEFAULT_CHUNK, rb: int = 128, pb: int | None = None,
                               qb: int | None = None, rb_bwd: int | None = None,
                               erf_name: str = "as5", exp_name: str = "exact") -> torch.Tensor:
    """Chunked sibling of render_tiles_fused_aniso: tiled AnisoScene fields
    (T2, K, ...) with K up to MAX_CHUNKED_CAPACITY, tile_dirs (T2, P, 3),
    counts (T2,) → per-tile colors (T2, P, 3). o is one (3,) origin or a
    per-tile (T2, 3) batch. Differentiable with respect to mu, scale
    (through invd = scale^-2), magnitude, albedo and the rays."""
    k = tiled.mu.shape[1]
    if pb is None or qb is None:
        dpb, dqb = _block_sizes(min(k, ck))
        pb = dpb if pb is None else pb
        qb = dqb if qb is None else qb
    o_b = o[None, None, :] if o.dim() == 1 else o[:, None, :]
    oc = (tiled.mu - o_b).contiguous()
    invd = (1.0 / (tiled.scale * tiled.scale)).contiguous()
    dirs_t = tile_dirs.transpose(1, 2).contiguous()
    colors_t = render_fused_chunked_aniso(
        oc, invd, tiled.magnitude.contiguous(), tiled.albedo.contiguous(), dirs_t, counts,
        ck=ck, rb=rb, pb=pb, qb=qb, rb_bwd=rb_bwd, erf_name=erf_name, exp_name=exp_name)
    return colors_t.transpose(1, 2)
