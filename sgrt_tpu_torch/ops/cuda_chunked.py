"""Routing of the per-tile renderer by capacity, and the Gaussian-axis
chunked kernels' wrappers for dense tiles (PyTorch port of
sgrt_tpu.ops.pallas_chunked).

`tile_renderer_for` is THE single place that decides at which chunking a
tile batch of a given capacity renders, for either row geometry
(ops.cuda_render's records): up to the geometry's ceiling of one chunk
(MAX_MONOLITHIC_CAPACITY rows for isotropic rows,
ops.cuda_aniso.MAX_BWD_CAPACITY_ANISO for anisotropic ones) at one chunk,
the fused kernels; above it, up to MAX_CHUNKED_CAPACITY, at
chunk_plan(capacity)'s chunks, the chunked kernels of this module or of
ops.cuda_chunked_aniso. ops.cuda_render holds the one differentiable op
and its front doors.

The chunked kernels compute the fused kernels' function (ops.cuda_kernel's
definitions) with the Gaussian axis cut into C = N / ck chunks of ck rows.
That is exact because the transmittance exponent is additive over
Gaussians; chunk a's live rows are clip(count - a ck, 0, ck) and dead chunk
pairs are skipped, so work follows count^2, not capacity^2. Four kernels of
csrc/chunked.cu, each with a wrapper that launches it for tensors on the
card (or raises) and runs its plain version for tensors on the CPU:

    chunked_forward    colors         (_chunked_fwd_kernel)
    chunked_forward_t  colors and T   (_chunked_fwd_t_kernel)
    chunked_backward   the VJP, from saved T (_chunked_bwd_t_kernel)
                       or recomputing it (_chunked_bwd_kernel)

csrc/chunked.cu's kernels are templates over the row geometry: the
chunked anisotropic route (ops.cuda_chunked_aniso) runs the same ones over
anisotropic rows, and the fused backwards of both geometries
(ops.cuda_kernel.fused_backward, ops.cuda_aniso.fused_backward_aniso) and
the fused anisotropic forwards (ops.cuda_aniso.fused_forward_aniso,
fused_forward_t_aniso) are the same kernels at one chunk, ck = N; every
backward launches through ops.cuda_kernel._chunked_backward_launch, every
forward through ops.cuda_kernel._chunked_forward_launch. Its note gives
the design: warp-wide groups of 4 rows sharing each stage's per-ray terms
through shared-memory planes, the backward's p-side/q-side split, and the recompute
backward as the forward-with-T per chunk ahead of the saved-T backward's
kernels. The TPU chunks the forward only because a whole tile's rows do
not fit VMEM; on the card the forward sweeps the live prefix of the q axis
in one pass and splits the p axis of a dense tile over blocks of 32 rows.

The plain versions are the fused ones (the same function) behind the
chunk-count contract: N must divide into chunks of ck rows, ck a multiple
of 128. The JAX package packs the per-Gaussian fields Gaussian-minor into
one (B, 8, N) operand only to avoid TPU lane padding; the card has none,
so the kernels take the fused kernels' unpacked operands.
"""

from __future__ import annotations

import math

import torch

from sgrt_tpu_torch.ops.cuda_kernel import (
    K_TAPS,
    CudaKernel,
    _backward_on_card,
    _block_sizes,
    _check_inputs,
    _chunked_backward_launch,
    _chunked_forward_launch,
    _scene_shapes,
    fused_backward_plain,
    fused_forward_plain,
    fused_forward_t_plain,
)

# Per-tile capacity above which the JAX package routes to its chunked
# kernels (its MAX_BWD_CAPACITY, a v5e VMEM ceiling). The port's fused
# kernels have no such wall; the card's own crossover is measured beside
# the dense cell (chip_smoke.py, "dense_frame") and routing stays at the
# JAX package's value until a later change sets it from that.
MAX_MONOLITHIC_CAPACITY = 4096

# Ceiling of the chunked route's padded capacity: the JAX package's API
# ceiling, kept so that both packages accept the same capacities.
MAX_CHUNKED_CAPACITY = 65536

# Chunk size of the Gaussian axis (JAX: DEFAULT_CHUNK).
DEFAULT_CHUNK = 2048

# Byte budget of the chunked saved-T residual, 20*B*N*R logical bytes. The
# chunked backward keeps no (row, ray) plane of its own (csrc/chunked.cu:
# its scratch is O(B N) plus, recomputing, one chunk's T), so T is the only
# O(B N R) buffer of a chunked train step. 16 GiB is a fifth of the card's
# 80 GB: a bucketed step holds the T of both buckets until its backward,
# beside the monolithic bucket's own budget (SAVE_T_MAX_BYTES, 8 GiB) and
# its (B,5,N,R) scratch. A whole 512^2 frame of the 50k-Gaussian sphere
# (2048 tiles at capacity 5376) would need 28 GB of T: such launches, or a
# slab step's slabs sized past the budget, take the recompute backward.
SAVE_T_CHUNKED_MAX_BYTES = 16 << 30

_SRC, _TPU = "chunked.cu", "sgrt_tpu/ops/pallas_chunked.py"
CHUNKED_FWD = CudaKernel("chunked_fwd", _SRC, "sgrt_chunked_fwd", f"{_TPU}:176", 8, 8)
CHUNKED_FWD_T = CudaKernel("chunked_fwd_t", _SRC, "sgrt_chunked_fwd_t", f"{_TPU}:245", 9, 8)
CHUNKED_BWD_T = CudaKernel("chunked_bwd_t", _SRC, "sgrt_chunked_bwd_t", f"{_TPU}:522", 15, 8,
                           timed=True)
CHUNKED_BWD = CudaKernel("chunked_bwd", _SRC, "sgrt_chunked_bwd", f"{_TPU}:369", 14, 8,
                         timed=True)


def chunk_plan(capacity: int) -> tuple[int, int]:
    """Size the chunk axis for a per-tile capacity: the smallest chunk
    count C = ceil(capacity / DEFAULT_CHUNK), with the chunk size ck
    rounded up to 128. Returns (padded_capacity = C * ck, ck)."""
    c = max(1, -(-capacity // DEFAULT_CHUNK))
    per = -(-capacity // c)
    ck = -(-per // 128) * 128
    return c * ck, ck


def _check_chunks(n: int, ck: int) -> None:
    """The chunk-count contract: N = C * ck, ck a multiple of 128."""
    if ck < 128 or ck % 128 or n % ck:
        raise ValueError(f"N={n} does not divide into chunks of ck={ck} rows "
                         "(ck a multiple of 128)")


# ---------------------------------------------------------------------------
# plain versions: the fused ones, behind the chunk-count contract
# ---------------------------------------------------------------------------

def chunked_forward_plain(oc, sigma, mag, albedo, dirs_t, counts, *, ck: int,
                          erf_name: str = "as5", exp_name: str = "exact") -> torch.Tensor:
    """The chunked forward kernel's function in tensor ops: colors (B,3,R)."""
    _check_chunks(oc.shape[1], ck)
    return fused_forward_plain(oc, sigma, mag, albedo, dirs_t, counts, erf_name=erf_name,
                               exp_name=exp_name)


def chunked_forward_t_plain(oc, sigma, mag, albedo, dirs_t, counts, *, ck: int,
                            erf_name: str = "as5", exp_name: str = "exact"):
    """chunked_forward_plain that also returns T (B,5,N,R), zero on rows at
    or past the count."""
    _check_chunks(oc.shape[1], ck)
    return fused_forward_t_plain(oc, sigma, mag, albedo, dirs_t, counts, erf_name=erf_name,
                                 exp_name=exp_name)


def chunked_backward_plain(oc, sigma, mag, albedo, dirs_t, counts, dcol, t_saved=None, *,
                           ck: int, erf_name: str = "as5", exp_name: str = "exact"):
    """The chunked backward kernels' function in tensor ops: (doc, dsigma,
    dmag, dalbedo, ddirs), from t_saved or recomputing T."""
    _check_chunks(oc.shape[1], ck)
    return fused_backward_plain(oc, sigma, mag, albedo, dirs_t, counts, dcol, t_saved,
                                erf_name=erf_name, exp_name=exp_name)


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors (or raise), the plain version for CPU
# ---------------------------------------------------------------------------

def chunked_forward(oc, sigma, mag, albedo, dirs_t, counts, *, ck: int, rb: int = 128,
                    pb: int = 8, qb: int = 32, erf_name: str = "as5",
                    exp_name: str = "exact") -> torch.Tensor:
    """Wrapper of the chunked forward kernel: colors (B,3,R). CUDA tensors
    go to the kernel (which raises for what it does not take), CPU tensors
    to chunked_forward_plain."""
    args = (oc, sigma, mag, albedo, dirs_t, counts)
    _check_chunks(oc.shape[1], ck)
    if not _check_inputs("chunked_forward", _scene_shapes(*args), oc.device):
        return chunked_forward_plain(*args, ck=ck, erf_name=erf_name, exp_name=exp_name)
    return _chunked_forward_launch(CHUNKED_FWD, args, None, rb=rb, pb=pb, qb=qb,
                                   erf_name=erf_name, exp_name=exp_name)


def chunked_forward_t(oc, sigma, mag, albedo, dirs_t, counts, *, ck: int, rb: int = 128,
                      pb: int = 8, qb: int = 32, erf_name: str = "as5",
                      exp_name: str = "exact"):
    """Wrapper of the chunked forward-with-T kernel: (colors (B,3,R),
    T (B,5,N,R)), T zero on rows at or past the count."""
    args = (oc, sigma, mag, albedo, dirs_t, counts)
    _check_chunks(oc.shape[1], ck)
    if not _check_inputs("chunked_forward_t", _scene_shapes(*args), oc.device):
        return chunked_forward_t_plain(*args, ck=ck, erf_name=erf_name, exp_name=exp_name)
    b, n, _ = oc.shape
    t = torch.empty((b, len(K_TAPS), n, dirs_t.shape[2]), dtype=torch.float32,
                    device=oc.device)   # the kernel writes every element
    colors = _chunked_forward_launch(CHUNKED_FWD_T, args, t, rb=rb, pb=pb, qb=qb,
                                     erf_name=erf_name, exp_name=exp_name)
    return colors, t


def chunked_backward(oc, sigma, mag, albedo, dirs_t, counts, dcol, t_saved=None, *,
                     ck: int, rb: int = 128, qb: int = 32, erf_name: str = "as5",
                     exp_name: str = "exact", part_ms: torch.Tensor | None = None):
    """Wrapper of the chunked backward kernels: the VJP for the cotangent
    dcol (B,3,R) → (doc (B,N,3), dsigma (B,N), dmag (B,N), dalbedo (B,N,3),
    ddirs (B,3,R)). With t_saved (B,5,N,R) from chunked_forward_t it
    launches the saved-T kernel, without it the recompute kernel. CPU
    tensors go to chunked_backward_plain. rb caps the rays per block; qb is
    the rows staged per shared-memory pass, the forward's, so that a
    recomputed T is the forward's bit for bit. part_ms: a float32 CPU
    tensor of 4 C + 1 elements (C = N / ck) for the device ms of each
    chunk's pass A (recompute), p side, db sum and q side and of the row
    sums, for measurement."""
    args = (oc, sigma, mag, albedo, dirs_t, counts)
    _check_chunks(oc.shape[1], ck)
    if not _backward_on_card("chunked_backward", _scene_shapes(*args), args, dcol, t_saved):
        return chunked_backward_plain(*args, dcol, t_saved, ck=ck, erf_name=erf_name,
                                      exp_name=exp_name)
    kernel = CHUNKED_BWD if t_saved is None else CHUNKED_BWD_T
    return _chunked_backward_launch(kernel, args, dcol, t_saved, ck=ck, rb=rb, qb=qb,
                                    erf_name=erf_name, exp_name=exp_name, part_ms=part_ms)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def tile_renderer_for(capacity: int, *, geometry=None, erf_name: str = "as5",
                      exp_name: str = "exact", pb: int | None = None,
                      qb: int | None = None, rb: int = 128):
    """Route a per-tile renderer by capacity → (padded_capacity,
    render_fn(tiled_scene, o, tile_dirs, counts)), render_fn
    ops.cuda_render.render_tiles; callers gather and compact at the padded
    capacity. geometry: ops.cuda_render.ISO (None) or ANISO. Up to its
    ceiling of one chunk, read at each call, the kernels render at one
    chunk, at a multiple of lcm(pb, qb); above it at chunk_plan(capacity),
    the JAX package's. pb/qb override the block sizes on both routes (the
    JAX package drops them on its chunked anisotropic route)."""
    from sgrt_tpu_torch.ops import cuda_render

    geometry = cuda_render.ISO if geometry is None else geometry
    ck = None
    if capacity > geometry.ceiling():
        cap, ck = chunk_plan(capacity)
    else:
        dpb, dqb = _block_sizes(capacity)
        pb = dpb if pb is None else pb
        qb = dqb if qb is None else qb
        align = math.lcm(pb, qb)
        cap = max(align, -(-capacity // align) * align)

    def render_fn(tiled, o, d, counts):
        return cuda_render.render_tiles(tiled, o, d, counts, ck=ck, rb=rb, pb=pb, qb=qb,
                                        erf_name=erf_name, exp_name=exp_name)

    return cap, render_fn
