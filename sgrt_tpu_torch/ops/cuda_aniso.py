"""The fused anisotropic renderer and its analytic backward on hand-written
CUDA kernels (PyTorch port of the host side of sgrt_tpu.ops.pallas_aniso).

The isotropic fused op's function (ops.cuda_kernel) over anisotropic rows:
oc = mu - o (B,N,3), invd = scale^-2 (B,N,3), and per (row, ray), with the
ray's direction d (ops.anisotropic holds the math):

    A  = sum_i invd_i d_i^2,  Bt = sum_i oc_i invd_i d_i,  C = sum_i oc_i^2 invd_i
    sb = 1/sqrt(A),  mb = Bt sb^2,  inv = sqrt(A/2)
    co = mag sqrt(pi/2) sb exp(-(C - Bt mb)/2)

after which T, the colors and the pair gradients are the isotropic ones
with sigma_p replaced by sb(p, r). The backward chains the per-(row, ray)
cotangents of mb, co, inv and sb through A, Bt and C to doc, dinvd, dmag,
dalbedo and ddirs; d scale follows from the caller's invd = scale^-2 by
autograd (pallas_aniso.py:18).

Four kernels, each with a wrapper that launches it for tensors on the card
(or raises) and runs its plain version for tensors on the CPU:

    fused_forward_aniso    csrc/chunked.cu  colors         (_fused_fwd_aniso_kernel)
    fused_forward_t_aniso  csrc/chunked.cu  colors and T   (_fused_fwd_t_aniso_kernel)
    fused_backward_aniso   csrc/chunked.cu  the VJP, from saved T (_fused_bwd_t_aniso_kernel)
                                            or recomputing it (_fused_bwd_aniso_kernel)

All four are the chunked anisotropic kernels (ops.cuda_chunked_aniso) at
one chunk, ck = N: a fused kernel is the chunked one with C = 1. The
forward splits a tile's p rows over blocks of 32 rows and 32 rays, the
backward its pair work into a p side and a q side over blocks of 64 rows
and 32 rays, so that a dense tile spreads over many blocks; the
recompute backward's T is the forward-with-T's own. ops.cuda_render's one
op renders through them (ops.cuda_render.ANISO's wrappers at one chunk).

Rounding: C - Bt mb cancels two numbers of size |oc|^2/scale^2, so the
plain versions compute A, Bt and C as elementwise sums in the kernels'
order (no matrix product) and sb as a square root and a division; kernel
and plain version then agree to summation order.
"""

from __future__ import annotations

import torch

from sgrt_tpu_torch.ops.cuda_kernel import (
    K_TAPS,
    CudaKernel,
    _backward_on_card,
    _backward_plain,
    _check_inputs,
    _chunked_backward_launch,
    _chunked_forward_launch,
    _forward_plain,
)
from sgrt_tpu_torch.ops.reference import INV_SQRT_2_PI

# Per-tile capacity above which the JAX package routes anisotropic tiles to
# its chunked kernels (MAX_BWD_CAPACITY_ANISO, a v5e VMEM ceiling of the
# recompute backward). The port's fused kernels have no such wall; both
# packages route alike until the card's own crossover is measured.
MAX_BWD_CAPACITY_ANISO = 6144

_TPU = "sgrt_tpu/ops/pallas_aniso.py"
FUSED_FWD_ANISO = CudaKernel("fused_fwd_aniso", "chunked.cu", "sgrt_fused_fwd_aniso",
                             f"{_TPU}:145", 8, 8)
FUSED_FWD_T_ANISO = CudaKernel("fused_fwd_t_aniso", "chunked.cu", "sgrt_fused_fwd_t_aniso",
                               f"{_TPU}:248", 9, 8)
FUSED_BWD_T_ANISO = CudaKernel("fused_bwd_t_aniso", "chunked.cu", "sgrt_fused_bwd_t_aniso",
                               f"{_TPU}:292", 15, 8, timed=True)
FUSED_BWD_ANISO = CudaKernel("fused_bwd_aniso", "chunked.cu", "sgrt_fused_bwd_aniso",
                             f"{_TPU}:367", 14, 8, timed=True)


def _aniso_shapes(oc, invd, mag, albedo, dirs_t, counts) -> dict:
    b, n, _ = oc.shape
    r = dirs_t.shape[-1]
    return {"oc": (oc, (b, n, 3)), "invd": (invd, (b, n, 3)), "mag": (mag, (b, n)),
            "albedo": (albedo, (b, n, 3)), "dirs_t": (dirs_t, (b, 3, r)),
            "counts": (counts, (b,))}


# ---------------------------------------------------------------------------
# plain versions (tensor ops; on the CPU and beside the kernels in checks)
# ---------------------------------------------------------------------------

def _aniso_terms(o3, invd, mg, d, exp_fn):
    """Anisotropic rows: (mb, co, inv, sb, extra), each (L, nl, R), summed
    and rounded in the kernels' order (csrc/gauss_common.cuh, AnisoGeo)."""
    x, y, z = (o3[..., c:c + 1] for c in range(3))          # (L, nl, 1)
    ix, iy, iz = (invd[..., c:c + 1] for c in range(3))
    dx, dy, dz = d[:, None, 0], d[:, None, 1], d[:, None, 2]   # (L, 1, R)
    a = ix * (dx * dx) + iy * (dy * dy) + iz * (dz * dz)    # (L, nl, R)
    bt = (x * ix) * dx + (y * iy) * dy + (z * iz) * dz
    c = (x * x) * ix + (y * y) * iy + (z * z) * iz          # (L, nl, 1)
    sb = torch.reciprocal(torch.sqrt(a))
    mb = bt * sb * sb
    co = (mg[..., None] * INV_SQRT_2_PI) * sb * exp_fn(-0.5 * (c - bt * mb))
    inv = torch.sqrt(0.5 * a)
    return mb, co, inv, sb, {"invd": invd}


def _aniso_chain(lt, dco, dmb, dinv, dsb):
    """The anisotropic chain (pallas_aniso.py, _aniso_epilogue): plane
    cotangents of mb, co, inv and sb through A, Bt and C → per-row (doc,
    dinvd, dmag) and ddirs."""
    co, mb, inv, sb, o3, d = lt.co, lt.mb, lt.inv, lt.sg, lt.o3, lt.d
    invd = lt.extra["invd"]                                 # (L, nl, 3)
    dcoco = dco * co
    dsb_tot = dsb + dcoco / sb - dinv * inv / sb
    inv_a = sb * sb                                         # 1/A
    dbt = dmb * inv_a + dcoco * mb
    da = -dmb * mb * inv_a - 0.5 * dsb_tot * sb * inv_a - 0.5 * dcoco * mb * mb
    s_row = torch.sum(dcoco, dim=2)                         # (L, nl)
    dc = (-0.5 * s_row)[..., None]
    dm = dbt @ d.transpose(1, 2)                            # (L, nl, 3)
    da_d2 = da @ (d * d).transpose(1, 2)
    dinvd = da_d2 + dc * (o3 * o3) + dm * o3
    doc = dm * invd + 2.0 * dc * o3 * invd
    ddirs = 2.0 * d * (invd.transpose(1, 2) @ da) + (o3 * invd).transpose(1, 2) @ dbt
    # guard only mag == 0 (inert rows): a negative magnitude from
    # unconstrained fitting keeps the true-signed d mag = sum(dco co)/mag
    mg = lt.mg
    dmag = s_row / torch.where(mg == 0, torch.ones_like(mg), mg)
    return doc, dinvd, dmag, ddirs


def fused_forward_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, *,
                              erf_name: str = "as5", exp_name: str = "exact",
                              max_block_elems: int = 1 << 24) -> torch.Tensor:
    """The anisotropic forward kernel's function in tensor ops: oc, invd
    (B,N,3), mag (B,N), albedo (B,N,3), dirs_t (B,3,R), counts (B,) →
    colors (B,3,R). Rows at or past min(count, N) are inert dummies (invd
    1, magnitude 0); as fused_forward_plain, only live tiles and rows are
    computed and the q axis is blocked. Differentiable by autograd."""
    return _forward_plain(oc, invd, mag, albedo, dirs_t, counts, erf_name, exp_name,
                          max_block_elems, False, _aniso_terms)[0]


def fused_forward_t_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, *,
                                erf_name: str = "as5", exp_name: str = "exact",
                                max_block_elems: int = 1 << 24):
    """fused_forward_aniso_plain that also returns T (B,5,N,R), zero on rows
    at or past the count."""
    return _forward_plain(oc, invd, mag, albedo, dirs_t, counts, erf_name, exp_name,
                          max_block_elems, True, _aniso_terms)


def fused_backward_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, dcol, t_saved=None, *,
                               erf_name: str = "as5", exp_name: str = "exact",
                               max_block_elems: int = 1 << 24):
    """The anisotropic backward kernels' function in tensor ops: the
    analytic VJP for the cotangent dcol (B,3,R), from t_saved (B,5,N,R) or
    recomputing T → (doc (B,N,3), dinvd (B,N,3), dmag (B,N), dalbedo
    (B,N,3), ddirs (B,3,R)); rows at or past the count get exactly zero."""
    return _backward_plain(oc, invd, mag, albedo, dirs_t, counts, dcol, t_saved, erf_name,
                           exp_name, max_block_elems, _aniso_terms, _aniso_chain)


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors (or raise), the plain version for CPU
# ---------------------------------------------------------------------------

def fused_forward_aniso(oc, invd, mag, albedo, dirs_t, counts, *, rb: int = 128,
                        pb: int = 8, qb: int = 32, erf_name: str = "as5",
                        exp_name: str = "exact") -> torch.Tensor:
    """Wrapper of the anisotropic forward kernel: colors (B,3,R). CUDA
    tensors go to the kernel (which raises for what it does not take), CPU
    tensors to fused_forward_aniso_plain. Any N: the kernel is the chunked
    forward at one chunk of N rows (blocks of 32 rays, rb capped at it; pb
    is checked, though the kernel keeps 4 rows a thread)."""
    args = (oc, invd, mag, albedo, dirs_t, counts)
    if not _check_inputs("fused_forward_aniso", _aniso_shapes(*args), oc.device):
        return fused_forward_aniso_plain(*args, erf_name=erf_name, exp_name=exp_name)
    return _chunked_forward_launch(FUSED_FWD_ANISO, args, None, rb=rb, pb=pb, qb=qb,
                           erf_name=erf_name, exp_name=exp_name)


def fused_forward_t_aniso(oc, invd, mag, albedo, dirs_t, counts, *, rb: int = 128,
                          pb: int = 8, qb: int = 32, erf_name: str = "as5",
                          exp_name: str = "exact"):
    """Wrapper of the anisotropic forward-with-T kernel: (colors (B,3,R),
    T (B,5,N,R)), T zero on rows at or past the count; the colors equal
    fused_forward_aniso's bit for bit, and T is what the recompute backward
    recomputes at the same qb."""
    args = (oc, invd, mag, albedo, dirs_t, counts)
    if not _check_inputs("fused_forward_t_aniso", _aniso_shapes(*args), oc.device):
        return fused_forward_t_aniso_plain(*args, erf_name=erf_name, exp_name=exp_name)
    b, n, _ = oc.shape
    t = torch.empty((b, len(K_TAPS), n, dirs_t.shape[2]), dtype=torch.float32,
                    device=oc.device)   # the kernel writes every element
    colors = _chunked_forward_launch(FUSED_FWD_T_ANISO, args, t, rb=rb, pb=pb, qb=qb,
                             erf_name=erf_name, exp_name=exp_name)
    return colors, t


def fused_backward_aniso(oc, invd, mag, albedo, dirs_t, counts, dcol, t_saved=None, *,
                         rb: int = 128, qb: int = 32, erf_name: str = "as5",
                         exp_name: str = "exact", part_ms: torch.Tensor | None = None):
    """Wrapper of the anisotropic backward kernels: the VJP for the
    cotangent dcol (B,3,R) → (doc, dinvd, dmag, dalbedo, ddirs). With
    t_saved (B,5,N,R) from fused_forward_t_aniso it launches the saved-T
    kernel, without it the recompute kernel, whose recomputed T is
    fused_forward_t_aniso's bit for bit at the same qb. CPU tensors go to
    fused_backward_aniso_plain. Any N: the kernels run the chunked backward
    at one chunk of N rows (blocks of 32 rays, rb capped at it). part_ms: a
    float32 CPU tensor of 5 elements for the device ms of the recompute's T,
    the p side, the db sum, the q side and the row sums, for measurement."""
    args = (oc, invd, mag, albedo, dirs_t, counts)
    if not _backward_on_card("fused_backward_aniso", _aniso_shapes(*args), args, dcol, t_saved):
        return fused_backward_aniso_plain(*args, dcol, t_saved, erf_name=erf_name,
                                          exp_name=exp_name)
    kernel = FUSED_BWD_ANISO if t_saved is None else FUSED_BWD_T_ANISO
    return _chunked_backward_launch(kernel, args, dcol, t_saved, ck=oc.shape[1], rb=rb, qb=qb,
                                    erf_name=erf_name, exp_name=exp_name, part_ms=part_ms)
