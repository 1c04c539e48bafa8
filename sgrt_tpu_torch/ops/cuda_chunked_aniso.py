"""The chunked anisotropic kernels' wrappers and plain versions (PyTorch
port of the kernels of sgrt_tpu.ops.pallas_chunked_aniso).

The fused anisotropic op's function (ops.cuda_aniso) with the Gaussian axis
cut into C = N / ck chunks of ck rows, for per-tile capacities above
MAX_BWD_CAPACITY_ANISO; exact for the reason ops.cuda_chunked gives (the
transmittance exponent is additive over Gaussians). Four kernels of
csrc/chunked.cu (the isotropic chunked route's templates over anisotropic
rows), each with a wrapper that launches it for tensors on the card (or
raises) and runs its plain version for tensors on the CPU:

    chunked_forward_aniso    colors         (_chunked_fwd_aniso_kernel)
    chunked_forward_t_aniso  colors and T   (the saved-T schedule's forward)
    chunked_backward_aniso   the VJP, from saved T (the saved-T schedule of
                             _chunked_bwd_aniso_kernel) or recomputing it
                             (_chunked_bwd_aniso_kernel)

The JAX package recomputes T at chunked scale only because a TPU holds no
multi-GB residual (pallas_chunked_aniso.py:19-22); the card does, so the
route saves T when its 20*B*N*R bytes fit SAVE_T_CHUNKED_MAX_BYTES, by the
chunked rule of ops.cuda_render.render_batched (the one op, over
ops.cuda_render.ANISO's chunked wrappers), and recomputes it above.
csrc/chunked.cu's note gives the kernels' design: warp-wide groups of 4
rows sharing each stage's per-ray terms through shared-memory planes, the
backward's p-side/q-side split, and the recompute backward as the
forward-with-T per chunk ahead of the saved-T backward's kernels.

The plain versions are the fused anisotropic ones behind the chunk-count
contract. The JAX package's packed (B, 16, N) operand is TPU lane padding;
the kernels take the fused anisotropic kernels' unpacked operands, and
invd = scale^-2 is formed by the caller so that autograd gives d scale.
"""

from __future__ import annotations

import torch

from sgrt_tpu_torch.ops.cuda_aniso import (
    _aniso_shapes,
    fused_backward_aniso_plain,
    fused_forward_aniso_plain,
    fused_forward_t_aniso_plain,
)
from sgrt_tpu_torch.ops.cuda_chunked import _check_chunks
from sgrt_tpu_torch.ops.cuda_kernel import (
    K_TAPS,
    CudaKernel,
    _backward_on_card,
    _check_inputs,
    _chunked_backward_launch,
    _chunked_forward_launch,
)

_SRC, _TPU = "chunked.cu", "sgrt_tpu/ops/pallas_chunked_aniso.py"
CHUNKED_FWD_ANISO = CudaKernel("chunked_fwd_aniso", _SRC, "sgrt_chunked_fwd_aniso",
                               f"{_TPU}:78", 8, 8)
CHUNKED_FWD_T_ANISO = CudaKernel("chunked_fwd_t_aniso", _SRC, "sgrt_chunked_fwd_t_aniso",
                                 f"{_TPU}:78", 9, 8)
CHUNKED_BWD_ANISO = CudaKernel("chunked_bwd_aniso", _SRC, "sgrt_chunked_bwd_aniso",
                               f"{_TPU}:199", 14, 8, timed=True)
CHUNKED_BWD_T_ANISO = CudaKernel("chunked_bwd_t_aniso", _SRC, "sgrt_chunked_bwd_t_aniso",
                                 f"{_TPU}:199", 15, 8, timed=True)


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


def chunked_forward_t_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, *, ck: int,
                                  erf_name: str = "as5", exp_name: str = "exact"):
    """chunked_forward_aniso_plain that also returns T (B,5,N,R), zero on
    rows at or past the count."""
    _check_chunks(oc.shape[1], ck)
    return fused_forward_t_aniso_plain(oc, invd, mag, albedo, dirs_t, counts,
                                       erf_name=erf_name, exp_name=exp_name)


def chunked_backward_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, dcol, t_saved=None, *,
                                 ck: int, erf_name: str = "as5", exp_name: str = "exact"):
    """The chunked anisotropic backward kernels' function in tensor ops:
    (doc, dinvd, dmag, dalbedo, ddirs), from t_saved or recomputing T."""
    _check_chunks(oc.shape[1], ck)
    return fused_backward_aniso_plain(oc, invd, mag, albedo, dirs_t, counts, dcol, t_saved,
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
    return _chunked_forward_launch(CHUNKED_FWD_ANISO, args, None, rb=rb, pb=pb, qb=qb,
                                   erf_name=erf_name, exp_name=exp_name)


def chunked_forward_t_aniso(oc, invd, mag, albedo, dirs_t, counts, *, ck: int, rb: int = 128,
                            pb: int = 8, qb: int = 32, erf_name: str = "as5",
                            exp_name: str = "exact"):
    """Wrapper of the chunked anisotropic forward-with-T kernel: (colors
    (B,3,R), T (B,5,N,R)), T zero on rows at or past the count. CPU tensors
    go to chunked_forward_t_aniso_plain."""
    args = (oc, invd, mag, albedo, dirs_t, counts)
    _check_chunks(oc.shape[1], ck)
    if not _check_inputs("chunked_forward_t_aniso", _aniso_shapes(*args), oc.device):
        return chunked_forward_t_aniso_plain(*args, ck=ck, erf_name=erf_name, exp_name=exp_name)
    b, n, _ = oc.shape
    t = torch.empty((b, len(K_TAPS), n, dirs_t.shape[2]), dtype=torch.float32,
                    device=oc.device)   # the kernel writes every element
    colors = _chunked_forward_launch(CHUNKED_FWD_T_ANISO, args, t, rb=rb, pb=pb, qb=qb,
                                     erf_name=erf_name, exp_name=exp_name)
    return colors, t


def chunked_backward_aniso(oc, invd, mag, albedo, dirs_t, counts, dcol, t_saved=None, *,
                           ck: int, rb: int = 128, qb: int = 32, erf_name: str = "as5",
                           exp_name: str = "exact", part_ms: torch.Tensor | None = None):
    """Wrapper of the chunked anisotropic backward kernels: the VJP for the
    cotangent dcol (B,3,R) → (doc (B,N,3), dinvd (B,N,3), dmag (B,N),
    dalbedo (B,N,3), ddirs (B,3,R)). With t_saved (B,5,N,R) from
    chunked_forward_t_aniso it launches the saved-T kernel, without it the
    recompute kernel. CPU tensors go to chunked_backward_aniso_plain. rb
    caps the rays per block; qb is the rows staged per shared-memory pass,
    the forward's, so that a recomputed T is the forward's bit for bit.
    part_ms: a float32 CPU tensor of 4 C + 1 elements (C = N / ck) for the
    device ms of each chunk's pass A (recompute), p side, db sum and q side
    and of the row sums, for measurement."""
    args = (oc, invd, mag, albedo, dirs_t, counts)
    _check_chunks(oc.shape[1], ck)
    if not _backward_on_card("chunked_backward_aniso", _aniso_shapes(*args), args, dcol,
                             t_saved):
        return chunked_backward_aniso_plain(*args, dcol, t_saved, ck=ck, erf_name=erf_name,
                                            exp_name=exp_name)
    kernel = CHUNKED_BWD_ANISO if t_saved is None else CHUNKED_BWD_T_ANISO
    return _chunked_backward_launch(kernel, args, dcol, t_saved, ck=ck, rb=rb, qb=qb,
                                    erf_name=erf_name, exp_name=exp_name, part_ms=part_ms)
