"""The fused forward renderer on a hand-written CUDA kernel (PyTorch port of
sgrt_tpu.ops.pallas_kernel, forward only).

Definitions (see ops.reference for the math contract; rows past a tile's
count are inert dummies, sigma=1 and magnitude=0):

    mu_bar(q,r)  = (mu_q - o) . n_r
    coeff(q,r)   = sigma_q * sqrt(pi/2) * cbar(q,r)
    inv(q)       = 1 / (sqrt(2) sigma_q)
    acc_k(p,r)   = sum_q coeff(q,r) * erf((mu_bar(p,r) + k*sigma_p - mu_bar(q,r)) * inv(q))
    base(r)      = sum_q coeff(q,r) * erf(-mu_bar(q,r) * inv(q))
    tw(p,r)      = sum_k w_k * exp(base(r) - acc_k(p,r)),  w_k = exp(-k^2/2)
    colors(r,:)  = sum_p [sigma_p * cbar(p,r) * tw(p,r)] * albedo_p

`fused_forward` is the kernel's wrapper: for tensors on the card it
launches csrc/fused_fwd.cu (the port of the TPU kernel _fused_fwd_kernel)
or raises; for tensors on the CPU it runs `fused_forward_plain`, the same
math in tensor ops. The kernel has no backward yet, so it refuses inputs
that require grad; the plain version is differentiable by autograd.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sgrt_tpu_torch.models.gaussians import GaussianScene, pad_scene
from sgrt_tpu_torch.ops.approx import ERF_IMPLS, EXP_IMPLS
from sgrt_tpu_torch.ops.reference import INV_SQRT_2_PI
from sgrt_tpu_torch.ops.render import _unit_pad
from sgrt_tpu_torch.utils import nvcc

K_TAPS = (-4.0, -3.0, -2.0, -1.0, 0.0)
K_WEIGHTS = tuple(math.exp(-k * k / 2.0) for k in K_TAPS)
_SQRT_2_PI = 0.7978845608028654   # sigma*cbar = coeff * sqrt(2/pi)
_INV_SQRT_2 = 0.7071067811865476

# erf/exp names the CUDA kernel is compiled for (template arguments).
KERNEL_ERFS = {"as5": 0, "as3": 1}
KERNEL_EXPS = {"exact": 0, "fast": 1}
KERNEL_PBS = (8, 16)


def _kernel_erf_name(name: str) -> str:
    """"exact" → "as5" inside kernels: the A&S 5-term polynomial is the
    float32-exact erf, so callers use one erf_name on every route."""
    return "as5" if name == "exact" else name


def _block_sizes(n: int) -> tuple[int, int]:
    """(pb, qb) from the Gaussian-axis extent, as in the JAX package, so
    both pad tile capacities alike. pb is the number of p rows a CUDA
    thread keeps in registers, qb the q rows staged per shared-memory
    pass."""
    if n <= 256:
        return 8, 16
    return 8, 32


class FusedForwardKernel:
    """csrc/fused_fwd.cu, built on first launch, with its launch count."""

    name = "fused_fwd"
    route = "cuda"
    source = nvcc.CSRC_DIR / "fused_fwd.cu"
    replaces = "sgrt_tpu/ops/pallas_kernel.py:862"

    def __init__(self):
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = nvcc.load(self.source)
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.sgrt_fused_fwd.argtypes = [ptr] * 8 + [i] * 8 + [ptr]
            lib.sgrt_fused_fwd.restype = i
            lib.sgrt_fused_fwd_rows_per_block.restype = i
            lib.sgrt_fused_fwd_max_threads.restype = i
            lib.sgrt_cuda_error_string.argtypes = [i]
            lib.sgrt_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, oc, sigma, mag, albedo, dirs_t, counts, *, rb: int,
               pb: int, qb: int, erf_name: str, exp_name: str) -> torch.Tensor:
        """colors (B,3,R) from CUDA tensors already checked by
        fused_forward."""
        if erf_name not in KERNEL_ERFS or exp_name not in KERNEL_EXPS:
            raise ValueError(
                f"the CUDA kernel implements erf {sorted(KERNEL_ERFS)} and exp "
                f"{sorted(KERNEL_EXPS)}; got erf={erf_name!r}, exp={exp_name!r}")
        if pb not in KERNEL_PBS:
            raise ValueError(f"the CUDA kernel takes pb in {KERNEL_PBS}, got {pb}")
        lib = self.library()
        b, n, _ = oc.shape
        r = dirs_t.shape[2]
        threads = min(lib.sgrt_fused_fwd_max_threads(), rb, -(-r // 32) * 32)
        threads = max(32, threads - threads % 32)
        n_split = -(-n // lib.sgrt_fused_fwd_rows_per_block())
        colors = torch.empty((b, 3, r), dtype=torch.float32, device=oc.device)
        partial = torch.empty((b, n_split, 3, r), dtype=torch.float32,
                              device=oc.device)
        stream = torch.cuda.current_stream(oc.device).cuda_stream
        with torch.cuda.device(oc.device):
            err = lib.sgrt_fused_fwd(
                oc.data_ptr(), sigma.data_ptr(), mag.data_ptr(), albedo.data_ptr(),
                dirs_t.data_ptr(), counts.data_ptr(), partial.data_ptr(),
                colors.data_ptr(), b, n, r, threads, pb, qb,
                KERNEL_ERFS[erf_name], KERNEL_EXPS[exp_name], stream)
        if err != 0:
            msg = lib.sgrt_cuda_error_string(err).decode()
            raise RuntimeError(f"fused_fwd launch failed (B={b}, N={n}, R={r}, "
                               f"threads={threads}, pb={pb}, qb={qb}): {msg}")
        self.launches += 1
        return colors


FUSED_FWD = FusedForwardKernel()


def fused_forward_plain(oc, sigma, mag, albedo, dirs_t, counts, *,
                        erf_name: str = "as5", exp_name: str = "exact",
                        max_block_elems: int = 1 << 24) -> torch.Tensor:
    """The kernel's function in tensor ops: oc (B,N,3), sigma/mag (B,N),
    albedo (B,N,3), dirs_t (B,3,R), counts (B,) → colors (B,3,R).

    Rows at or past min(count, N) are replaced by inert dummies, so they
    never act as live whatever they hold. Only tiles with a live row and
    the rows up to the largest count are computed (this reads the counts on
    the host), and the q axis is blocked so that no (B, N, N, R) array
    is made: the pairwise temporaries hold at most `max_block_elems`.
    """
    erf_fn, exp_fn = ERF_IMPLS[erf_name], EXP_IMPLS[exp_name]
    b, n, _ = oc.shape
    r = dirs_t.shape[2]
    cnt = torch.clamp(counts.to(torch.int64), 0, n)
    out = dirs_t.new_zeros((b, 3, r))
    live = torch.nonzero(cnt > 0).reshape(-1)
    if live.numel() == 0:
        return out
    nl = int(cnt.max())
    cnt = cnt[live]
    row_live = torch.arange(nl, device=oc.device)[None, :] < cnt[:, None]
    sig = torch.where(row_live, sigma[live, :nl], torch.ones_like(row_live, dtype=oc.dtype))
    mg = torch.where(row_live, mag[live, :nl], torch.zeros_like(sig))
    o3 = torch.where(row_live[..., None], oc[live, :nl], torch.zeros_like(oc[live, :nl]))
    alb = torch.where(row_live[..., None], albedo[live, :nl],
                      torch.zeros_like(albedo[live, :nl]))
    d = dirs_t[live]

    # mb and |oc|^2 as explicit sums in a fixed order, as the kernel rounds
    # them: the exponent of co cancels |oc|^2 against mb^2 (see
    # csrc/fused_fwd.cu, gauss_exponent_rn)
    x, y, z = (o3[..., c:c + 1] for c in range(3))         # (L, nl, 1)
    mb = x * d[:, None, 0] + y * d[:, None, 1] + z * d[:, None, 2]   # (L, nl, R)
    ocsq = x * x + y * y + z * z                            # (L, nl, 1)
    sg = sig[..., None]
    inv2s2 = 1.0 / (2.0 * sg * sg)
    inv = _INV_SQRT_2 / sg                                  # (L, nl, 1)
    co = (mg[..., None] * sg * INV_SQRT_2_PI) * exp_fn(-(ocsq - mb * mb) * inv2s2)
    base = torch.sum(co * erf_fn(-mb * inv), dim=1)         # (L, R)

    nlive = live.numel()
    qb = max(1, min(nl, max_block_elems // (nlive * nl * r)))
    accs = [torch.zeros_like(mb) for _ in K_TAPS]
    for q0 in range(0, nl, qb):
        mb_q = mb[:, None, q0:q0 + qb, :]                   # (L, 1, Qb, R)
        co_q = co[:, None, q0:q0 + qb, :]
        inv_q = inv[:, None, q0:q0 + qb, :]                 # (L, 1, Qb, 1)
        darg = (mb[:, :, None, :] - mb_q) * inv_q           # (L, nl, Qb, R)
        ks = sg[:, :, None, :] * inv_q                      # (L, nl, Qb, 1)
        accs = [acc + torch.sum(co_q * erf_fn(darg + k * ks), dim=2)
                for acc, k in zip(accs, K_TAPS)]
    tw = sum(w * exp_fn(base[:, None, :] - acc) for w, acc in zip(K_WEIGHTS, accs))
    w_p = _SQRT_2_PI * co * tw                              # (L, nl, R)
    colors = alb.transpose(1, 2) @ w_p                      # (L, 3, R)
    return out.index_copy(0, live, colors)


def fused_forward(oc, sigma, mag, albedo, dirs_t, counts, *, rb: int = 128,
                  pb: int = 8, qb: int = 32, erf_name: str = "as5",
                  exp_name: str = "exact") -> torch.Tensor:
    """Wrapper of the fused forward kernel: colors (B,3,R).

    Checks shapes, dtypes, devices and contiguity. CUDA tensors go to the
    kernel (which raises for what it does not take); CPU tensors go to
    fused_forward_plain."""
    b, n, three = oc.shape
    r = dirs_t.shape[-1]
    want = {"oc": (oc, (b, n, 3)), "sigma": (sigma, (b, n)), "mag": (mag, (b, n)),
            "albedo": (albedo, (b, n, 3)), "dirs_t": (dirs_t, (b, 3, r)),
            "counts": (counts, (b,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != oc.device:
            raise ValueError(f"{name} is on {t.device}, oc on {oc.device}")
        dtype = torch.int32 if name == "counts" else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if oc.device.type == "cpu":
        return fused_forward_plain(oc, sigma, mag, albedo, dirs_t, counts,
                                   erf_name=erf_name, exp_name=exp_name)
    if oc.device.type != "cuda":
        raise ValueError(f"fused_forward runs on CUDA or CPU tensors, not {oc.device}")
    for name, (t, _) in want.items():
        if t.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: the backward kernels are not yet ported "
                "to CUDA (render on the CPU for gradients)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return FUSED_FWD.launch(oc, sigma, mag, albedo, dirs_t, counts, rb=rb,
                            pb=pb, qb=qb, erf_name=erf_name, exp_name=exp_name)


def render_fused(scene_oc, sigma, mag, albedo, dirs_t, counts=None, *,
                 rb: int = 128, pb: int = 16, qb: int = 32,
                 erf_name: str = "as5", exp_name: str = "exact"):
    """Fully fused batched render: oc (B,N,3), sigma/mag (B,N), albedo
    (B,N,3), dirs_t (B,3,R), counts (B,) → colors (B,3,R). Block sizes
    follow the JAX package's rules (rb | R, pb | N, qb | N, multiples of
    8); counts default to N and are clamped to N."""
    erf_name = _kernel_erf_name(erf_name)
    b, n, _ = scene_oc.shape
    r = dirs_t.shape[2]
    rb, pb, qb = min(rb, r), min(pb, n), min(qb, n)
    if r % rb or n % pb or n % qb or pb % 8 or qb % 8:
        raise ValueError(f"shape (R={r}, N={n}) not divisible by blocks "
                         f"(rb={rb}, pb={pb}, qb={qb})")
    if counts is None:
        counts = torch.full((b,), n, dtype=torch.int32, device=scene_oc.device)
    counts = torch.clamp(counts.to(torch.int32), max=n)
    return fused_forward(scene_oc, sigma, mag, albedo, dirs_t, counts, rb=rb,
                         pb=pb, qb=qb, erf_name=erf_name, exp_name=exp_name)


def render_tiles_fused(tiled_scene: GaussianScene, o, tile_dirs, counts=None,
                       *, rb: int = 128, pb: int | None = None,
                       qb: int | None = None, erf_name: str = "as5",
                       exp_name: str = "exact") -> torch.Tensor:
    """Batched per-tile render: tiled_scene fields (T2, K, ...), tile_dirs
    (T2, P, 3), counts (T2,) live Gaussians per tile → per-tile colors
    (T2, P, 3). o is one (3,) origin or a per-tile (T2, 3) batch."""
    k = tiled_scene.mu.shape[1]
    dpb, dqb = _block_sizes(k)
    pb = dpb if pb is None else pb
    qb = dqb if qb is None else qb
    o_b = o[None, None, :] if o.dim() == 1 else o[:, None, :]
    oc = (tiled_scene.mu - o_b).contiguous()                 # (T2, K, 3)
    dirs_t = tile_dirs.transpose(1, 2).contiguous()           # (T2, 3, P)
    colors_t = render_fused(
        oc, tiled_scene.sigma.contiguous(), tiled_scene.magnitude.contiguous(),
        tiled_scene.albedo.contiguous(), dirs_t, counts, rb=rb, pb=pb, qb=qb,
        erf_name=erf_name, exp_name=exp_name)                 # (T2, 3, P)
    return colors_t.transpose(1, 2)


def render_rays_fused_impl(o, dirs, scene: GaussianScene, *, rb: int = 128,
                           pb: int | None = None, qb: int | None = None,
                           erf_name: str = "as5",
                           exp_name: str = "exact") -> torch.Tensor:
    """Render a flat ray batch through the kernel as one tile:
    dirs (R,3) → colors (R,3). Rays are padded to a multiple of rb with a
    unit direction (see ops.render._unit_pad)."""
    n_live = scene.n
    if pb is None or qb is None:
        dpb, dqb = _block_sizes(n_live)
        pb = dpb if pb is None else pb
        qb = dqb if qb is None else qb
    scene = pad_scene(scene, max(pb, qb))
    r = dirs.shape[0]
    rb = min(rb, r)
    dirs_p = _unit_pad(dirs, (-r) % rb)
    counts = torch.full((1,), n_live, dtype=torch.int32, device=dirs.device)
    oc = (scene.mu - o[None, :]).contiguous()
    colors_t = render_fused(
        oc[None], scene.sigma[None].contiguous(), scene.magnitude[None].contiguous(),
        scene.albedo[None].contiguous(), dirs_p.T[None].contiguous(), counts,
        rb=rb, pb=pb, qb=qb, erf_name=erf_name, exp_name=exp_name)[0]  # (3, R)
    return colors_t.T[:r]
