"""The fused renderer and its analytic backward on hand-written CUDA kernels
(PyTorch port of sgrt_tpu.ops.pallas_kernel's fused op).

Definitions (see ops.reference for the math contract; rows past a tile's
count are inert dummies, sigma=1 and magnitude=0):

    mu_bar(q,r)  = (mu_q - o) . n_r
    coeff(q,r)   = sigma_q * sqrt(pi/2) * cbar(q,r)
    inv(q)       = 1 / (sqrt(2) sigma_q)
    acc_k(p,r)   = sum_q coeff(q,r) * erf((mu_bar(p,r) + k*sigma_p - mu_bar(q,r)) * inv(q))
    base(r)      = sum_q coeff(q,r) * erf(-mu_bar(q,r) * inv(q))
    T_k(p,r)     = w_k * exp(base(r) - acc_k(p,r)),  w_k = exp(-k^2/2)
    colors(r,:)  = sum_p [sigma_p * cbar(p,r) * sum_k T_k(p,r)] * albedo_p

Four kernels, each with a wrapper that launches it for tensors on the card
(or raises) and runs its plain version, the same math in tensor ops, for
tensors on the CPU:

    fused_forward     csrc/chunked.cu  colors           (_fused_fwd_kernel)
    fused_forward_t   csrc/chunked.cu  colors and T     (_fused_fwd_t_kernel)
    fused_backward    csrc/chunked.cu  the VJP, from saved T (_fused_bwd_t_kernel)
                                       or recomputing it (_fused_bwd_kernel)

All four are the chunked kernels (ops.cuda_chunked) at one chunk, ck = N:
a fused kernel is the chunked one with C = 1. The forward splits a tile's
p rows over blocks of 32 rows and 32 rays, the backward its pair work into
a p side and a q side over blocks of 64 rows and 32 rays, so that a dense
tile spreads over many blocks; the recompute backward's T is the
forward-with-T's own. _chunked_forward_launch launches every forward entry
point of csrc/chunked.cu, fused or chunked, of either row geometry, and
_chunked_backward_launch every backward entry point there.

ops.cuda_render joins them into one differentiable op, as the JAX
package's custom VJP does (ops.cuda_render.ISO's wrappers at one chunk).

The plain versions are written over a row geometry (the terms mb, co, inv
and sb per (row, ray), and the chain back to the raw inputs), so that
ops.cuda_aniso runs the same pass A and pass B over anisotropic rows, as
the kernels share gauss_common.cuh's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from sgrt_tpu_torch.ops.approx import ERF_AND_GAUSS_IMPLS, ERF_IMPLS, EXP_IMPLS, kernel_tables
from sgrt_tpu_torch.ops.reference import INV_SQRT_2_PI
from sgrt_tpu_torch.utils import nvcc

K_TAPS = (-4.0, -3.0, -2.0, -1.0, 0.0)
K_WEIGHTS = tuple(math.exp(-k * k / 2.0) for k in K_TAPS)
_SQRT_2_PI = 0.7978845608028654   # sigma*cbar = coeff * sqrt(2/pi)
_INV_SQRT_2 = 0.7071067811865476
_DERF = 1.1283791670955126        # 2/sqrt(pi)

# erf/exp names the CUDA kernels are compiled for (template arguments,
# csrc/gauss_common.cuh): every name of ERF_IMPLS ("exact" runs as5 there,
# _kernel_erf_name) and of EXP_IMPLS.
KERNEL_ERFS = {"as5": 0, "as3": 1, "taylor": 2, "spline": 3, "spline_mirror": 4}
KERNEL_EXPS = {"exact": 0, "fast": 1, "spline": 2}
KERNEL_PBS = (8, 16)

# Byte budget of the saved-T residual, 20*B*N*R logical bytes (five
# float32 factors per row and ray; the card has no lane padding to count).
# Up to it the differentiated forward writes T and the backward reads it;
# above it the backward recomputes pass A. On an H100 (80 GB, 700 W) at the
# north-star train step (256^2, 32x16 tiles, N = 480; chip_smoke.py,
# "train_step") the saved-T step takes 13.4 ms against 17.5 ms recomputing,
# for 0.63 GB of T (peak 0.82 GB either way: the recompute backward holds
# the same T in scratch): saving always pays, so the budget is set by
# memory alone. 8 GiB is a tenth of the card's 80 GB; a step holds T of
# every launch at once. The saved-T backward's own scratch is O(B N)
# (csrc/chunked.cu at one chunk); the recompute backward holds the T of its
# one chunk in scratch instead.
SAVE_T_MAX_BYTES = 8 << 30


def _kernel_erf_name(name: str) -> str:
    """"exact" → "as5" inside kernels: the A&S 5-term polynomial is the
    float32-exact erf, so callers use one erf_name on every route."""
    return "as5" if name == "exact" else name


def kernel_ids(erf_name: str, exp_name: str, pb: int | None = None) -> list[int]:
    """The kernels' template ids of an erf and an exp name (checked, with
    pb if given)."""
    _check_names(erf_name, exp_name, pb)
    return [KERNEL_ERFS[_kernel_erf_name(erf_name)], KERNEL_EXPS[exp_name]]


def _block_sizes(n: int) -> tuple[int, int]:
    """(pb, qb) from the Gaussian-axis extent, as in the JAX package, so
    both pad tile capacities alike. pb is the p block that N is a multiple
    of (the kernels keep 4 rows a thread whatever it is), qb the q rows
    staged per shared-memory pass."""
    if n <= 256:
        return 8, 16
    return 8, 32


def save_t_bytes(b: int, n: int, r: int) -> int:
    """Logical bytes of the saved-T residual T (B,5,N,R) float32."""
    return 4 * len(K_TAPS) * b * n * r


class CudaKernel:
    """One hand-written kernel: an entry point of a library built from a
    csrc/ source on first launch, the TPU kernel it replaces, and the count
    of its launches (raised by one per launch, nowhere else)."""

    route = "cuda"

    def __init__(self, name: str, source: str, symbol: str, replaces: str,
                 n_ptr: int, n_int: int, timed: bool = False):
        self.name = name
        self.source = nvcc.CSRC_DIR / source
        self.symbol = symbol
        self.replaces = replaces
        self.launches = 0
        self.timed = timed  # takes a host buffer for its launches' device ms
        self._argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        self._lib = None
        self._tables_on = set()   # devices whose approximation table it filled

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = nvcc.load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            lib.sgrt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sgrt_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def query(self, symbol: str) -> int:
        """An int-returning constant of the library (a block size)."""
        fn = getattr(self.library(), symbol)
        fn.restype = ctypes.c_int
        return fn()

    def _fill_tables(self, dev: torch.device) -> None:
        """Fill the library's approximation table on the current device
        (sgrt_set_approx_tables: the taylor terms and spline fits of
        ops.approx) before this kernel's first launch there."""
        if dev.index in self._tables_on:
            return
        lib, tab = self.library(), kernel_tables()
        fn = lib.sgrt_set_approx_tables
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        err = fn(tab.ctypes.data, tab.size)
        if err != 0:
            raise RuntimeError("filling the kernels' approximation table failed: "
                               f"{lib.sgrt_cuda_error_string(err).decode()}")
        self._tables_on.add(dev.index)

    def launch(self, tensors, ints, *, what: str) -> None:
        """Call the entry point with the tensors' pointers (None: a null
        pointer), the ints and the current stream; raise with the CUDA error
        if the launch failed."""
        lib = self.library()
        dev = tensors[0].device
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            self._fill_tables(dev)
            err = getattr(lib, self.symbol)(*(0 if t is None else t.data_ptr() for t in tensors),
                                            *ints, stream)
        if err != 0:
            msg = lib.sgrt_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} launch failed ({what}): {msg}")
        self.launches += 1


_SRC, _TPU = "chunked.cu", "sgrt_tpu/ops/pallas_kernel.py"
FUSED_FWD = CudaKernel("fused_fwd", _SRC, "sgrt_fused_fwd", f"{_TPU}:862", 8, 8)
FUSED_FWD_T = CudaKernel("fused_fwd_t", _SRC, "sgrt_fused_fwd_t", f"{_TPU}:898", 9, 8)
FUSED_BWD_T = CudaKernel("fused_bwd_t", _SRC, "sgrt_fused_bwd_t", f"{_TPU}:948", 15, 8,
                         timed=True)
FUSED_BWD = CudaKernel("fused_bwd", _SRC, "sgrt_fused_bwd", f"{_TPU}:1073", 14, 8, timed=True)


def as5_tap_probe(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The as5 tap of every kernel (csrc/gauss_common.cuh,
    erf_and_gauss<kErfAs5>) at the float32 points x, a 1-D tensor on the
    card: (e, g), then (e, g) of the tap's IEEE form (an IEEE division and
    the accurate expf) beside them, for the tap's accuracy check
    (sgrt_as5_tap_probe in csrc/chunked.cu; no renderer path calls it)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 1 or x.numel() < 1:
        raise ValueError("as5_tap_probe takes a non-empty 1-D float32 tensor on the card")
    x = x.contiguous()
    out = torch.empty((4, x.numel()), dtype=torch.float32, device=x.device)
    lib = FUSED_FWD.library()
    fn = lib.sgrt_as5_tap_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"as5_tap_probe failed: {lib.sgrt_cuda_error_string(err).decode()}")
    return tuple(out)


def _check_names(erf_name: str, exp_name: str, pb: int | None = None) -> None:
    if erf_name not in ERF_IMPLS or exp_name not in EXP_IMPLS:
        raise ValueError(
            f"the CUDA kernels implement erf {sorted(ERF_IMPLS)} and exp "
            f"{sorted(EXP_IMPLS)}; got erf={erf_name!r}, exp={exp_name!r}")
    if pb is not None and pb not in KERNEL_PBS:
        raise ValueError(f"the CUDA kernel takes pb in {KERNEL_PBS}, got {pb}")


def _threads(max_threads: int, rb: int, r: int) -> int:
    """Threads (rays) per block: at most rb and the kernel's maximum, a
    multiple of 32."""
    t = min(max_threads, rb, -(-r // 32) * 32)
    return max(32, t - t % 32)


def _check_inputs(who: str, want: dict, dev: torch.device) -> bool:
    """Shapes, dtypes and one device for every input; True if they are on
    the card (then also contiguous), False if on the CPU."""
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the first input on {dev}")
        dtype = torch.int32 if name == "counts" else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{who} runs on CUDA or CPU tensors, not {dev}")
    for name, (t, _) in want.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


def _scene_shapes(oc, sigma, mag, albedo, dirs_t, counts) -> dict:
    b, n, _ = oc.shape
    r = dirs_t.shape[-1]
    return {"oc": (oc, (b, n, 3)), "sigma": (sigma, (b, n)), "mag": (mag, (b, n)),
            "albedo": (albedo, (b, n, 3)), "dirs_t": (dirs_t, (b, 3, r)),
            "counts": (counts, (b,))}


# ---------------------------------------------------------------------------
# plain versions (tensor ops; on the CPU and beside the kernels in checks)
# ---------------------------------------------------------------------------

# the plain forward's sums over rows: blocks of _ROWS rows, summed
# pairwise, _SUPER rows (a power-of-two number of blocks) at a time. Both
# fixed, so that a tile's sums do not depend on the other tiles of a call.
_ROWS, _SUPER = 16, 128


@dataclasses.dataclass
class _LiveTiles:
    """The tiles with a live row, cut to the rows up to the largest count
    rounded up to a multiple of _ROWS (at most N), rows past each count
    replaced by inert dummies, and the per-(row, ray)
    terms of the row geometry (the kernels' prep). inv and sb are (L, nl, 1)
    for isotropic rows and (L, nl, R) for anisotropic ones."""

    live: torch.Tensor       # (L,) tile indices
    nl: int                  # rows kept
    row_live: torch.Tensor   # (L, nl) bool
    o3: torch.Tensor         # (L, nl, 3)
    shape: torch.Tensor      # (L, nl) sigma, or (L, nl, 3) invd
    mg: torch.Tensor         # (L, nl) magnitude
    alb: torch.Tensor        # (L, nl, 3)
    d: torch.Tensor          # (L, 3, R)
    mb: torch.Tensor         # (L, nl, R)
    co: torch.Tensor         # (L, nl, R)
    inv: torch.Tensor        # 1/(sqrt2 sb)
    sg: torch.Tensor         # sb: sigma along the ray
    extra: dict              # the geometry's own terms, for its chain


def _iso_terms(o3, sig, mg, d, exp_fn):
    """Isotropic rows: (mb, co, inv, sb, extra). mb and |oc|^2 as explicit
    sums in a fixed order, as the kernels round them: the exponent of co
    cancels |oc|^2 against mb^2 (see csrc/gauss_common.cuh,
    gauss_exponent_rn)."""
    x, y, z = (o3[..., c:c + 1] for c in range(3))         # (L, nl, 1)
    mb = x * d[:, None, 0] + y * d[:, None, 1] + z * d[:, None, 2]   # (L, nl, R)
    ocsq = x * x + y * y + z * z                            # (L, nl, 1)
    sg = sig[..., None]
    inv2s2 = 1.0 / (2.0 * sg * sg)
    inv = _INV_SQRT_2 / sg                                  # (L, nl, 1)
    co = (mg[..., None] * sg * INV_SQRT_2_PI) * exp_fn(-(ocsq - mb * mb) * inv2s2)
    return mb, co, inv, sg, {"ocsq": ocsq, "inv2s2": inv2s2}


def _live_tiles(oc, shape, mag, albedo, dirs_t, counts, exp_fn, terms) -> _LiveTiles | None:
    """Reads the counts on the host; None if no tile has a live row. shape
    is sigma (B,N) or invd (B,N,3); dead rows get shape 1, magnitude 0."""
    n = oc.shape[1]
    cnt = torch.clamp(counts.to(torch.int64), 0, n)
    live = torch.nonzero(cnt > 0).reshape(-1)
    if live.numel() == 0:
        return None
    nl = min(-(-int(cnt.max()) // _ROWS) * _ROWS, n)
    row_live = torch.arange(nl, device=oc.device)[None, :] < cnt[live][:, None]
    rl = row_live[..., None]
    shp = shape[live, :nl]
    shp = torch.where(row_live if shp.dim() == 2 else rl, shp, torch.ones_like(shp))
    mg = torch.where(row_live, mag[live, :nl], torch.zeros_like(mag[live, :nl]))
    o3 = torch.where(rl, oc[live, :nl], torch.zeros_like(oc[live, :nl]))
    alb = torch.where(rl, albedo[live, :nl], torch.zeros_like(albedo[live, :nl]))
    d = dirs_t[live]
    mb, co, inv, sg, extra = terms(o3, shp, mg, d, exp_fn)
    return _LiveTiles(live, nl, row_live, o3, shp, mg, alb, d, mb, co, inv, sg, extra)


def _q_block(lt: _LiveTiles, max_block_elems: int) -> int:
    """q rows per block so that (L, nl, Qb, R) temporaries hold at most
    max_block_elems."""
    return max(1, min(lt.nl, max_block_elems // (lt.live.numel() * lt.nl * lt.mb.shape[2])))


def termwise(exp_name: str) -> bool:
    """Whether T's exponent base - acc_k is summed term by term, as
    sum_q co_q (erf(-mb_q inv_q) - erf(arg_qk)), rather than as the
    difference of the two sums: under the spline exp, whose fit jumps by
    3.5e-4 at 0 where the exponent of the rows in front of a ray's
    Gaussians lies; each term has its erf difference's sign, so the sum has
    the exact one and the kernels (csrc/chunked.cu, kTermwise) and the
    plain versions land on the same side of the jump."""
    return exp_name == "spline"


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over axis `dim` (>= 0) in blocks of _ROWS rows (zero-padded to
    a multiple), then the blocks pairwise, adjacent pairs level by level. A
    further block of zeros leaves the bits of the result as they are."""
    def zeros(t, n):
        return t.new_zeros(t.shape[:dim] + (n,) + t.shape[dim + 1:])

    if x.shape[dim] % _ROWS:
        x = torch.cat([x, zeros(x, -x.shape[dim] % _ROWS)], dim)
    x = x.unflatten(dim, (-1, _ROWS)).sum(dim + 1)
    while x.shape[dim] > 1:
        if x.shape[dim] % 2:
            x = torch.cat([x, zeros(x, 1)], dim)
        pairs = x.unflatten(dim, (-1, 2))
        x = pairs.select(dim + 1, 0) + pairs.select(dim + 1, 1)
    return x.squeeze(dim)


def _pairwise_push(stack: list, level_sums) -> None:
    """Add one superblock's sums to a pairwise (binary-counter) sum: equal
    levels merge, the older partial on the left."""
    level = 0
    while stack and stack[-1][0] == level:
        level_sums = [a + b for a, b in zip(stack.pop()[1], level_sums)]
        level += 1
    stack.append((level, level_sums))


def _pairwise_total(stack: list) -> list:
    """The sums of a pairwise sum: its partials folded older + (newer). A
    further superblock of zeros leaves the bits as they are."""
    total = stack.pop()[1]
    while stack:
        total = [a + b for a, b in zip(stack.pop()[1], total)]
    return total


def _transmittance_chunk(mb, co, inv, sg, row_live, erf_fn, exp_fn, by_term: bool) -> list:
    """_transmittance over one chunk of tiles."""
    eb = erf_fn(-mb * inv)                                  # (L, nl, R)
    stack = []
    for q0 in range(0, mb.shape[1], _SUPER):
        mb_q = mb[:, None, q0:q0 + _SUPER, :]               # (L, 1, Qs, R)
        co_q = co[:, None, q0:q0 + _SUPER, :]
        inv_q = inv[:, None, q0:q0 + _SUPER, :]             # (L, 1, Qs, 1 or R)
        eb_q = eb[:, None, q0:q0 + _SUPER, :]
        darg = (mb[:, :, None, :] - mb_q) * inv_q           # (L, nl, Qs, R)
        ks = sg[:, :, None, :] * inv_q                      # (L, nl, Qs, 1 or R)
        sums = [_tree_sum(co_q * (eb_q - e if by_term else e), 2)
                for e in (erf_fn(darg + k * ks) for k in K_TAPS)]
        if not by_term:
            sums.append(_tree_sum(co_q * eb_q, 2))          # base: (L, 1, R)
        _pairwise_push(stack, sums)
    accs = _pairwise_total(stack)
    base = 0.0 if by_term else accs.pop()
    rl = row_live[..., None]
    return [torch.where(rl, w * exp_fn(acc if by_term else base - acc), torch.zeros_like(acc))
            for w, acc in zip(K_WEIGHTS, accs)]


def _transmittance(lt: _LiveTiles, erf_fn, exp_fn, max_block_elems: int,
                   by_term: bool = False) -> list:
    """The five T_k (L, nl, R) of pass A, zero on dead rows; by_term sums
    the exponent term by term (termwise). The q rows enter base and acc_k
    in blocks of _ROWS, summed pairwise, _SUPER rows at a time, and the
    tiles go in chunks so that the (chunk, nl, _SUPER, R) temporaries hold
    at most max_block_elems. A tile's T so depends on its own rows alone,
    not on the other tiles of the call nor on the largest count among them
    (dead rows add blocks of exact zeros): a tile renders bit for bit alike
    alone and batched with other frames' tiles."""
    lc = max(1, max_block_elems // (lt.nl * min(lt.nl, _SUPER) * lt.mb.shape[2]))
    parts = [_transmittance_chunk(*(t[l0:l0 + lc] for t in (lt.mb, lt.co, lt.inv, lt.sg,
                                                              lt.row_live)),
                                  erf_fn, exp_fn, by_term)
             for l0 in range(0, lt.live.numel(), lc)]
    return [torch.cat(ts) for ts in zip(*parts)]


def _colors(lt: _LiveTiles, T) -> torch.Tensor:
    """(L, 3, R) colors, summed over rows as _transmittance sums them."""
    w_p = _SQRT_2_PI * lt.co * sum(T)                       # (L, nl, R)
    stack = []
    for q0 in range(0, lt.nl, _SUPER):
        q = slice(q0, q0 + _SUPER)
        _pairwise_push(stack, [_tree_sum(lt.alb[:, q, :, None] * w_p[:, q, None, :], 1)])
    return _pairwise_total(stack)[0]


def _forward_plain(oc, shape, mag, albedo, dirs_t, counts, erf_name, exp_name,
                   max_block_elems, want_t, terms=_iso_terms):
    erf_fn, exp_fn = ERF_IMPLS[erf_name], EXP_IMPLS[exp_name]
    b, n, _ = oc.shape
    r = dirs_t.shape[2]
    colors = dirs_t.new_zeros((b, 3, r))
    t = dirs_t.new_zeros((b, len(K_TAPS), n, r)) if want_t else None
    lt = _live_tiles(oc, shape, mag, albedo, dirs_t, counts, exp_fn, terms)
    if lt is None:
        return colors, t
    T = _transmittance(lt, erf_fn, exp_fn, max_block_elems, termwise(exp_name))
    colors = colors.index_copy(0, lt.live, _colors(lt, T))
    if want_t:
        t_live = dirs_t.new_zeros((lt.live.numel(), len(K_TAPS), n, r))
        t_live[:, :, :lt.nl] = torch.stack(T, dim=1)
        t = t.index_copy(0, lt.live, t_live)
    return colors, t


def fused_forward_plain(oc, sigma, mag, albedo, dirs_t, counts, *,
                        erf_name: str = "as5", exp_name: str = "exact",
                        max_block_elems: int = 1 << 24) -> torch.Tensor:
    """The forward kernel's function in tensor ops: oc (B,N,3), sigma/mag
    (B,N), albedo (B,N,3), dirs_t (B,3,R), counts (B,) → colors (B,3,R).

    Rows at or past min(count, N) are replaced by inert dummies, so they
    never act as live whatever they hold. Only tiles with a live row and
    the rows up to the largest count (rounded up to a multiple of _ROWS) are
    computed (this reads the counts on the host). Rows are summed in blocks
    of _ROWS and tiles go in chunks, so that no (B, N, N, R) array is made
    (the pairwise temporaries hold at most `max_block_elems`) and a tile's
    colors do not depend on the other tiles of the call. Differentiable by
    autograd.
    """
    return _forward_plain(oc, sigma, mag, albedo, dirs_t, counts, erf_name, exp_name,
                          max_block_elems, False)[0]


def fused_forward_t_plain(oc, sigma, mag, albedo, dirs_t, counts, *,
                          erf_name: str = "as5", exp_name: str = "exact",
                          max_block_elems: int = 1 << 24):
    """fused_forward_plain that also returns T (B,5,N,R), the five
    transmittance factors w_k exp(base - acc_k) per row and ray; rows at or
    past the count hold T = 0."""
    return _forward_plain(oc, sigma, mag, albedo, dirs_t, counts, erf_name, exp_name,
                          max_block_elems, True)


def _iso_chain(lt: _LiveTiles, dco, dmb, dinv, dsb):
    """The isotropic prep chain (pallas_kernel.py's _fused_prep_epilogue):
    plane cotangents → per-row (doc, dsigma, dmag) and ddirs."""
    co, mb, inv, sg = lt.co, lt.mb, lt.inv, lt.sg
    inv2s2, ocsq = lt.extra["inv2s2"], lt.extra["ocsq"]
    dcoco = dco * co
    dmb = dmb + dcoco * (2.0 * inv2s2) * mb
    s_row = torch.sum(dcoco, dim=2, keepdim=True)           # (L, nl, 1)
    docsq = s_row * (-inv2s2)
    s_qmb = torch.sum(dcoco * (ocsq - mb * mb), dim=2, keepdim=True)
    dsig_l = (torch.sum(dsb, dim=2, keepdim=True)
              + torch.sum(dinv, dim=2, keepdim=True) * (-inv / sg)
              + s_row / sg + s_qmb / (sg * sg * sg))[..., 0]
    # guard only mag == 0 (inert rows): a negative magnitude keeps the sign
    # of d mag = sum(dco*co)/mag
    mg = lt.mg
    dmag_l = mg * s_row[..., 0] / torch.where(mg == 0, torch.ones_like(mg), mg * mg)
    doc_l = dmb @ lt.d.transpose(1, 2) + 2.0 * lt.o3 * docsq   # (L, nl, 3)
    ddirs_l = lt.o3.transpose(1, 2) @ dmb                   # (L, 3, R)
    return doc_l, dsig_l, dmag_l, ddirs_l


def _backward_plain(oc, shape, mag, albedo, dirs_t, counts, dcol, t_saved, erf_name,
                    exp_name, max_block_elems, terms, chain):
    """The fused VJP in tensor ops over a row geometry: pass B and the base
    path in the JAX package's order (_grad_pass with its S0/S1 folding,
    _base_path_grads), then the geometry's chain. Returns (doc, dshape,
    dmag, dalbedo, ddirs); rows at or past the count get exactly zero."""
    erf_fn, exp_fn = ERF_IMPLS[erf_name], EXP_IMPLS[exp_name]
    eag = ERF_AND_GAUSS_IMPLS.get(erf_name, ERF_AND_GAUSS_IMPLS["as5"])
    doc, dshape, dmag = torch.zeros_like(oc), torch.zeros_like(shape), torch.zeros_like(mag)
    dalb, ddirs = torch.zeros_like(albedo), torch.zeros_like(dirs_t)
    lt = _live_tiles(oc, shape, mag, albedo, dirs_t, counts, exp_fn, terms)
    if lt is None:
        return doc, dshape, dmag, dalb, ddirs
    mb, co, inv, sg, nl = lt.mb, lt.co, lt.inv, lt.sg, lt.nl
    rl = lt.row_live[..., None]
    if t_saved is None:
        T = _transmittance(lt, erf_fn, exp_fn, max_block_elems, termwise(exp_name))
    else:
        T = [torch.where(rl, t, torch.zeros_like(t))
             for t in t_saved[lt.live, :, :nl].unbind(1)]
    dcl = dcol[lt.live]                                     # (L, 3, R)
    A = lt.alb @ dcl                                        # (L, nl, R)
    g = _SQRT_2_PI * co * A
    tw = sum(T)
    db = torch.sum(g * tw, dim=1)                           # (L, R)
    G = [g * t for t in T]
    dco = _SQRT_2_PI * tw * A
    dalb_l = (_SQRT_2_PI * co * tw) @ dcl.transpose(1, 2)   # (L, nl, 3)

    # pass B, q-blocked: q-side sums into dco/dmb/dinv, p-side into dmb/dsb
    dmb, dinv, dsb = torch.zeros_like(mb), torch.zeros_like(mb), torch.zeros_like(mb)
    sg4 = sg[:, :, None, :]                                 # (L, nl, 1, 1 or R)
    qb = _q_block(lt, max_block_elems)
    for q0 in range(0, nl, qb):
        q = slice(q0, q0 + qb)
        mb_q = mb[:, None, q, :]                            # (L, 1, Qb, R)
        co_q = co[:, None, q, :]
        inv_q = inv[:, None, q, :]                          # (L, 1, Qb, 1 or R)
        dd = mb[:, :, None, :] - mb_q                       # (L, nl, Qb, R)
        dco_blk = torch.zeros_like(mb_q[:, 0])
        t0 = t1 = 0.0
        for k, gk in zip(K_TAPS, G):
            ee, gau = eag((dd + k * sg4) * inv_q)
            gk4 = gk[:, :, None, :]
            dco_blk = dco_blk - torch.sum(gk4 * ee, dim=1)
            gg = gk4 * gau
            t0 = t0 + gg
            t1 = t1 + k * gg
        s0 = (-_DERF) * co_q * t0
        s1 = (-_DERF) * co_q * t1
        di = s0 * inv_q
        dmb = dmb + torch.sum(di, dim=2)
        dsb = dsb + torch.sum(s1 * inv_q, dim=2)
        dco[:, q] += dco_blk
        dmb[:, q] -= torch.sum(di, dim=1)
        dinv[:, q] += torch.sum(s0 * dd + s1 * sg4, dim=1)

    # base path: db = sum_p g*tw is the cotangent of base
    e1, g1 = eag(-mb * inv)
    dco = dco + db[:, None, :] * e1
    derf1 = _DERF * db[:, None, :] * co * g1
    dmb = dmb + derf1 * (-inv)
    dinv = dinv + derf1 * (-mb)

    doc_l, dshape_l, dmag_l, ddirs_l = chain(lt, dco, dmb, dinv, dsb)
    zero = torch.zeros((), dtype=oc.dtype, device=oc.device)
    live = lt.live
    doc[live, :nl] = torch.where(rl, doc_l, zero)
    dshape[live, :nl] = torch.where(rl if dshape_l.dim() == 3 else lt.row_live, dshape_l, zero)
    dmag[live, :nl] = torch.where(lt.row_live, dmag_l, zero)
    dalb[live, :nl] = torch.where(rl, dalb_l, zero)
    ddirs[live] = ddirs_l
    return doc, dshape, dmag, dalb, ddirs


def fused_backward_plain(oc, sigma, mag, albedo, dirs_t, counts, dcol, t_saved=None, *,
                         erf_name: str = "as5", exp_name: str = "exact",
                         max_block_elems: int = 1 << 24):
    """The backward kernels' function in tensor ops: the analytic VJP of
    the fused forward for the cotangent dcol (B,3,R), written out in the
    JAX package's order (pallas_kernel.py: _grad_pass with its S0/S1
    folding, _base_path_grads, _fused_prep_epilogue with the mag == 0
    guard). With t_saved (B,5,N,R) it reads T as the saved-T kernel does;
    without, it recomputes pass A. Returns (doc (B,N,3), dsigma (B,N),
    dmag (B,N), dalbedo (B,N,3), ddirs (B,3,R)); rows at or past the count
    get exactly zero.

    erf' is 2/sqrt(pi) exp(-x^2) from the erf's (erf, gauss) pair, as in
    the kernels; an erf with no pair takes as5's, as the JAX package does.
    """
    return _backward_plain(oc, sigma, mag, albedo, dirs_t, counts, dcol, t_saved, erf_name,
                           exp_name, max_block_elems, _iso_terms, _iso_chain)


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors (or raise), the plain version for CPU
# ---------------------------------------------------------------------------

def _chunked_forward_launch(kernel, args, t, *, rb, pb, qb, erf_name, exp_name):
    """Launch a forward entry point of csrc/chunked.cu on checked CUDA
    inputs: colors (B,3,R), and T into t. A block is 32 rays (rb is capped
    at it); pb must be one the fused kernels take, though the kernel keeps
    4 rows a thread whatever it is."""
    ids = kernel_ids(erf_name, exp_name, pb)
    oc, dirs_t = args[0], args[4]
    b, n, _ = oc.shape
    r = dirs_t.shape[2]
    threads = _threads(kernel.query("sgrt_chunked_max_threads"), rb, r)
    n_split = -(-n // kernel.query("sgrt_chunked_fwd_rows_per_block"))
    colors = torch.empty((b, 3, r), dtype=torch.float32, device=oc.device)
    partial = torch.empty((b, n_split, 3, r), dtype=torch.float32, device=oc.device)
    outs = [partial, colors] + ([t] if t is not None else [])
    kernel.launch(list(args) + outs,
                  [b, n, r, threads, pb, qb, *ids],
                  what=f"B={b}, N={n}, R={r}, threads={threads}, pb={pb}, qb={qb}")
    return colors


def fused_forward(oc, sigma, mag, albedo, dirs_t, counts, *, rb: int = 128,
                  pb: int = 8, qb: int = 32, erf_name: str = "as5",
                  exp_name: str = "exact") -> torch.Tensor:
    """Wrapper of the fused forward kernel: colors (B,3,R).

    Checks shapes, dtypes, devices and contiguity. CUDA tensors go to the
    kernel (which raises for what it does not take); CPU tensors go to
    fused_forward_plain. Any N: the kernel is the chunked forward at one
    chunk of N rows (blocks of 32 rays, rb capped at it; pb is checked,
    though the kernel keeps 4 rows a thread)."""
    args = (oc, sigma, mag, albedo, dirs_t, counts)
    if not _check_inputs("fused_forward", _scene_shapes(*args), oc.device):
        return fused_forward_plain(*args, erf_name=erf_name, exp_name=exp_name)
    return _chunked_forward_launch(FUSED_FWD, args, None, rb=rb, pb=pb, qb=qb,
                                   erf_name=erf_name, exp_name=exp_name)


def fused_forward_t(oc, sigma, mag, albedo, dirs_t, counts, *, rb: int = 128,
                    pb: int = 8, qb: int = 32, erf_name: str = "as5",
                    exp_name: str = "exact"):
    """Wrapper of the forward-with-T kernel: (colors (B,3,R), T (B,5,N,R)),
    T zero on rows at or past the count; the colors equal fused_forward's
    bit for bit, and T is what the recompute backward recomputes at the
    same qb. CUDA tensors go to the kernel, CPU tensors to
    fused_forward_t_plain."""
    args = (oc, sigma, mag, albedo, dirs_t, counts)
    if not _check_inputs("fused_forward_t", _scene_shapes(*args), oc.device):
        return fused_forward_t_plain(*args, erf_name=erf_name, exp_name=exp_name)
    b, n, _ = oc.shape
    t = torch.empty((b, len(K_TAPS), n, dirs_t.shape[2]), dtype=torch.float32,
                    device=oc.device)   # the kernel writes every element
    colors = _chunked_forward_launch(FUSED_FWD_T, args, t, rb=rb, pb=pb, qb=qb,
                                     erf_name=erf_name, exp_name=exp_name)
    return colors, t


def _backward_on_card(who: str, want: dict, args, dcol, t_saved) -> bool:
    """_check_inputs of a backward: the scene's shapes `want` with the
    cotangent dcol (B,3,R) and, if given, t_saved (B,5,N,R)."""
    oc, dirs_t = args[0], args[4]
    b, n, _ = oc.shape
    r = dirs_t.shape[-1]
    want["dcol"] = (dcol, (b, 3, r))
    if t_saved is not None:
        want["t_saved"] = (t_saved, (b, len(K_TAPS), n, r))
    return _check_inputs(who, want, oc.device)


def chunked_backward_scratch_floats(b: int, n: int, r: int, ck: int, threads: int,
                                    recompute: bool, kernel: CudaKernel) -> int:
    """Floats of scratch one launch of a backward kernel of csrc/chunked.cu
    takes (the library's own count; csrc/chunked.cu lists its parts)."""
    fn = kernel.library().sgrt_chunked_bwd_scratch_floats
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return int(fn(b, n, r, ck, threads, int(recompute)))


def _chunked_backward_launch(kernel, args, dcol, t_saved, *, ck, rb, qb, erf_name, exp_name,
                             part_ms=None):
    """Launch a backward entry point of csrc/chunked.cu (a chunked one, or
    a fused one at ck = N) on checked CUDA inputs: outputs (doc, dshape,
    dmag, dalb, ddirs), dshape shaped as args[1] (sigma or invd). A kernel
    that times its parts (kernel.timed) takes part_ms, a float32 CPU tensor
    that receives the device ms of each of its launches (its entry point's
    note lists them; the call then waits for the card), or None."""
    if part_ms is not None and not kernel.timed:
        raise ValueError(f"{kernel.name} does not time its parts")
    ids = kernel_ids(erf_name, exp_name)
    oc, shape, dirs_t = args[0], args[1], args[4]
    b, n, _ = oc.shape
    r = dirs_t.shape[-1]
    threads = _threads(kernel.query("sgrt_chunked_max_threads"), rb, r)
    f32 = dict(dtype=torch.float32, device=oc.device)
    scratch = torch.empty(chunked_backward_scratch_floats(b, n, r, ck, threads,
                                                          t_saved is None, kernel), **f32)
    doc, dalb = torch.empty((b, n, 3), **f32), torch.empty((b, n, 3), **f32)
    dshape, dmag = torch.empty(tuple(shape.shape), **f32), torch.empty((b, n), **f32)
    ddirs = torch.empty((b, 3, r), **f32)
    ins = list(args) + [dcol] + ([] if t_saved is None else [t_saved])
    outs = [scratch, doc, dshape, dmag, dalb, ddirs] + ([part_ms] if kernel.timed else [])
    kernel.launch(ins + outs,
                  [b, n, r, ck, threads, qb, *ids],
                  what=f"B={b}, N={n}, R={r}, ck={ck}, threads={threads}, qb={qb}")
    return doc, dshape, dmag, dalb, ddirs


def fused_backward(oc, sigma, mag, albedo, dirs_t, counts, dcol, t_saved=None, *,
                   rb: int = 128, qb: int = 32, erf_name: str = "as5",
                   exp_name: str = "exact", part_ms: torch.Tensor | None = None):
    """Wrapper of the backward kernels: the VJP of the fused forward for
    the cotangent dcol (B,3,R) → (doc (B,N,3), dsigma (B,N), dmag (B,N),
    dalbedo (B,N,3), ddirs (B,3,R)).

    With t_saved (B,5,N,R) from fused_forward_t it launches the saved-T
    kernel, without it the recompute kernel, whose recomputed T is
    fused_forward_t's bit for bit at the same qb. CPU tensors go to
    fused_backward_plain. Any N: the kernels run the chunked backward at one
    chunk of N rows (blocks of 32 rays, rb capped at it); qb is the rows
    staged per shared-memory pass, the forward's. part_ms: a float32 CPU
    tensor of 5 elements for the device ms of the recompute's T, the p side,
    the db sum, the q side and the row sums, for measurement."""
    args = (oc, sigma, mag, albedo, dirs_t, counts)
    if not _backward_on_card("fused_backward", _scene_shapes(*args), args, dcol, t_saved):
        return fused_backward_plain(*args, dcol, t_saved, erf_name=erf_name, exp_name=exp_name)
    kernel = FUSED_BWD if t_saved is None else FUSED_BWD_T
    return _chunked_backward_launch(kernel, args, dcol, t_saved, ck=oc.shape[1], rb=rb, qb=qb,
                                    erf_name=erf_name, exp_name=exp_name, part_ms=part_ms)
