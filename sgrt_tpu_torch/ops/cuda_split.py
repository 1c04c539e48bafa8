"""The split kernels: transmittance weights and colors from precomputed
Gaussian-major (B, N, R) planes, with their VJPs, on hand-written CUDA
kernels (PyTorch port of the split half of sgrt_tpu.ops.pallas_kernel:
tw_pallas, colors_pallas and _prep_terms_T).

Inputs are mb = (mu - o) . d and co = sigma sqrt(pi/2) cbar per (row, ray),
sigma and inv = 1/(sqrt2 sigma) per row, and counts (B,) bounding each
tile's live prefix, count = min(counts, N):

    base(r)    = sum over ALL N rows q of co(q,r) erf(-mb(q,r) inv_q)
    acc_k(p,r) = sum_{q < count} co(q,r) erf((mb(p,r) + k sigma_p - mb(q,r)) inv_q)
    tw(p,r)    = sum_k w_k exp(base(r) - acc_k(p,r))   for p < count, 0 past it
    colors(:,r)= sum_{p < count} albedo_p sqrt(2/pi) co(p,r) tw(p,r)

base runs over every row, as the Pallas kernels compute it
(pallas_kernel.py:201, 239): a row past the count with non-zero co still
shifts the live rows' tw, and the VJP gives it dco = db erf(-mb inv) and
the matching dmb and dinv. The Pallas kernels leave tw of rows past the
count to the block that holds them (computed inside the p block that
straddles the count, 0 in whole blocks past it), and their q loops run
over whole q blocks, so rows past the count inside the straddling q block
enter acc_k. The port bounds both by the count: tw is 0 past it, acc_k
sums q < count, and g past the count is ignored (tw there is a constant).
The two agree whenever counts are multiples of pb and qb, or rows past the
count are inert (co = 0), as tiling makes them.

Four kernels (csrc/split.cu), each with a wrapper that launches it for
tensors on the card (or raises) and runs its plain version for tensors on
the CPU:

    split_forward          tw              (_fwd_kernel)
    split_backward         dmb, dco, dsigma, dinv from dtw       (_bwd_kernel)
    split_forward_color    colors          (_fwd_color_kernel)
    split_backward_color   ... and dalbedo from dcolors          (_bwd_color_kernel)

TwSplit and ColorsSplit join them into differentiable ops, tw_split and
colors_split the counterparts of tw_pallas and colors_pallas, with their
signatures, defaults and block rules. prep_terms_t makes the planes from a
scene and rays, and render_tiles_split renders gathered tiles through them.

The plain backwards take autograd of the plain forward's pair and base
terms, q block by q block, with erf's derivative 2/sqrt(pi) exp(-x^2) and
T's derivative T itself (the kernels' convention: exp_fast and the A&S
polynomials are not differentiated as written). So they check the kernels'
S0/S1 folding of the five taps by an independent derivation.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from sgrt_tpu_torch.models.gaussians import GaussianScene
from sgrt_tpu_torch.ops.approx import ERF_AND_GAUSS_IMPLS, ERF_IMPLS, EXP_IMPLS
from sgrt_tpu_torch.ops.cuda_kernel import (
    _DERF,
    _SQRT_2_PI,
    K_TAPS,
    K_WEIGHTS,
    KERNEL_ERFS,
    KERNEL_EXPS,
    CudaKernel,
    _block_sizes,
    _check_inputs,
    _check_names,
    _kernel_erf_name,
    _threads,
)
from sgrt_tpu_torch.ops.reference import INV_SQRT_2_PI, SQRT_2

_SRC, _TPU = "split.cu", "sgrt_tpu/ops/pallas_kernel.py"
SPLIT_FWD = CudaKernel("split_fwd", _SRC, "sgrt_split_fwd", f"{_TPU}:181", 6, 8)
SPLIT_BWD = CudaKernel("split_bwd", _SRC, "sgrt_split_bwd", f"{_TPU}:256", 11, 7)
SPLIT_FWD_COLOR = CudaKernel("split_fwd_color", _SRC, "sgrt_split_fwd_color",
                             f"{_TPU}:213", 8, 8)
SPLIT_BWD_COLOR = CudaKernel("split_bwd_color", _SRC, "sgrt_split_bwd_color",
                             f"{_TPU}:329", 13, 7)


# ---------------------------------------------------------------------------
# plain versions (tensor ops; on the CPU and beside the kernels in checks)
# ---------------------------------------------------------------------------

class _Erf(torch.autograd.Function):
    """erf_name's erf whose derivative is 2/sqrt(pi) exp(-x^2), taken from
    its (erf, gauss) pair or as5's, as the kernels take it."""

    @staticmethod
    def forward(ctx, x, erf_name):
        ctx.erf_name = erf_name
        ctx.save_for_backward(x)
        return ERF_IMPLS[erf_name](x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        eag = ERF_AND_GAUSS_IMPLS.get(ctx.erf_name, ERF_AND_GAUSS_IMPLS["as5"])
        return grad * _DERF * eag(x)[1], None


def _acc_terms(mb_p, sg_p, mb_q, co_q, inv_q, live_q, erf_fn):
    """acc_k's terms of the p rows mb_p (B,P,R), sg_p (B,P) against the q
    rows mb_q, co_q (B,Q,R), inv_q (B,Q), those with live_q (B,Q) false
    masked out: five (B,P,R) sums over the q rows."""
    zero = torch.zeros((), dtype=mb_q.dtype, device=mb_q.device)
    mb_q = torch.where(live_q[..., None], mb_q, zero)[:, None]          # (B, 1, Q, R)
    co_q = torch.where(live_q[..., None], co_q, zero)[:, None]
    inv_q = torch.where(live_q, inv_q, zero + 1)[:, None, :, None]      # (B, 1, Q, 1)
    darg = (mb_p[:, :, None, :] - mb_q) * inv_q                         # (B, P, Q, R)
    ks = sg_p[:, :, None, None] * inv_q                                 # (B, P, Q, 1)
    return [torch.sum(co_q * erf_fn(darg + k * ks), dim=2) for k in K_TAPS]


def _q_block(b: int, nl: int, r: int, max_block_elems: int) -> int:
    """q rows per block so that (B, nl, Qb, R) temporaries hold at most
    max_block_elems."""
    return max(1, min(nl, max_block_elems // max(1, b * nl * r)))


@torch.no_grad()
def _pass_a(mb, co, sigma, inv, counts, erf_name, exp_name, max_block_elems):
    """Pass A without autograd: (T, five (B,nl,R) factors w_k exp(base -
    acc_k), zero past the count; live (B,nl)), nl the largest count. Reads
    the counts on the host."""
    erf_fn, exp_fn = ERF_IMPLS[erf_name], EXP_IMPLS[exp_name]
    b, n, r = mb.shape
    cnt = torch.clamp(counts.to(torch.int64), 0, n)
    nl = int(cnt.max()) if b else 0
    live = torch.arange(nl, device=mb.device)[None, :] < cnt[:, None]
    base = torch.sum(co * erf_fn(-mb * inv[..., None]), dim=1)          # (B, R), every row
    accs = [mb.new_zeros((b, nl, r)) for _ in K_TAPS]
    qb = _q_block(b, nl, r, max_block_elems)
    for q0 in range(0, nl, qb):
        q = slice(q0, min(q0 + qb, nl))
        blk = _acc_terms(mb[:, :nl], sigma[:, :nl], mb[:, q], co[:, q], inv[:, q], live[:, q],
                         erf_fn)
        accs = [a + x for a, x in zip(accs, blk)]
    rl = live[..., None]
    T = [torch.where(rl, w * exp_fn(base[:, None, :] - acc), torch.zeros_like(acc))
         for w, acc in zip(K_WEIGHTS, accs)]
    return T, live


def split_forward_plain(mb, co, sigma, inv, counts, *, erf_name: str = "as5",
                        exp_name: str = "exact", max_block_elems: int = 1 << 24):
    """The tw kernel's function in tensor ops: mb, co (B,N,R), sigma, inv
    (B,N), counts (B,) → tw (B,N,R), zero on rows at or past the count.
    Only the rows up to the largest count are computed, and the q axis is
    blocked so that the pairwise temporaries hold at most
    `max_block_elems`."""
    T, live = _pass_a(mb, co, sigma, inv, counts, erf_name, exp_name, max_block_elems)
    tw = torch.zeros_like(mb)
    tw[:, :live.shape[1]] = sum(T)
    return tw


def split_forward_color_plain(mb, co, sigma, inv, albedo, counts, *, erf_name: str = "as5",
                              exp_name: str = "exact", max_block_elems: int = 1 << 24):
    """The colors kernel's function: colors (B,3,R) = sum over the live
    rows p of albedo_p sqrt(2/pi) co(p,r) tw(p,r)."""
    tw = split_forward_plain(mb, co, sigma, inv, counts, erf_name=erf_name,
                             exp_name=exp_name, max_block_elems=max_block_elems)
    with torch.no_grad():
        return albedo.transpose(1, 2) @ (_SQRT_2_PI * co * tw)


def _tw_vjp(mb, co, sigma, inv, T, live, g, erf_name, max_block_elems):
    """(dmb, dco, dsigma, dinv) of tw for its cotangent g (B,N,R), given
    pass A's T and live rows: d tw / d base = tw and d tw / d acc_k = -T_k,
    then autograd of base over every row and of acc_k's terms q block by q
    block. g past the count is ignored."""
    b, n, r = mb.shape
    nl = live.shape[1]
    k_erf = lambda x: _Erf.apply(x, erf_name)  # noqa: E731
    g = torch.where(live[..., None], g[:, :nl], torch.zeros_like(g[:, :nl]))
    neg_g = [-g * t for t in T]
    db = torch.sum(g * sum(T), dim=1)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (mb, co, inv)]
        base = torch.sum(leaves[1] * k_erf(-leaves[0] * leaves[2][..., None]), dim=1)
        dmb, dco, dinv = torch.autograd.grad(base, leaves, db)
    dsig = torch.zeros_like(sigma)
    qb = _q_block(b, nl, r, max_block_elems)
    for q0 in range(0, nl, qb):
        q = slice(q0, min(q0 + qb, nl))
        with torch.enable_grad():
            parts = [x.detach().requires_grad_(True) for x in
                     (mb[:, :nl], sigma[:, :nl], mb[:, q], co[:, q], inv[:, q])]
            blk = _acc_terms(*parts, live[:, q], k_erf)
            d_mbp, d_sgp, d_mbq, d_coq, d_invq = torch.autograd.grad(blk, parts, neg_g)
        dmb[:, :nl] += d_mbp
        dsig[:, :nl] += d_sgp
        dmb[:, q] += d_mbq
        dco[:, q] += d_coq
        dinv[:, q] += d_invq
    return dmb, dco, dsig, dinv


def split_backward_plain(mb, co, sigma, inv, counts, g, *, erf_name: str = "as5",
                         exp_name: str = "exact", max_block_elems: int = 1 << 22):
    """The tw backward kernel's function: the VJP of split_forward_plain
    for the cotangent g (B,N,R) → (dmb, dco (B,N,R), dsigma, dinv (B,N)).
    Every row gets its base-path gradient; rows past the count get no pair
    gradient and their g is ignored."""
    T, live = _pass_a(mb, co, sigma, inv, counts, erf_name, exp_name, max_block_elems)
    return _tw_vjp(mb, co, sigma, inv, T, live, g, erf_name, max_block_elems)


def split_backward_color_plain(mb, co, sigma, inv, albedo, counts, dcol, *,
                               erf_name: str = "as5", exp_name: str = "exact",
                               max_block_elems: int = 1 << 22):
    """The colors backward kernel's function: the VJP of
    split_forward_color_plain for dcol (B,3,R) → (dmb, dco, dsigma, dinv,
    dalbedo (B,N,3)). The weights path (colors' own dco and dalbedo, and
    the tw cotangent g = sqrt(2/pi) co albedo . dcol) by autograd with tw
    held fixed, then split_backward_plain's VJP of tw."""
    T, live = _pass_a(mb, co, sigma, inv, counts, erf_name, exp_name, max_block_elems)
    nl = live.shape[1]
    tw = torch.zeros_like(mb)
    tw[:, :nl] = sum(T)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (co, albedo, tw)]
        colors = leaves[1].transpose(1, 2) @ (_SQRT_2_PI * leaves[0] * leaves[2])
        dco_w, dalb, g = torch.autograd.grad(colors, leaves, dcol)
    dmb, dco, dsig, dinv = _tw_vjp(mb, co, sigma, inv, T, live, g, erf_name, max_block_elems)
    return dmb, dco + dco_w, dsig, dinv, dalb


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors (or raise), the plain version for CPU
# ---------------------------------------------------------------------------

def _plane_shapes(mb, co, sigma, inv, counts, albedo=None) -> dict:
    b, n, r = mb.shape
    want = {"mb": (mb, (b, n, r)), "co": (co, (b, n, r)), "sigma": (sigma, (b, n)),
            "inv": (inv, (b, n)), "counts": (counts, (b,))}
    if albedo is not None:
        want["albedo"] = (albedo, (b, n, 3))
    return want


def _ints(kernel, mb, rb, blocks, erf_name, exp_name):
    """The launch's ints: B, N, R, threads, the block sizes, erf and exp."""
    b, n, r = mb.shape
    threads = _threads(kernel.query("sgrt_split_max_threads"), rb, r)
    return [b, n, r, threads, *blocks, KERNEL_ERFS[erf_name], KERNEL_EXPS[exp_name]]


def split_forward(mb, co, sigma, inv, counts, *, rb: int = 128, pb: int = 16, qb: int = 32,
                  erf_name: str = "as5", exp_name: str = "exact") -> torch.Tensor:
    """Wrapper of the tw kernel: tw (B,N,R), zero past the count. CUDA
    tensors go to the kernel (which raises for what it does not take), CPU
    tensors to split_forward_plain. pb is the p rows a thread keeps in
    registers, qb caps the q rows staged per shared-memory pass."""
    args = (mb, co, sigma, inv, counts)
    if not _check_inputs("split_forward", _plane_shapes(*args), mb.device):
        return split_forward_plain(*args, erf_name=erf_name, exp_name=exp_name)
    _check_names(erf_name, exp_name, pb)
    tw = torch.empty_like(mb)   # the kernel writes every element
    ints = _ints(SPLIT_FWD, mb, rb, (pb, qb), erf_name, exp_name)
    SPLIT_FWD.launch([*args, tw], ints, what=f"(B, N, R, threads, pb, qb) = {ints[:6]}")
    return tw


def split_forward_color(mb, co, sigma, inv, albedo, counts, *, rb: int = 128, pb: int = 16,
                        qb: int = 32, erf_name: str = "as5",
                        exp_name: str = "exact") -> torch.Tensor:
    """Wrapper of the colors kernel: colors (B,3,R). CUDA tensors go to the
    kernel, CPU tensors to split_forward_color_plain."""
    args = (mb, co, sigma, inv, albedo, counts)
    if not _check_inputs("split_forward_color", _plane_shapes(*args[:4], counts, albedo),
                         mb.device):
        return split_forward_color_plain(*args, erf_name=erf_name, exp_name=exp_name)
    _check_names(erf_name, exp_name, pb)
    b, n, r = mb.shape
    n_split = -(-n // SPLIT_FWD_COLOR.query("sgrt_split_fwd_rows_per_block"))
    f32 = dict(dtype=torch.float32, device=mb.device)
    partial, colors = torch.empty((b, n_split, 3, r), **f32), torch.empty((b, 3, r), **f32)
    ints = _ints(SPLIT_FWD_COLOR, mb, rb, (pb, qb), erf_name, exp_name)
    SPLIT_FWD_COLOR.launch([*args, partial, colors], ints,
                           what=f"(B, N, R, threads, pb, qb) = {ints[:6]}")
    return colors


def _backward_launch(kernel, ins, albedo, *, rb, qb, erf_name, exp_name):
    """Launch a backward entry point of csrc/split.cu on checked CUDA
    inputs with its scratch (the kernel's own count of floats):
    (dmb, dco, dsigma, dinv[, dalbedo])."""
    _check_names(erf_name, exp_name)
    mb = ins[0]
    ints = _ints(kernel, mb, rb, (qb,), erf_name, exp_name)
    b, n, _, _ = ints[:4]
    count = kernel.library().sgrt_split_bwd_scratch_floats
    count.argtypes = [ctypes.c_int] * 4
    count.restype = ctypes.c_longlong
    f32 = dict(dtype=torch.float32, device=mb.device)
    scratch = [torch.empty(int(count(*ints[:4])), **f32)]
    outs = [torch.empty_like(mb), torch.empty_like(mb), torch.empty((b, n), **f32),
            torch.empty((b, n), **f32)]
    if albedo is not None:
        outs.append(torch.empty((b, n, 3), **f32))
    kernel.launch(ins + scratch + outs, ints, what=f"(B, N, R, threads, qb) = {ints[:5]}")
    return tuple(outs)


def split_backward(mb, co, sigma, inv, counts, g, *, rb: int = 128, qb: int = 32,
                   erf_name: str = "as5", exp_name: str = "exact"):
    """Wrapper of the tw backward kernel: the VJP of split_forward for the
    cotangent g (B,N,R) → (dmb, dco (B,N,R), dsigma, dinv (B,N)). CPU
    tensors go to split_backward_plain. rb caps the rays per block, qb the
    q rows staged per pass of the recomputed pass A."""
    args = (mb, co, sigma, inv, counts)
    want = _plane_shapes(*args)
    want["g"] = (g, tuple(mb.shape))
    if not _check_inputs("split_backward", want, mb.device):
        return split_backward_plain(*args, g, erf_name=erf_name, exp_name=exp_name)
    return _backward_launch(SPLIT_BWD, [*args, g], None, rb=rb, qb=qb, erf_name=erf_name,
                            exp_name=exp_name)


def split_backward_color(mb, co, sigma, inv, albedo, counts, dcol, *, rb: int = 128,
                         qb: int = 32, erf_name: str = "as5", exp_name: str = "exact"):
    """Wrapper of the colors backward kernel: the VJP of split_forward_color
    for dcol (B,3,R) → (dmb, dco, dsigma, dinv, dalbedo (B,N,3)). CPU
    tensors go to split_backward_color_plain."""
    args = (mb, co, sigma, inv, albedo, counts)
    want = _plane_shapes(*args[:4], counts, albedo)
    want["dcol"] = (dcol, (mb.shape[0], 3, mb.shape[2]))
    if not _check_inputs("split_backward_color", want, mb.device):
        return split_backward_color_plain(*args, dcol, erf_name=erf_name, exp_name=exp_name)
    return _backward_launch(SPLIT_BWD_COLOR, [*args, dcol], albedo, rb=rb, qb=qb,
                            erf_name=erf_name, exp_name=exp_name)


# ---------------------------------------------------------------------------
# the differentiable ops
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SplitOpts:
    rb: int
    rb_bwd: int
    pb: int
    qb: int
    erf_name: str
    exp_name: str


class TwSplit(torch.autograd.Function):
    """tw = split_forward(mb, co, sigma, inv, counts) with split_backward as
    its VJP (the counterpart of the JAX package's _make_tw_op). Gradients
    flow to mb, co, sigma and inv; counts gets None."""

    @staticmethod
    def forward(ctx, mb, co, sigma, inv, counts, opts: _SplitOpts):
        ctx.save_for_backward(mb, co, sigma, inv, counts)
        ctx.opts = opts
        return split_forward(mb, co, sigma, inv, counts, rb=opts.rb, pb=opts.pb, qb=opts.qb,
                             erf_name=opts.erf_name, exp_name=opts.exp_name)

    @staticmethod
    def backward(ctx, g):
        o = ctx.opts
        grads = split_backward(*ctx.saved_tensors, g.contiguous(), rb=o.rb_bwd, qb=o.qb,
                               erf_name=o.erf_name, exp_name=o.exp_name)
        return (*grads, None, None)


class ColorsSplit(torch.autograd.Function):
    """colors = split_forward_color(mb, co, sigma, inv, albedo, counts) with
    split_backward_color as its VJP (the counterpart of _make_color_op).
    Gradients flow to mb, co, sigma, inv and albedo."""

    @staticmethod
    def forward(ctx, mb, co, sigma, inv, albedo, counts, opts: _SplitOpts):
        ctx.save_for_backward(mb, co, sigma, inv, albedo, counts)
        ctx.opts = opts
        return split_forward_color(mb, co, sigma, inv, albedo, counts, rb=opts.rb, pb=opts.pb,
                                   qb=opts.qb, erf_name=opts.erf_name, exp_name=opts.exp_name)

    @staticmethod
    def backward(ctx, dcol):
        o = ctx.opts
        grads = split_backward_color(*ctx.saved_tensors, dcol.contiguous(), rb=o.rb_bwd,
                                     qb=o.qb, erf_name=o.erf_name, exp_name=o.exp_name)
        return (*grads, None, None)


def _split_op(fwd, op, planes, counts, *, rb, pb, qb, rb_bwd, erf_name, exp_name):
    """tw_split / colors_split: the JAX package's block rules and count
    clamp, then the op when a gradient is wanted, else the forward."""
    erf_name = _kernel_erf_name(erf_name)
    b, n, r = planes[0].shape
    rb = min(rb, r)
    rb_bwd = rb if rb_bwd is None else min(rb_bwd, r)
    pb, qb = min(pb, n), min(qb, n)
    if r % rb or n % pb or n % qb or r % rb_bwd or pb % 8 or qb % 8:
        raise ValueError(f"shape (R={r}, N={n}) not divisible by blocks "
                         f"(rb={rb}, rb_bwd={rb_bwd}, pb={pb}, qb={qb})")
    if counts is None:
        counts = torch.full((b,), n, dtype=torch.int32, device=planes[0].device)
    # clamp: a count past the padded capacity would run the loops off the
    # end of the arrays (callers detect overflow on the unclamped counts)
    counts = torch.clamp(counts.to(torch.int32), max=n).contiguous()
    planes = [t.contiguous() for t in planes]
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in planes)):
        return fwd(*planes, counts, rb=rb, pb=pb, qb=qb, **kw)
    return op.apply(*planes, counts, _SplitOpts(rb, rb_bwd, pb, qb, erf_name, exp_name))


def tw_split(mb, co, sigma, inv, counts=None, *, rb: int = 128, pb: int = 16, qb: int = 32,
             rb_bwd: int | None = None, erf_name: str = "as5", exp_name: str = "exact"):
    """Transmittance weights (the counterpart of tw_pallas): Gaussian-major
    mb, co (B,N,R); sigma, inv (B,N); counts (B,) int32 live-prefix lengths
    (None → all N live; clamped to N) → tw (B,N,R), zero past the count.
    R % rb == 0, N % pb == N % qb == 0 with pb and qb multiples of 8 (after
    taking each at most its axis), else ValueError. "exact" erf means as5.
    Differentiable in mb, co, sigma and inv. Live rows' tw and every
    gradient match tw_pallas's when rows past the count are inert (co = 0)
    or the counts are multiples of pb and qb; otherwise Pallas sums whole q
    blocks into acc_k and the two differ (module note)."""
    return _split_op(split_forward, TwSplit, (mb, co, sigma, inv), counts, rb=rb, pb=pb,
                     qb=qb, rb_bwd=rb_bwd, erf_name=erf_name, exp_name=exp_name)


def colors_split(mb, co, sigma, inv, albedo, counts=None, *, rb: int = 128, pb: int = 16,
                 qb: int = 32, rb_bwd: int | None = None, erf_name: str = "as5",
                 exp_name: str = "exact"):
    """Radiance from the planes (the counterpart of colors_pallas): the
    inputs of tw_split plus albedo (B,N,3) → colors (B,3,R); tw never
    reaches device memory. Differentiable in mb, co, sigma, inv and
    albedo."""
    return _split_op(split_forward_color, ColorsSplit, (mb, co, sigma, inv, albedo), counts,
                     rb=rb, pb=pb, qb=qb, rb_bwd=rb_bwd, erf_name=erf_name, exp_name=exp_name)


# ---------------------------------------------------------------------------
# planes from a scene, and the split render route
# ---------------------------------------------------------------------------

def prep_terms_t(o, dirs, scene: GaussianScene):
    """The per-(Gaussian, ray) planes the split kernels take, Gaussian-major
    (port of _prep_terms_T): dirs (..., R, 3), scene fields with matching
    leading axes, o broadcast against scene.mu → mb, cbar, coeff
    (..., N, R) and inv (..., N). Plain tensor ops; autograd differentiates
    them. mb = oc . d and |oc|^2 are float32 sums of products in a fixed
    order, as the fused kernels round them (csrc/gauss_common.cuh,
    dot3_rn), so the exponent -(|oc|^2 - mb^2) / (2 sigma^2), which cancels
    the two, matches the fused route's; no matrix product, so no TF32."""
    oc = scene.mu - o                                        # (..., N, 3)
    x, y, z = (oc[..., c:c + 1] for c in range(3))           # (..., N, 1)
    d = dirs.transpose(-1, -2)[..., None, :, :]              # (..., 1, 3, R)
    mb = x * d[..., 0, :] + y * d[..., 1, :] + z * d[..., 2, :]
    oc_sq = x * x + y * y + z * z
    inv_2s2 = 1.0 / (2.0 * scene.sigma**2)
    cbar = scene.magnitude[..., None] * torch.exp(-(oc_sq - mb * mb) * inv_2s2[..., None])
    coeff = (scene.sigma * INV_SQRT_2_PI)[..., None] * cbar
    inv = 1.0 / (SQRT_2 * scene.sigma)
    return mb, cbar, coeff, inv


def render_tiles_split(tiled_scene: GaussianScene, o, tile_dirs, counts=None, *,
                       rb: int = 128, pb: int | None = None, qb: int | None = None,
                       rb_bwd: int | None = None, erf_name: str = "as5",
                       exp_name: str = "exact") -> torch.Tensor:
    """Per-tile colors (T2, P, 3) through the split kernels: prep_terms_t
    makes the (T2, K, P) planes, colors_split renders them. Inputs as
    ops.cuda_kernel.render_tiles_fused; differentiable in the scene and the
    ray directions."""
    dpb, dqb = _block_sizes(tiled_scene.mu.shape[1])
    o_b = o[None, None, :] if o.dim() == 1 else o[:, None, :]
    mb, _, coeff, inv = prep_terms_t(o_b, tile_dirs, tiled_scene)
    colors_t = colors_split(mb, coeff, tiled_scene.sigma, inv, tiled_scene.albedo, counts,
                            rb=rb, pb=dpb if pb is None else pb, qb=dqb if qb is None else qb,
                            rb_bwd=rb_bwd, erf_name=erf_name, exp_name=exp_name)
    return colors_t.transpose(1, 2)
