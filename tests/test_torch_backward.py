"""Port parity: the forward-with-T and the analytic backward of the fused op
(sgrt_tpu_torch.ops.cuda_kernel) against the JAX package's Pallas kernels,
run in interpret mode on the CPU.

On CPU tensors the wrappers run the kernels' plain versions, which are
held against Pallas here; the CUDA kernels are held against the plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerance: 5e-5 of each output's max |value|, the JAX package's gradient
tolerance (tests/test_pallas.py), for colors, T and gradients alike. T is
exp(base - acc_k) with base and acc_k sums of up to 64 terms of size ~1,
so float32 summation order alone moves it by ~1e-5 relative (its values
reach 1.6, so the forward's absolute 2e-5 does not hold for it). Inputs
sit at distance <= 3.5 with sigma >= 0.2, where float32 rounding of the
Gaussian exponent stays far below the tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.ops import pallas_kernel as jpk
from sgrt_tpu_torch.ops import cuda_kernel as tk
from sgrt_tpu_torch.ops import cuda_render as cr

GRAD_NAMES = ("oc", "sigma", "mag", "albedo", "dirs")
REL = 5e-5


def _inputs(b=3, n=64, r=128, counts=(64, 17, 0), seed=0, negative=False):
    """oc, sigma, mag, albedo, dirs_t, counts, dcol as numpy; rows past each
    count are the inert dummies tiling produces."""
    rng = np.random.default_rng(seed)
    oc = (rng.uniform(-1, 1, (b, n, 3)) + [0.0, 0.0, 2.5]).astype(np.float32)
    sig = rng.uniform(0.2, 0.4, (b, n)).astype(np.float32)
    mag = rng.uniform(0.1, 0.5, (b, n)).astype(np.float32)
    if negative:
        mag[:, ::3] *= -1.0
    alb = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3, r)) * np.array([0.3, 0.3, 1.0])[None, :, None]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cnt = np.asarray(counts, np.int32)
    dead = np.arange(n)[None, :] >= np.minimum(cnt, n)[:, None]
    oc[dead], sig[dead], mag[dead], alb[dead] = 0.0, 1.0, 0.0, 0.0
    dcol = rng.normal(size=(b, 3, r)).astype(np.float32)
    return oc, sig, mag, alb, d, cnt, dcol


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def test_forward_t_plain_matches_pallas():
    args = _inputs()
    jc, jt = jpk._fused_fwd_t_call(*(jnp.asarray(a) for a in args[:6]), rb=128, pb=8, qb=16,
                                   erf_name="as5", exp_name="exact", interpret=True)
    tc, tt = tk.fused_forward_t(*_torch(args[:6]))
    assert tt.shape == (3, 5, 64, 128)
    jc, jt = np.asarray(jc), np.asarray(jt)
    np.testing.assert_allclose(tc.numpy(), jc, atol=REL * np.abs(jc).max())
    # Pallas writes T for whole p blocks (pb = 8), so the dead rows 17..23 of
    # tile 1 hold values there (their magnitude 0 zeroes every use); the
    # port writes T = 0 on every row at or past the count.
    live = np.arange(64)[None, None, :, None] < args[5][:, None, None, None]
    np.testing.assert_allclose(np.where(live, tt.numpy(), 0.0), np.where(live, jt, 0.0),
                               atol=REL * np.abs(jt).max())
    assert np.all(tt[1, :, 17:].numpy() == 0.0) and np.all(tt[2].numpy() == 0.0)
    assert np.all(jt[1, :, 24:] == 0.0) and np.all(jt[2] == 0.0)
    assert tt[1, :, :17].abs().max() > 0.1
    # the colors equal the plain forward's
    np.testing.assert_array_equal(tc.numpy(), tk.fused_forward(*_torch(args[:6])).numpy())


CASES = {
    "two_ray_blocks": dict(b=2, n=32, r=256, counts=(32, 20), seed=2),
    "negative_mag": dict(negative=True, seed=5),
    "dead_rows": dict(seed=0),
}


@pytest.mark.parametrize("save_t", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_render_vjp_matches_pallas(case, save_t):
    args = _inputs(**CASES[case])
    cnt = jnp.asarray(args[5])

    def f(oc, sig, mag, alb, d):
        return jpk.render_fused(oc, sig, mag, alb, d, cnt, pb=8, qb=16, rb=128,
                                save_t=save_t, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args[:5]))
    want = [np.asarray(g) for g in vjp(jnp.asarray(args[6]))]
    leaves = [t.requires_grad_(True) for t in _torch(args[:5])]
    cr.render_batched(*leaves, torch.from_numpy(args[5]), pb=8, qb=16, rb=128,
                      save_t=save_t).backward(torch.from_numpy(args[6]))
    for name, t, w in zip(GRAD_NAMES, leaves, want):
        scale = np.abs(w).max()
        np.testing.assert_allclose(t.grad.numpy(), w, atol=REL * scale, err_msg=name)
    counts = args[5]
    for b, c in enumerate(counts):
        for t in leaves[:4]:
            assert np.all(t.grad[b, c:].numpy() == 0.0)   # dead rows: exactly 0
        if c == 0:
            assert np.all(leaves[4].grad[b].numpy() == 0.0)
    if case == "negative_mag":
        neg = args[2] < 0
        # d mag keeps its sign on negative magnitudes (no |mag| guard)
        np.testing.assert_allclose(leaves[2].grad.numpy()[neg], want[2][neg],
                                   atol=REL * np.abs(want[2]).max())


def test_saved_t_and_recompute_backwards_agree():
    args = _torch(_inputs(seed=7))
    t = tk.fused_forward_t(*args[:6])[1]
    a = tk.fused_backward(*args[:6], args[6], t)
    b = tk.fused_backward(*args[:6], args[6])
    for name, x, y in zip(GRAD_NAMES, a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(),
                                   atol=1e-6 * float(y.abs().max()), err_msg=name)


class _ExactFused(torch.autograd.Function):
    """The plain forward with the plain analytic backward, float64 and the
    exact erf, so that gradcheck holds the VJP against finite differences."""

    @staticmethod
    def forward(ctx, oc, sig, mag, alb, d, counts, save_t):
        kw = dict(erf_name="exact", exp_name="exact")
        if save_t:
            colors, t = tk.fused_forward_t_plain(oc, sig, mag, alb, d, counts, **kw)
        else:
            colors, t = tk.fused_forward_plain(oc, sig, mag, alb, d, counts, **kw), None
        ctx.save_for_backward(oc, sig, mag, alb, d, counts)
        ctx.t = t
        return colors

    @staticmethod
    def backward(ctx, dcol):
        grads = tk.fused_backward_plain(*ctx.saved_tensors, dcol, ctx.t,
                                        erf_name="exact", exp_name="exact")
        return (*grads, None, None)


@pytest.mark.parametrize("save_t", [True, False])
def test_plain_backward_gradcheck_float64(save_t):
    args = _inputs(b=2, n=8, r=16, counts=(8, 5), seed=3, negative=True)
    leaves = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True) for a in args[:5]]
    counts = torch.from_numpy(args[5])
    assert torch.autograd.gradcheck(
        lambda *x: _ExactFused.apply(*x, counts, save_t), leaves, eps=1e-6, atol=1e-7,
        rtol=1e-5)


def test_render_fused_without_grad_runs_the_plain_forward_path():
    """An undifferentiated render never saves T: no autograd graph, and the
    forward alone (as the kernel route launches fused_forward)."""
    args = _torch(_inputs())
    with torch.no_grad():
        out = cr.render_batched(*[a.requires_grad_(True) for a in args[:5]], args[5])
    assert out.grad_fn is None
    assert tk.save_t_bytes(512, 320, 128) == 20 * 512 * 320 * 128


def test_backward_wrapper_checks_inputs_and_names():
    args = _torch(_inputs())
    with pytest.raises(ValueError, match="dcol has shape"):
        tk.fused_backward(*args[:6], args[6][:, :, :64])
    with pytest.raises(ValueError, match="t_saved has shape"):
        tk.fused_backward(*args[:6], args[6], torch.zeros(3, 5, 64, 64))
    # an erf with no (erf, gauss) pair takes as5's derivative, as Pallas does
    a = tk.fused_backward_plain(*args[:6], args[6], erf_name="taylor")
    b = tk.fused_backward_plain(*args[:6], args[6], erf_name="as5")
    assert all(torch.isfinite(x).all() for x in a)
    assert not torch.equal(a[0], b[0])   # the forward's erf still differs


# An erf without an (erf, gauss) pair (taylor, spline, spline_mirror). The
# one VJP of every route: T, base included, from the named erf and exp;
# every erf value and erf' of the cotangents (pass B's, the base path's)
# from as5's pair. That is the JAX package's saved-T backward
# (pallas_kernel.py:948, :976). Its recompute backward computes base with
# as5 instead (pallas_kernel.py:1094; pallas_aniso.py:389; the split
# backwards at :269, :347): a reference defect the port does not copy
# (ROADMAP Queue C), pinned below. Inputs as the dead_rows case at B 2,
# N 32, R 128 (taylor clamps the pass-A arguments, which reach |x| ~ 12).
NO_PAIR = dict(b=2, n=32, r=128, counts=(32, 17), seed=11)


@functools.lru_cache(maxsize=None)
def _pallas_vjp(erf_name: str, save_t: bool):
    args = _inputs(**NO_PAIR)
    cnt = jnp.asarray(args[5])

    def f(oc, sig, mag, alb, d):
        return jpk.render_fused(oc, sig, mag, alb, d, cnt, pb=8, qb=16, rb=128, save_t=save_t,
                                erf_name=erf_name, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args[:5]))
    return [np.asarray(g) for g in vjp(jnp.asarray(args[6]))]


@pytest.mark.parametrize("save_t", [True, False])
@pytest.mark.parametrize("erf_name", ["taylor", "spline_mirror"])
def test_vjp_without_pair_matches_pallas_saved_t(erf_name, save_t):
    """The port's fused op, both schedules (plain saved-T and recompute
    backwards), against JAX's saved-T backward at 5e-5 of scale."""
    args = _inputs(**NO_PAIR)
    want = _pallas_vjp(erf_name, True)
    leaves = [t.requires_grad_(True) for t in _torch(args[:5])]
    cr.render_batched(*leaves, torch.from_numpy(args[5]), pb=8, qb=16, rb=128, save_t=save_t,
                      erf_name=erf_name).backward(torch.from_numpy(args[6]))
    for name, t, w in zip(GRAD_NAMES, leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=REL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("erf_name,differ", [("taylor", True), ("as5", False)])
def test_pallas_recompute_defect_without_pair(erf_name, differ):
    """The reference defect, pinned: JAX's saved-T and recompute gradients
    differ under taylor (by more than 1e-3 of scale: base from as5 in the
    recompute) and agree under as5, which has its own pair."""
    rel = max(float(np.abs(a - b).max() / np.abs(a).max())
              for a, b in zip(_pallas_vjp(erf_name, True), _pallas_vjp(erf_name, False)))
    if differ:
        assert rel > 1e-3, rel
    else:
        assert rel <= REL, rel
