"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test decides inside itself whether a CUDA device is
present and skips without one, so every pytest worker collects the same
tests. Run on a machine with the card (--noconftest: tests/conftest.py
imports JAX, which the port's machine need not have):

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

Tolerances are the JAX package's (tests/test_pallas.py): 2e-5 for colors
and T, 5e-5 of each field's max |value| for gradients. The kernels round
the Gaussian exponent's inputs exactly as the plain versions do
(csrc/gauss_common.cuh), so the two differ only by summation order and by
the erf taps' own rounding (as5's tap takes the SFU's reciprocal;
test_as5_tap_accuracy holds it to its float64 formula).
"""

import numpy as np
import pytest
import torch

from sgrt_tpu_torch.models.gaussians import grid_scene
from sgrt_tpu_torch.ops import cuda_kernel as tk
from sgrt_tpu_torch.ops import cuda_render as cr
from sgrt_tpu_torch.ops.frame import render_orbit_frame

pytestmark = pytest.mark.gpu

# the erfs without an (erf, gauss) pair and the spline exp, one stack each:
# the forwards evaluate the named erf and exp, the backwards as5's pair
NEW_STACKS = [("taylor", "exact"), ("spline", "spline"), ("spline_mirror", "exact")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _inputs(dev, b=5, n=96, r=200, counts=(96, 17, 0, 40, 1000), seed=0):
    g = torch.Generator().manual_seed(seed)
    oc = torch.rand((b, n, 3), generator=g) * 2 - 1 + torch.tensor([0.0, 0.0, 2.5])
    sig = torch.rand((b, n), generator=g) * 0.15 + 0.05
    mag = torch.rand((b, n), generator=g) * 0.4 + 0.1
    alb = torch.rand((b, n, 3), generator=g)
    d = torch.randn((b, 3, r), generator=g) * torch.tensor([0.3, 0.3, 1.0])[None, :, None]
    d = d / d.norm(dim=1, keepdim=True)
    cnt = torch.tensor(counts, dtype=torch.int32)
    return [t.to(dev).contiguous() for t in (oc, sig, mag, alb, d, cnt)]


# the fused forwards (csrc/chunked.cu's forward at one chunk over IsoGeo
# rows): N 96 (three 32-row splits) and N 40 (the last split partial), with
# counts above, at and below N and 0
def _check_forwards(args, n, counts, **kw):
    """Both fused forwards, one launch each: within 2e-5 of their plain
    versions, T zero past min(count, N), a dead tile's colors zero, and the
    colors of the forward and the forward-with-T equal bit for bit."""
    before = (tk.FUSED_FWD.launches, tk.FUSED_FWD_T.launches)
    out = tk.fused_forward(*args, **kw)
    colors, t = tk.fused_forward_t(*args, **kw)
    torch.cuda.synchronize()
    assert (tk.FUSED_FWD.launches, tk.FUSED_FWD_T.launches) == (before[0] + 1, before[1] + 1)
    plain = {k: v for k, v in kw.items() if k in ("erf_name", "exp_name")}
    ref_c, ref_t = tk.fused_forward_t_plain(*args, **plain)
    assert torch.isfinite(out).all() and torch.isfinite(t).all()
    for got in (out, colors):
        np.testing.assert_allclose(got.cpu().numpy(), ref_c.cpu().numpy(), atol=2e-5)
    np.testing.assert_allclose(t.cpu().numpy(), ref_t.cpu().numpy(), atol=2e-5)
    for b, c in enumerate(counts):
        assert (t[b, :, min(c, n):] == 0).all()     # dead rows hold exactly T = 0
    assert (out[counts.index(0)] == 0).all()
    assert torch.equal(out, colors)


@pytest.mark.parametrize("erf_name,exp_name,pb,qb,n,counts", [
    ("as5", "exact", 8, 32, 96, (96, 17, 0, 40, 1000)),
    ("as5", "exact", 16, 16, 96, (96, 17, 0, 40, 1000)),
    ("as3", "fast", 8, 32, 96, (96, 17, 0, 40, 1000)),
    ("as5", "exact", 8, 8, 40, (40, 17, 0, 33, 1000)),
    *[(e, x, 8, 32, 96, (96, 17, 0, 40, 1000)) for e, x in NEW_STACKS],
])
def test_kernel_matches_plain(erf_name, exp_name, pb, qb, n, counts):
    args = _inputs(_card(), n=n, counts=counts)
    _check_forwards(args, n, counts, pb=pb, qb=qb, erf_name=erf_name, exp_name=exp_name)


GRAD_NAMES = ("oc", "sigma", "mag", "albedo", "dirs")


def _assert_grads_close(got, want, rel=5e-5):
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert torch.isfinite(a).all(), name
        scale = max(float(b.abs().max()), 1e-8)
        np.testing.assert_allclose(a.cpu().numpy() / scale, b.cpu().numpy() / scale,
                                   atol=rel, err_msg=name)


# The gate of the chunked kernels' gradients: T and every gradient are
# differences of sums over hundreds of rows, so summation order moves them
# by more than a fixed tolerance; each must be as close to a float64 run of
# the plain version as the float32 plain version is, x2, or within the JAX
# package's 5e-5 of scale.
def _double(args):
    return [x.double() if x.is_floating_point() else x for x in args]


def _assert_grads_f64_gate(got, plain, ref, rel=5e-5):
    for name, a, p, f in zip(GRAD_NAMES, got, plain, ref):
        assert torch.isfinite(a).all(), name
        scale = max(float(f.abs().max()), 1e-30)
        e_k = float((a.double() - f).abs().max()) / scale
        e_p = float((p.double() - f).abs().max()) / scale
        assert e_k <= max(rel, 2 * e_p), (name, e_k, e_p)


def test_kernel_refuses_grad_and_unported_names():
    """On the card, gradients of render_batched at one chunk come from the
    backward kernels and equal the plain backward's; the spline erf runs in both
    kernels as in their plain versions; an erf name that no package has
    raises."""
    dev = _card()
    args = _inputs(dev, r=256)
    dcol = torch.randn((5, 3, 256), generator=torch.Generator().manual_seed(3)).to(dev)
    want = tk.fused_backward_plain(*args, dcol)
    for save_t, kernel in ((True, tk.FUSED_BWD_T), (False, tk.FUSED_BWD)):
        leaves = [a.clone().requires_grad_(True) for a in args[:5]]
        before = kernel.launches
        cr.render_batched(*leaves, args[5], pb=8, qb=32, save_t=save_t).backward(dcol)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        _assert_grads_close([t.grad for t in leaves], want)
    before = (tk.FUSED_FWD.launches, tk.FUSED_BWD.launches)
    out = tk.fused_forward(*args, erf_name="spline")
    got = tk.fused_backward(*args, dcol, erf_name="spline")
    torch.cuda.synchronize()
    assert (tk.FUSED_FWD.launches, tk.FUSED_BWD.launches) == (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(out.cpu().numpy(),
                               tk.fused_forward_plain(*args, erf_name="spline").cpu().numpy(),
                               atol=2e-5)
    _assert_grads_close(got, tk.fused_backward_plain(*args, dcol, erf_name="spline"))
    with pytest.raises(ValueError, match="erf"):
        tk.fused_forward(*args, erf_name="erfc")
    with pytest.raises(ValueError, match="erf"):
        tk.fused_backward(*args, dcol, erf_name="erfc")


@pytest.mark.parametrize("erf_name,exp_name,qb,n,counts", [
    ("as5", "exact", 32, 96, (96, 17, 0, 40, 1000)),
    ("as3", "fast", 32, 96, (96, 17, 0, 40, 1000)),
    ("as5", "exact", 8, 40, (40, 17, 0, 33, 1000)),
    *[(e, x, 32, 96, (96, 17, 0, 40, 1000)) for e, x in NEW_STACKS],
])
def test_forward_t_kernel_matches_plain(erf_name, exp_name, qb, n, counts):
    """The forward-with-T at the wrappers' default pb."""
    args = _inputs(_card(), n=n, counts=counts)
    _check_forwards(args, n, counts, qb=qb, erf_name=erf_name, exp_name=exp_name)


@pytest.mark.parametrize("saved_t", [True, False])
@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast"), *NEW_STACKS])
def test_backward_kernels_match_plain(saved_t, erf_name, exp_name):
    """Both backwards at R = 200 (two ray blocks, the second partial), N =
    96 (one chunk of a 64-row block and a partial one) and counts (96, 17,
    0, 40, >N): within 5e-5 of scale of the plain backward and within the
    float64 gate (_assert_grads_f64_gate), dead rows exactly zero."""
    dev = _card()
    args = _inputs(dev)
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(4)).to(dev)
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    t = tk.fused_forward_t(*args, **kw)[1] if saved_t else None
    kernel = tk.FUSED_BWD_T if saved_t else tk.FUSED_BWD
    before = kernel.launches
    got = tk.fused_backward(*args, dcol, t, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    plain = tk.fused_backward_plain(*args, dcol, t, **kw)
    _assert_grads_close(got, plain)
    _assert_grads_f64_gate(got, plain,
                           tk.fused_backward_plain(*_double(args), dcol.double(), **kw))
    for g in got[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 40:] == 0).all()
    assert (got[4][2] == 0).all()


def test_fused_backward_any_row_count():
    """Both backwards at N = 40 (pb = qb = 8: one partial 64-row block, a
    partial 32-row forward split in the recompute): within the float64
    gate, equal to each other bit for bit, dead rows and the dead tile
    exactly zero."""
    dev = _card()
    args = _inputs(dev, n=40, counts=(40, 17, 0, 33, 1000))
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(13)).to(dev)
    t = tk.fused_forward_t(*args, pb=8, qb=8)[1]
    g_t = tk.fused_backward(*args, dcol, t, qb=8)
    g_r = tk.fused_backward(*args, dcol, qb=8)
    torch.cuda.synchronize()
    _assert_grads_f64_gate(g_t, tk.fused_backward_plain(*args, dcol),
                           tk.fused_backward_plain(*_double(args), dcol.double()))
    for a, b in zip(g_t, g_r):
        assert torch.equal(a, b)
    for g in g_t[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 33:] == 0).all()
    assert (g_t[4][2] == 0).all()


def test_backward_untiled_many_ray_blocks():
    """B = 1 with many ray blocks: the row reduction sums them all."""
    dev = _card()
    args = _inputs(dev, b=1, n=64, r=1000, counts=(61,), seed=5)
    dcol = torch.randn((1, 3, 1000), generator=torch.Generator().manual_seed(6)).to(dev)
    t = tk.fused_forward_t(*args)[1]
    want = tk.fused_backward_plain(*args, dcol)
    _assert_grads_close(tk.fused_backward(*args, dcol, t), want)
    _assert_grads_close(tk.fused_backward(*args, dcol), want)


def test_frame_kernel_route_on_card():
    dev = _card()
    scene = grid_scene(8, device=dev)
    kw = dict(width=64, height=64, tiles=4, capacity=64)
    before = tk.FUSED_FWD.launches
    img, ovf = render_orbit_frame(scene, 23.0, backend="kernel", **kw)
    assert tk.FUSED_FWD.launches == before + 1 and int(ovf) == 0
    ref, _ = render_orbit_frame(scene, 23.0, backend="torch", **kw)
    # 8e-5: the float32 conditioning bound of tests/test_torch_frame.py
    np.testing.assert_allclose(img.cpu().numpy(), ref.cpu().numpy(), atol=8e-5)
    un, _ = render_orbit_frame(scene, 23.0, backend="kernel", use_tiling=False,
                               width=32, height=32)
    assert tk.FUSED_FWD.launches == before + 2 and torch.isfinite(un).all()


@pytest.mark.parametrize("bucketed", [False, True])
def test_frame_train_step_on_card(bucketed):
    """The frame train step on the card runs through the forward-with-T and
    the saved-T backward kernels and takes the same Adam steps as on the
    CPU (losses rtol 1e-3, tests/test_torch_fit.py's tolerance)."""
    from sgrt_tpu_torch.ops.frame import orbit_camera
    from sgrt_tpu_torch.ops.scheduler import BucketConfig
    from sgrt_tpu_torch.parallel.fit import adam, init_state, make_frame_train_step

    dev = _card()
    kw = dict(width=32, height=32, tiles=4, capacity=32,
              bucket_cfg=BucketConfig(4, 16, 8) if bucketed else None)
    losses = {}
    for d in ("cpu", dev):
        g = grid_scene(4, device=d)
        cam = orbit_camera(0.0, -4.0, 1.0, 32, 32, device=d)
        o, dirs = cam.rays()
        target, _ = render_orbit_frame(g, 0.0, backend="kernel", width=32, height=32,
                                       tiles=4, capacity=32)
        step = make_frame_train_step(**kw)
        state = init_state(g.replace(mu=g.mu + 0.03), adam(3e-3))
        before = (tk.FUSED_FWD_T.launches, tk.FUSED_BWD_T.launches)
        losses[str(d)] = []
        for _ in range(3):
            state, loss, ovf = step(state, cam.view_matrix, o, dirs, target)
            assert int(ovf) == 0
            losses[str(d)].append(float(loss))
        launched = (tk.FUSED_FWD_T.launches - before[0], tk.FUSED_BWD_T.launches - before[1])
        assert launched == ((0, 0) if d == "cpu" else (3 * (1 + bucketed),) * 2)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


# the chunked kernels: N = 384 in 3 chunks of 128; counts with two live
# chunks, a partly live last chunk, a dead tile, one chunk and a count > N
CHUNK_COUNTS = (384, 17, 0, 200, 1000)


@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast"), *NEW_STACKS])
def test_chunked_forward_kernels_match_plain(erf_name, exp_name):
    from sgrt_tpu_torch.ops import cuda_chunked as tc

    args = _inputs(_card(), n=384, counts=CHUNK_COUNTS)
    kw = dict(ck=128, erf_name=erf_name, exp_name=exp_name)
    before = (tc.CHUNKED_FWD.launches, tc.CHUNKED_FWD_T.launches)
    out = tc.chunked_forward(*args, **kw)
    colors, t = tc.chunked_forward_t(*args, **kw)
    torch.cuda.synchronize()
    assert (tc.CHUNKED_FWD.launches, tc.CHUNKED_FWD_T.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    ref_c, ref_t = tc.chunked_forward_t_plain(*args, **kw)
    for got in (out, colors):
        np.testing.assert_allclose(got.cpu().numpy(), ref_c.cpu().numpy(), atol=2e-5)
    # T = w exp(base - acc) with base and acc sums of up to N = 384 terms:
    # summation order moves T relatively, by ~sqrt(N) ulp of those sums, so
    # T is held relative to its scale, at the gradients' 5e-5
    scale = float(ref_t.abs().max())
    np.testing.assert_allclose(t.cpu().numpy() / scale, ref_t.cpu().numpy() / scale, atol=5e-5)
    for b, c in enumerate(CHUNK_COUNTS):
        assert (t[b, :, min(c, 384):] == 0).all()
    assert (out[2] == 0).all()
    # T is rounded alike whether or not it is stored (csrc/chunked.cu)
    assert torch.equal(out, colors)


@pytest.mark.parametrize("saved_t", [True, False])
@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast"), *NEW_STACKS])
def test_chunked_backward_kernels_match_plain(saved_t, erf_name, exp_name):
    """Both chunked backwards at R = 200 (two ray blocks, the second
    partial): q-side sums carried over three p chunks, held against a
    float64 run of the plain version (_assert_grads_f64_gate); dead rows and
    the dead tile exactly zero; the recompute backward redoes the forward's
    pass A with the same code, so both give the same gradients bit for
    bit."""
    from sgrt_tpu_torch.ops import cuda_chunked as tc

    dev = _card()
    args = _inputs(dev, n=384, counts=CHUNK_COUNTS)
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(7)).to(dev)
    kw = dict(ck=128, erf_name=erf_name, exp_name=exp_name)
    t_saved = tc.chunked_forward_t(*args, **kw)[1]
    t = t_saved if saved_t else None
    kernel = tc.CHUNKED_BWD_T if saved_t else tc.CHUNKED_BWD
    before = kernel.launches
    got = tc.chunked_backward(*args, dcol, t, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _assert_grads_f64_gate(got, tc.chunked_backward_plain(*args, dcol, t, **kw),
                           tc.chunked_backward_plain(*_double(args), dcol.double(), **kw))
    for g in got[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 200:] == 0).all()
    assert (got[4][2] == 0).all()
    other = tc.chunked_backward(*args, dcol, None if saved_t else t_saved, **kw)
    for name, a, b in zip(GRAD_NAMES, got, other):
        assert torch.equal(a, b), name


def test_chunked_kernels_refuse_bad_qb():
    """A qb that the chunked kernels do not take (below 8 staged rows)
    reaches the launch, which refuses it: each wrapper raises the launch's
    RuntimeError and counts no launch, with no plain run in its place."""
    from sgrt_tpu_torch.ops import cuda_chunked as tc

    dev = _card()
    args = _inputs(dev, n=384, counts=CHUNK_COUNTS)
    dcol = torch.zeros((5, 3, 200), device=dev)
    t = tc.chunked_forward_t(*args, ck=128)[1]
    calls = {tc.CHUNKED_FWD: lambda: tc.chunked_forward(*args, ck=128, qb=4),
             tc.CHUNKED_FWD_T: lambda: tc.chunked_forward_t(*args, ck=128, qb=4),
             tc.CHUNKED_BWD_T: lambda: tc.chunked_backward(*args, dcol, t, ck=128, qb=4),
             tc.CHUNKED_BWD: lambda: tc.chunked_backward(*args, dcol, ck=128, qb=4)}
    for kernel, call in calls.items():
        before = kernel.launches
        with pytest.raises(RuntimeError, match=f"{kernel.name} launch failed"):
            call()
        assert kernel.launches == before


def test_chunked_route_on_card():
    """render_batched's chunked gradients on the card come from the chunked
    backward kernels (both schedules) and equal the plain backward's; the
    chunked and fused forwards agree on the same inputs, under the spline
    erf too; an erf name that no package has raises."""
    from sgrt_tpu_torch.ops import cuda_chunked as tc

    dev = _card()
    args = _inputs(dev, n=384, r=256, counts=CHUNK_COUNTS)
    dcol = torch.randn((5, 3, 256), generator=torch.Generator().manual_seed(8)).to(dev)
    want = tc.chunked_backward_plain(*args, dcol, ck=128)
    for save_t, kernel in ((True, tc.CHUNKED_BWD_T), (False, tc.CHUNKED_BWD)):
        leaves = [a.clone().requires_grad_(True) for a in args[:5]]
        before = kernel.launches
        cr.render_batched(*leaves, args[5], ck=128, save_t=save_t).backward(dcol)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        _assert_grads_close([x.grad for x in leaves], want)
    fused = tk.fused_forward(*args)
    np.testing.assert_allclose(tc.chunked_forward(*args, ck=128).cpu().numpy(),
                               fused.cpu().numpy(), atol=2e-5)
    np.testing.assert_allclose(tc.chunked_forward(*args, ck=128, erf_name="spline").cpu().numpy(),
                               tk.fused_forward(*args, erf_name="spline").cpu().numpy(),
                               atol=2e-5)
    with pytest.raises(ValueError, match="erf"):
        tc.chunked_forward(*args, ck=128, erf_name="erfc")


# the anisotropic kernels (the forwards and the backwards csrc/chunked.cu's
# over AnisoGeo rows at one chunk): _inputs' rows with per-axis scales
# sigma * (1.6, 0.7, 1.0), the stretched teapot cell's multipliers
def _aniso_inputs(dev, **kw):
    oc, sig, mag, alb, d, cnt = _inputs(dev, **kw)
    scale = sig[..., None] * torch.tensor([1.6, 0.7, 1.0], device=dev)
    return [oc, (1.0 / (scale * scale)).contiguous(), mag, alb, d, cnt]


@pytest.mark.parametrize("erf_name,exp_name,pb,qb,n,counts", [
    ("as5", "exact", 8, 32, 96, (96, 17, 0, 40, 1000)),
    ("as5", "exact", 16, 16, 96, (96, 17, 0, 40, 1000)),
    ("as3", "fast", 8, 32, 96, (96, 17, 0, 40, 1000)),
    ("as5", "exact", 8, 8, 40, (40, 17, 0, 33, 1000)),
    *[(e, x, 8, 32, 96, (96, 17, 0, 40, 1000)) for e, x in NEW_STACKS],
])
def test_aniso_forward_kernels_match_plain(erf_name, exp_name, pb, qb, n, counts):
    """The anisotropic forwards within 2e-5 of their plain versions, T zero
    past the count, the colors of both forwards equal bit for bit; at N 40
    the last 32-row split is partial."""
    from sgrt_tpu_torch.ops import cuda_aniso as ta

    args = _aniso_inputs(_card(), n=n, counts=counts)
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    before = (ta.FUSED_FWD_ANISO.launches, ta.FUSED_FWD_T_ANISO.launches)
    out = ta.fused_forward_aniso(*args, pb=pb, qb=qb, **kw)
    colors, t = ta.fused_forward_t_aniso(*args, pb=pb, qb=qb, **kw)
    torch.cuda.synchronize()
    assert (ta.FUSED_FWD_ANISO.launches, ta.FUSED_FWD_T_ANISO.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    ref_c, ref_t = ta.fused_forward_t_aniso_plain(*args, **kw)
    for got in (out, colors):
        np.testing.assert_allclose(got.cpu().numpy(), ref_c.cpu().numpy(), atol=2e-5)
    np.testing.assert_allclose(t.cpu().numpy(), ref_t.cpu().numpy(), atol=2e-5)
    for b, c in enumerate(counts):
        assert (t[b, :, min(c, n):] == 0).all()
    assert (out[2] == 0).all()
    assert torch.equal(out, colors)


@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast"), *NEW_STACKS])
def test_aniso_backward_kernels_match_plain(erf_name, exp_name):
    """Both anisotropic backwards at R = 200 (two ray blocks, the second
    partial) and N = 96 (one chunk of a 64-row block and a partial one):
    within 5e-5 of scale of the plain backward and within the float64 gate
    (_assert_grads_f64_gate), equal to each other bit for bit (the
    recompute's T is the forward's), dead rows and the dead tile exactly
    zero."""
    from sgrt_tpu_torch.ops import cuda_aniso as ta

    dev = _card()
    args = _aniso_inputs(dev)
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(4)).to(dev)
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    t = ta.fused_forward_t_aniso(*args, **kw)[1]
    before = (ta.FUSED_BWD_T_ANISO.launches, ta.FUSED_BWD_ANISO.launches)
    g_t = ta.fused_backward_aniso(*args, dcol, t, **kw)
    g_r = ta.fused_backward_aniso(*args, dcol, **kw)
    torch.cuda.synchronize()
    assert (ta.FUSED_BWD_T_ANISO.launches, ta.FUSED_BWD_ANISO.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    plain = ta.fused_backward_aniso_plain(*args, dcol, **kw)
    _assert_grads_close(g_t, plain)
    _assert_grads_f64_gate(g_t, plain,
                           ta.fused_backward_aniso_plain(*_double(args), dcol.double(), **kw))
    for a, b in zip(g_t, g_r):
        assert torch.equal(a, b)
    for g in g_t[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 40:] == 0).all()
    assert (g_t[4][2] == 0).all()


def test_fused_aniso_backward_any_row_count():
    """The anisotropic backwards at N = 40 (pb = qb = 8: one partial 64-row
    block, a partial 32-row forward split in the recompute): within the
    float64 gate, equal to each other bit for bit, dead rows exactly zero."""
    from sgrt_tpu_torch.ops import cuda_aniso as ta

    dev = _card()
    args = _aniso_inputs(dev, n=40, counts=(40, 17, 0, 33, 1000))
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(12)).to(dev)
    t = ta.fused_forward_t_aniso(*args, pb=8, qb=8)[1]
    g_t = ta.fused_backward_aniso(*args, dcol, t, qb=8)
    g_r = ta.fused_backward_aniso(*args, dcol, qb=8)
    torch.cuda.synchronize()
    _assert_grads_f64_gate(g_t, ta.fused_backward_aniso_plain(*args, dcol),
                           ta.fused_backward_aniso_plain(*_double(args), dcol.double()))
    for a, b in zip(g_t, g_r):
        assert torch.equal(a, b)
    for g in g_t[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 33:] == 0).all()
    assert (g_t[4][2] == 0).all()


@pytest.mark.parametrize("bucketed", [False, True])
def test_aniso_train_step_on_card(bucketed):
    """make_aniso_frame_train_step on the card runs through the anisotropic
    forward-with-T and saved-T backward kernels and takes the same Adam
    steps as on the CPU (losses rtol 1e-3)."""
    from sgrt_tpu_torch.ops import anisotropic as an
    from sgrt_tpu_torch.ops import cuda_aniso as ta
    from sgrt_tpu_torch.ops.frame import orbit_camera
    from sgrt_tpu_torch.ops.scheduler import BucketConfig
    from sgrt_tpu_torch.parallel.fit import adam, init_state, make_aniso_frame_train_step

    dev = _card()
    kw = dict(width=32, height=32, tiles=4, capacity=32,
              bucket_cfg=BucketConfig(4, 32, 16) if bucketed else None)
    losses = {}
    for d in ("cpu", dev):
        truth = an.from_isotropic(grid_scene(4, device=d))
        truth = truth.replace(scale=truth.scale * torch.tensor([[1.6, 0.7, 1.0]], device=d))
        cam = orbit_camera(20.0, -4.0, 1.0, 32, 32, device=d)
        o, dirs = cam.rays()
        target, _ = an.render_tiled_aniso(truth, cam, tiles=4, capacity=32, backend="kernel")
        step = make_aniso_frame_train_step(**kw)
        state = init_state(truth.replace(scale=truth.scale * 1.1), adam(3e-3))
        before = (ta.FUSED_FWD_T_ANISO.launches, ta.FUSED_BWD_T_ANISO.launches)
        losses[str(d)] = []
        for _ in range(3):
            state, loss, ovf = step(state, cam.view_matrix, o, dirs, target)
            assert int(ovf) == 0
            losses[str(d)].append(float(loss))
        launched = (ta.FUSED_FWD_T_ANISO.launches - before[0],
                    ta.FUSED_BWD_T_ANISO.launches - before[1])
        assert launched == ((0, 0) if d == "cpu" else (3 * (1 + bucketed),) * 2)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    assert losses["cuda"][-1] < losses["cuda"][0]


def test_fused_backward_sums_at_thousands_of_rows():
    """The fused backward at 3000 rows a tile, where float32 sums over a
    tile's rows dominate the error: every output of both backwards is as
    close to a float64 run of the plain version as the float32 plain
    version is, up to a factor of 2 (or within 1e-5 of scale; doc, whose
    terms cancel ~|oc|/sigma = 100 times its size, 2e-4), and the two
    backwards are equal bit for bit."""
    dev = _card()
    n, r = 3072, 128
    g = torch.Generator().manual_seed(9)
    v = torch.randn((2, n, 3), generator=g)
    oc = v / v.norm(dim=-1, keepdim=True) + torch.tensor([0.0, 0.0, 4.0])
    d = torch.randn((2, 3, r), generator=g) * 0.05 + torch.tensor([0.0, 0.0, 1.0])[None, :, None]
    d = d / d.norm(dim=1, keepdim=True)
    args = [x.to(dev).contiguous() for x in (
        oc, torch.full((2, n), 0.05), torch.ones((2, n)), torch.rand((2, n, 3), generator=g),
        d, torch.tensor([n, 2500], dtype=torch.int32))]
    dcol = torch.randn((2, 3, r), generator=g).to(dev)
    t = tk.fused_forward_t(*args)[1]
    g_t = tk.fused_backward(*args, dcol, t)
    g_r = tk.fused_backward(*args, dcol)
    plain = tk.fused_backward_plain(*args, dcol)
    ref = tk.fused_backward_plain(*[x.double() if x.is_floating_point() else x for x in args],
                                  dcol.double())
    for name, a, b, p, f in zip(GRAD_NAMES, g_t, g_r, plain, ref):
        assert torch.equal(a, b), name
        scale = float(f.abs().max())
        e_k = float((a.double() - f).abs().max()) / scale
        e_p = float((p.double() - f).abs().max()) / scale
        assert e_k <= max(2e-4 if name == "oc" else 1e-5, 2 * e_p), (name, e_k, e_p)


def test_fused_aniso_backward_sums_at_thousands_of_rows():
    """The anisotropic twin of the test above: both fused anisotropic
    backwards (csrc/chunked.cu at one chunk) at 3072 rows a tile, counts
    (3072, 2500), scales 0.05 x (1.6, 0.7, 1.0): every output as close to a
    float64 run of the plain version as the float32 plain version is, up to
    a factor of 2 (or within 1e-5 of scale; doc and dinvd, whose terms cancel
    ~|oc|^2/scale^2, 2e-4), and the two backwards equal bit for bit."""
    from sgrt_tpu_torch.ops import cuda_aniso as ta

    dev = _card()
    n, r = 3072, 128
    g = torch.Generator().manual_seed(10)
    v = torch.randn((2, n, 3), generator=g)
    oc = v / v.norm(dim=-1, keepdim=True) + torch.tensor([0.0, 0.0, 4.0])
    d = torch.randn((2, 3, r), generator=g) * 0.05 + torch.tensor([0.0, 0.0, 1.0])[None, :, None]
    d = d / d.norm(dim=1, keepdim=True)
    scale = torch.full((2, n, 1), 0.05) * torch.tensor([1.6, 0.7, 1.0])
    args = [x.to(dev).contiguous() for x in (
        oc, 1.0 / (scale * scale), torch.ones((2, n)), torch.rand((2, n, 3), generator=g), d,
        torch.tensor([n, 2500], dtype=torch.int32))]
    dcol = torch.randn((2, 3, r), generator=g).to(dev)
    t = ta.fused_forward_t_aniso(*args)[1]
    before = (ta.FUSED_BWD_T_ANISO.launches, ta.FUSED_BWD_ANISO.launches)
    g_t = ta.fused_backward_aniso(*args, dcol, t)
    g_r = ta.fused_backward_aniso(*args, dcol)
    torch.cuda.synchronize()
    assert (ta.FUSED_BWD_T_ANISO.launches, ta.FUSED_BWD_ANISO.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    plain = ta.fused_backward_aniso_plain(*args, dcol)
    ref = ta.fused_backward_aniso_plain(*_double(args), dcol.double())
    for name, a, b, p, f in zip(("oc", "invd", "mag", "albedo", "dirs"), g_t, g_r, plain, ref):
        assert torch.equal(a, b), name
        scale = float(f.abs().max())
        e_k = float((a.double() - f).abs().max()) / scale
        e_p = float((p.double() - f).abs().max()) / scale
        assert e_k <= max(2e-4 if name in ("oc", "invd") else 1e-5, 2 * e_p), (name, e_k, e_p)


# the chunked anisotropic kernels (kernels 13-14: csrc/chunked.cu's
# templates over AnisoGeo rows) on _aniso_inputs' rows at N = 384 in three
# chunks of 128: CHUNK_COUNTS give a tile with all three chunks live, one
# whose only live chunk is partly live (17), a dead tile, one whose second
# chunk is partly live (200) and one clamped to N; R = 200 is two ray
# blocks, the second partial. Gradients are held to the float64 gate
# (_assert_grads_f64_gate).
@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast"), *NEW_STACKS])
def test_chunked_aniso_kernels_match_plain(erf_name, exp_name):
    from sgrt_tpu_torch.ops import cuda_aniso as ta
    from sgrt_tpu_torch.ops import cuda_chunked_aniso as tca

    dev = _card()
    args = _aniso_inputs(dev, n=384, counts=CHUNK_COUNTS)
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(5)).to(dev)
    kw = dict(ck=128, erf_name=erf_name, exp_name=exp_name)
    before = (tca.CHUNKED_FWD_ANISO.launches, tca.CHUNKED_BWD_ANISO.launches,
              ta.FUSED_FWD_ANISO.launches)
    out = tca.chunked_forward_aniso(*args, **kw)
    got = tca.chunked_backward_aniso(*args, dcol, **kw)
    torch.cuda.synchronize()
    assert (tca.CHUNKED_FWD_ANISO.launches, tca.CHUNKED_BWD_ANISO.launches,
            ta.FUSED_FWD_ANISO.launches) == (before[0] + 1, before[1] + 1, before[2])
    np.testing.assert_allclose(out.cpu().numpy(),
                               tca.chunked_forward_aniso_plain(*args, **kw).cpu().numpy(),
                               atol=2e-5)
    _assert_grads_f64_gate(got, tca.chunked_backward_aniso_plain(*args, dcol, **kw),
                           tca.chunked_backward_aniso_plain(*_double(args), dcol.double(), **kw))
    assert (out[2] == 0).all()
    for g in got[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 200:] == 0).all()
    assert (got[4][2] == 0).all()


@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast"), *NEW_STACKS])
def test_chunked_aniso_saved_t_kernels_match_plain(erf_name, exp_name):
    """The saved-T schedule's kernels (the forward-with-T and the saved-T
    backward) against their plain versions and float64; T is 0 on dead rows
    and the saved-T backward equals the recompute one bit for bit."""
    from sgrt_tpu_torch.ops import cuda_chunked_aniso as tca

    dev = _card()
    args = _aniso_inputs(dev, n=384, counts=CHUNK_COUNTS)
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(7)).to(dev)
    kw = dict(ck=128, erf_name=erf_name, exp_name=exp_name)
    before = (tca.CHUNKED_FWD_T_ANISO.launches, tca.CHUNKED_BWD_T_ANISO.launches)
    colors, t = tca.chunked_forward_t_aniso(*args, **kw)
    got = tca.chunked_backward_aniso(*args, dcol, t, **kw)
    torch.cuda.synchronize()
    assert (tca.CHUNKED_FWD_T_ANISO.launches,
            tca.CHUNKED_BWD_T_ANISO.launches) == (before[0] + 1, before[1] + 1)
    want_c, want_t = tca.chunked_forward_t_aniso_plain(*args, **kw)
    np.testing.assert_allclose(colors.cpu().numpy(), want_c.cpu().numpy(), atol=2e-5)
    # T relative to its scale, as test_chunked_forward_kernels_match_plain
    # holds it (sums of up to 384 terms in its exponent)
    scale = float(want_t.abs().max())
    np.testing.assert_allclose(t.cpu().numpy() / scale, want_t.cpu().numpy() / scale, atol=5e-5)
    assert torch.equal(colors, tca.chunked_forward_aniso(*args, **kw))
    dead = torch.arange(384, device=dev)[None, :] >= args[5].clamp(max=384)[:, None].long()
    assert (t.permute(0, 2, 1, 3)[dead] == 0).all()
    _assert_grads_f64_gate(got, tca.chunked_backward_aniso_plain(*args, dcol, t, **kw),
                           tca.chunked_backward_aniso_plain(*_double(args), dcol.double(), **kw))
    for a, b in zip(got, tca.chunked_backward_aniso(*args, dcol, **kw)):
        assert torch.equal(a, b)


def test_chunked_aniso_route_on_card():
    """render_batched's chunked anisotropic gradients on the card come from
    the saved-T schedule under the byte budget and from the recompute backward
    above it, equal to each other and within the float64 gate of the plain
    backward; its colors are the chunked forward's; a chunk size that does
    not divide N raises."""
    from sgrt_tpu_torch.ops import cuda_chunked as tc
    from sgrt_tpu_torch.ops import cuda_chunked_aniso as tca

    dev = _card()
    args = _aniso_inputs(dev, n=384, r=256, counts=CHUNK_COUNTS)
    dcol = torch.randn((5, 3, 256), generator=torch.Generator().manual_seed(6)).to(dev)
    grads = {}
    budget = tc.SAVE_T_CHUNKED_MAX_BYTES
    for kernel, limit in ((tca.CHUNKED_BWD_T_ANISO, budget), (tca.CHUNKED_BWD_ANISO, 0)):
        leaves = [a.clone().requires_grad_(True) for a in args[:5]]
        before = kernel.launches
        tc.SAVE_T_CHUNKED_MAX_BYTES = limit
        try:
            colors = cr.render_batched(*leaves, args[5], geometry=cr.ANISO, ck=128)
            colors.backward(dcol)
        finally:
            tc.SAVE_T_CHUNKED_MAX_BYTES = budget
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(colors.detach(), tca.chunked_forward_aniso(*args, ck=128))
        grads[kernel.name] = [x.grad for x in leaves]
    _assert_grads_f64_gate(grads[tca.CHUNKED_BWD_T_ANISO.name],
                           tca.chunked_backward_aniso_plain(*args, dcol, ck=128),
                           tca.chunked_backward_aniso_plain(*_double(args), dcol.double(), ck=128))
    for a, b in zip(*grads.values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="chunks"):
        tca.chunked_backward_aniso(*args, dcol, ck=256)


# the split kernels (csrc/chunked.cu at one chunk over plane rows: 15 and 17
# its forward, storing tw or the colors, 16 and 18 its recompute backward)
# on seeded planes: co
# non-zero on every row (base runs over all N), counts (N, 37, 0, 1000): a
# full tile, one with a partial block, a dead tile and one clamped to N; N 96
# (two 64-row backward blocks) and N 40 (one, partial); R = 200 is several
# ray blocks, the last partial. The outputs are held against a float64 run
# of the plain versions as above (_assert_grads_f64_gate): as close to it as
# the float32 plain version is, x2, or within 2e-5 (tw, colors) and 5e-5
# (gradients) of scale.
SPLIT_GRADS = ("dmb", "dco", "dsigma", "dinv", "dalbedo")


def _planes(dev, b=4, n=96, r=200, seed=0):
    g = torch.Generator().manual_seed(seed)
    mb = torch.randn((b, n, r), generator=g)
    co = torch.rand((b, n, r), generator=g) * 0.05
    sig = torch.rand((b, n), generator=g) * 0.3 + 0.3
    inv = 1.0 / (1.4142135623730951 * sig)
    alb = torch.rand((b, n, 3), generator=g)
    cnt = torch.tensor((n, 37, 0, 1000), dtype=torch.int32)
    return [t.to(dev).contiguous() for t in (mb, co, sig, inv, alb, cnt)]


def _gate(names, got, plain, ref, rel):
    for name, a, p, f in zip(names, got, plain, ref):
        assert torch.isfinite(a).all(), name
        scale = max(float(f.abs().max()), 1e-30)
        e_k = float((a.double() - f).abs().max()) / scale
        e_p = float((p.double() - f).abs().max()) / scale
        assert e_k <= max(rel, 2 * e_p), (name, e_k, e_p)


@pytest.mark.parametrize("erf_name,exp_name,pb,n", [("as5", "exact", 16, 96),
                                                    ("as5", "exact", 8, 96),
                                                    ("as3", "fast", 16, 96),
                                                    ("as5", "exact", 8, 40),
                                                    *[(e, x, 16, 96) for e, x in NEW_STACKS]])
def test_split_kernels_match_plain(erf_name, exp_name, pb, n):
    from sgrt_tpu_torch.ops import cuda_split as cs

    dev = _card()
    mb, co, sig, inv, alb, cnt = _planes(dev, n=n)
    planes = (mb, co, sig, inv)
    g = torch.randn(mb.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    dcol = torch.randn((4, 3, 200), generator=torch.Generator().manual_seed(2)).to(dev)
    kw = dict(erf_name=erf_name, exp_name=exp_name)
    kernels = (cs.SPLIT_FWD, cs.SPLIT_BWD, cs.SPLIT_FWD_COLOR, cs.SPLIT_BWD_COLOR)
    before = [k.launches for k in kernels]
    tw = cs.split_forward(*planes, cnt, pb=pb, **kw)
    grads = cs.split_backward(*planes, cnt, g, **kw)
    colors = cs.split_forward_color(*planes, alb, cnt, pb=pb, **kw)
    grads_c = cs.split_backward_color(*planes, alb, cnt, dcol, **kw)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 1]
    f64 = [x.double() for x in (*planes, alb)]
    _gate(("tw",), (tw,), (cs.split_forward_plain(*planes, cnt, **kw),),
          (cs.split_forward_plain(*f64[:4], cnt, **kw),), 2e-5)
    _gate(SPLIT_GRADS, grads, cs.split_backward_plain(*planes, cnt, g, **kw),
          cs.split_backward_plain(*f64[:4], cnt, g.double(), **kw), 5e-5)
    _gate(("colors",), (colors,), (cs.split_forward_color_plain(*planes, alb, cnt, **kw),),
          (cs.split_forward_color_plain(*f64, cnt, **kw),), 2e-5)
    _gate(SPLIT_GRADS, grads_c, cs.split_backward_color_plain(*planes, alb, cnt, dcol, **kw),
          cs.split_backward_color_plain(*f64, cnt, dcol.double(), **kw), 5e-5)
    assert (tw[1, 37:] == 0).all() and (tw[2] == 0).all() and (colors[2] == 0).all()
    for d in (grads[2], grads_c[2], grads_c[4]):   # dsigma, dalbedo: zero past the count
        assert (d[1, 37:] == 0).all() and (d[2] == 0).all()
    assert float(grads[1][1, 37:].abs().max()) > 0   # the base path reaches every row
    for d in (*grads[:2], grads[3], *grads_c[:2], grads_c[3]):   # a dead tile's: db is 0
        assert (d[2] == 0).all()


@pytest.mark.parametrize("n", [96, 40])
def test_split_backwards_agree(n):
    """Kernel 18's VJP equals kernel 16's given g = sqrt(2/pi) co (albedo .
    dcol), the colors' cotangent of tw, as its plane: dmb, dsigma and dinv
    within 1e-6 of scale (the two sum the same terms; g is rounded apart),
    and dco differs by the colors' direct term sqrt(2/pi) tw (albedo .
    dcol) alone."""
    from sgrt_tpu_torch.ops import cuda_split as cs

    dev = _card()
    mb, co, sig, inv, alb, cnt = _planes(dev, n=n)
    planes = (mb, co, sig, inv)
    dcol = torch.randn((4, 3, 200), generator=torch.Generator().manual_seed(4)).to(dev)
    A = torch.einsum("bnc,bcr->bnr", alb, dcol)
    g = (0.7978845608028654 * co * A).contiguous()
    tw = cs.split_forward(*planes, cnt)
    g16 = cs.split_backward(*planes, cnt, g)
    g18 = cs.split_backward_color(*planes, alb, cnt, dcol)
    torch.cuda.synchronize()
    for name, a, b in zip(("dmb", "dsigma", "dinv"), (g16[0], g16[2], g16[3]),
                          (g18[0], g18[2], g18[3])):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * scale, name
    direct = 0.7978845608028654 * tw * A
    scale = float(g18[1].abs().max())
    assert float((g18[1] - g16[1] - direct).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("n", [96, 40])
def test_split_forwards_agree(n):
    """Kernels 15 and 17 are one forward: tw and the colors are equal bit
    for bit at pb 8 and 16 (pb does not change the kernel); kernel 17's
    colors are within 1e-6 of scale of a float64 sum over the rows of
    albedo sqrt(2/pi) co tw from kernel 15's tw (the kernel sums the same
    rounded tw, in float32 and in another order); tw is exactly 0 past the
    count and on the dead tile."""
    from sgrt_tpu_torch.ops import cuda_split as cs

    dev = _card()
    mb, co, sig, inv, alb, cnt = _planes(dev, n=n)
    planes = (mb, co, sig, inv)
    tw8, tw16 = (cs.split_forward(*planes, cnt, pb=pb) for pb in (8, 16))
    c8, c16 = (cs.split_forward_color(*planes, alb, cnt, pb=pb) for pb in (8, 16))
    torch.cuda.synchronize()
    assert torch.equal(tw8, tw16) and torch.equal(c8, c16)
    want = torch.einsum("bnc,bnr->bcr", alb.double(),
                        0.7978845608028654 * co.double() * tw8.double())
    assert float((c8.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())
    for b, c in enumerate(cnt.tolist()):
        assert (tw8[b, min(c, n):] == 0).all()
    assert (tw8[2] == 0).all() and float(tw8[0].abs().max()) > 0


def test_split_ops_on_card():
    """tw_split and colors_split on the card: gradients from kernels 16 and
    18 equal the wrappers' (autograd adds nothing), also under the taylor
    erf; an erf name that no package has and a pb the kernels do not take
    raise."""
    from sgrt_tpu_torch.ops import cuda_split as cs

    dev = _card()
    mb, co, sig, inv, alb, cnt = _planes(dev, r=256)
    dcol = torch.randn((4, 3, 256), generator=torch.Generator().manual_seed(3)).to(dev)
    leaves = [t.clone().requires_grad_(True) for t in (mb, co, sig, inv, alb)]
    before = cs.SPLIT_BWD_COLOR.launches
    cs.colors_split(*leaves, cnt, pb=16, qb=32).backward(dcol)
    torch.cuda.synchronize()
    assert cs.SPLIT_BWD_COLOR.launches == before + 1
    want = cs.split_backward_color(mb, co, sig, inv, alb, torch.clamp(cnt, max=96), dcol)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    leaves = [t.clone().requires_grad_(True) for t in (mb, co, sig, inv, alb)]
    before = cs.SPLIT_BWD_COLOR.launches
    cs.colors_split(*leaves, cnt, pb=16, qb=32, erf_name="taylor").backward(dcol)
    torch.cuda.synchronize()
    assert cs.SPLIT_BWD_COLOR.launches == before + 1
    want = cs.split_backward_color(mb, co, sig, inv, alb, torch.clamp(cnt, max=96), dcol,
                                   erf_name="taylor")
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    with pytest.raises(ValueError, match="CUDA kernels implement"):
        cs.tw_split(mb, co, sig, inv, cnt, erf_name="erfc")
    with pytest.raises(ValueError, match="pb in"):
        cs.tw_split(mb, co, sig, inv, cnt, pb=32)


@pytest.mark.parametrize("erf_name", ["as5", "as3", "taylor", "spline", "spline_mirror"])
@pytest.mark.parametrize("exp_name", ["exact", "fast", "spline"])
def test_backwards_equal_for_every_name(erf_name, exp_name):
    """For every erf and exp the kernels are built for, the recompute
    backward's T is the forward-with-T's: the saved-T and recompute fused
    backwards give equal gradients bit for bit, and the forward's colors
    equal the forward-with-T's."""
    dev = _card()
    args = _inputs(dev, n=40, counts=(40, 17, 0, 33, 1000))
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(9)).to(dev)
    kw = dict(qb=8, erf_name=erf_name, exp_name=exp_name)
    colors, t = tk.fused_forward_t(*args, pb=8, **kw)
    assert torch.equal(colors, tk.fused_forward(*args, pb=8, **kw))
    for a, b in zip(tk.fused_backward(*args, dcol, t, **kw), tk.fused_backward(*args, dcol, **kw)):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def _as5_f64(x):
    """as5's formula (A&S 7.1.26, the kernels' float32 coefficients) in
    float64 at the float32 points x: (erf, exp(-x^2))."""
    c = [float(np.float32(v)) for v in (0.3275911, 0.254829592, -0.284496736, 1.421413741,
                                        -1.453152027, 1.061405429)]
    xd = x.double()
    t = 1.0 / (1.0 + c[0] * xd.abs())
    poly = t * (c[1] + t * (c[2] + t * (c[3] + t * (c[4] + t * c[5]))))
    g = torch.exp(-xd * xd)
    return torch.sign(xd) * (1.0 - poly * g), g


def test_as5_tap_accuracy():
    """The as5 tap of every kernel (csrc/gauss_common.cuh, through the
    sgrt_as5_tap_probe entry point) against its formula in float64, over
    2^20 + 1 float32 points of [-8, 8] and the edges: |e - e64| at most
    twice the worst of the tap's IEEE form (an IEEE division and expf, the
    same probe), g within 2^-21 relative wherever exp(-x^2) >= 2^-100,
    e(0) = 0 exactly and e = +-1 exactly (x's sign) for |x| >= 4."""
    dev = _card()
    edges = [0.0, -0.0, 4.0, -4.0, 3.92, -3.92, 1e-30, -1e-30, 20.0, -20.0]
    x = torch.cat([torch.linspace(-8, 8, (1 << 20) + 1), torch.tensor(edges)]).to(dev)
    e, g, e_ieee, _ = tk.as5_tap_probe(x)
    torch.cuda.synchronize()
    e64, g64 = _as5_f64(x)
    err, err_ieee = (e.double() - e64).abs().max(), (e_ieee.double() - e64).abs().max()
    assert err <= 2 * err_ieee, (float(err), float(err_ieee))
    big = g64 >= 2.0 ** -100
    rel = ((g.double() - g64).abs() / g64)[big].max()
    assert rel <= 2.0 ** -21, float(rel)
    assert (e[x == 0] == 0).all()
    far = x.abs() >= 4
    assert torch.equal(e[far], torch.sign(x[far]))
