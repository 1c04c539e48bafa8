"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test decides inside itself whether a CUDA device is
present and skips without one, so every pytest worker collects the same
tests. Run on a machine with the card (--noconftest: tests/conftest.py
imports JAX, which the port's machine need not have):

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

Tolerances are the JAX package's (tests/test_pallas.py): 2e-5 for colors
and T, 5e-5 of each field's max |value| for gradients. The kernels round
the Gaussian exponent's inputs exactly as the plain versions do
(csrc/gauss_common.cuh), so the two differ only by summation order.
"""

import numpy as np
import pytest
import torch

from sgrt_tpu_torch.models.gaussians import grid_scene
from sgrt_tpu_torch.ops import cuda_kernel as tk
from sgrt_tpu_torch.ops.frame import render_orbit_frame

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("erf_name,exp_name,pb,qb", [
    ("as5", "exact", 8, 32), ("as5", "exact", 16, 16), ("as3", "fast", 8, 32),
])
def test_kernel_matches_plain(erf_name, exp_name, pb, qb):
    args = _inputs(_card())
    before = tk.FUSED_FWD.launches
    out = tk.fused_forward(*args, pb=pb, qb=qb, erf_name=erf_name, exp_name=exp_name)
    torch.cuda.synchronize()
    assert tk.FUSED_FWD.launches == before + 1
    ref = tk.fused_forward_plain(*args, erf_name=erf_name, exp_name=exp_name)
    assert torch.isfinite(out).all()
    assert (out[2] == 0).all()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=2e-5)


GRAD_NAMES = ("oc", "sigma", "mag", "albedo", "dirs")


def _assert_grads_close(got, want, rel=5e-5):
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert torch.isfinite(a).all(), name
        scale = max(float(b.abs().max()), 1e-8)
        np.testing.assert_allclose(a.cpu().numpy() / scale, b.cpu().numpy() / scale,
                                   atol=rel, err_msg=name)


def test_kernel_refuses_grad_and_unported_names():
    """On the card, gradients of render_fused come from the backward
    kernels and equal the plain backward's; unported erf names raise."""
    dev = _card()
    args = _inputs(dev, r=256)
    dcol = torch.randn((5, 3, 256), generator=torch.Generator().manual_seed(3)).to(dev)
    want = tk.fused_backward_plain(*args, dcol)
    for save_t, kernel in ((True, tk.FUSED_BWD_T), (False, tk.FUSED_BWD)):
        leaves = [a.clone().requires_grad_(True) for a in args[:5]]
        before = kernel.launches
        tk.render_fused(*leaves, args[5], pb=8, qb=32, save_t=save_t).backward(dcol)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        _assert_grads_close([t.grad for t in leaves], want)
    with pytest.raises(ValueError, match="erf"):
        tk.fused_forward(*args, erf_name="spline")
    with pytest.raises(ValueError, match="erf"):
        tk.fused_backward(*args, dcol, erf_name="spline")


@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast")])
def test_forward_t_kernel_matches_plain(erf_name, exp_name):
    args = _inputs(_card())
    before = tk.FUSED_FWD_T.launches
    colors, t = tk.fused_forward_t(*args, erf_name=erf_name, exp_name=exp_name)
    torch.cuda.synchronize()
    assert tk.FUSED_FWD_T.launches == before + 1
    ref_c, ref_t = tk.fused_forward_t_plain(*args, erf_name=erf_name, exp_name=exp_name)
    np.testing.assert_allclose(colors.cpu().numpy(), ref_c.cpu().numpy(), atol=2e-5)
    np.testing.assert_allclose(t.cpu().numpy(), ref_t.cpu().numpy(), atol=2e-5)
    counts = [96, 17, 0, 40, 96]
    for b, c in enumerate(counts):
        assert (t[b, :, c:] == 0).all()     # dead rows hold exactly T = 0
    plain = tk.fused_forward(*args, erf_name=erf_name, exp_name=exp_name)
    np.testing.assert_allclose(colors.cpu().numpy(), plain.cpu().numpy(), atol=1e-6)


@pytest.mark.parametrize("saved_t", [True, False])
@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast")])
def test_backward_kernels_match_plain(saved_t, erf_name, exp_name):
    """Both backwards at R = 200 (two ray blocks, the second partial) and
    counts (96, 17, 0, 40, >N): per-ray-block partials summed in order, dead
    rows exactly zero."""
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
    _assert_grads_close(got, tk.fused_backward_plain(*args, dcol, t, **kw))
    for g in got[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 40:] == 0).all()
    assert (got[4][2] == 0).all()


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


@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast")])
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


@pytest.mark.parametrize("saved_t", [True, False])
@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast")])
def test_chunked_backward_kernels_match_plain(saved_t, erf_name, exp_name):
    """Both chunked backwards at R = 200 (two ray blocks, the second
    partial): q-side sums carried over three p chunks, dead rows and the
    dead tile exactly zero."""
    from sgrt_tpu_torch.ops import cuda_chunked as tc

    dev = _card()
    args = _inputs(dev, n=384, counts=CHUNK_COUNTS)
    dcol = torch.randn((5, 3, 200), generator=torch.Generator().manual_seed(7)).to(dev)
    kw = dict(ck=128, erf_name=erf_name, exp_name=exp_name)
    t = tc.chunked_forward_t(*args, **kw)[1] if saved_t else None
    kernel = tc.CHUNKED_BWD_T if saved_t else tc.CHUNKED_BWD
    before = kernel.launches
    got = tc.chunked_backward(*args, dcol, t, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _assert_grads_close(got, tc.chunked_backward_plain(*args, dcol, t, **kw))
    for g in got[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 200:] == 0).all()
    assert (got[4][2] == 0).all()


def test_chunked_route_on_card():
    """render_fused_chunked's gradients on the card come from the chunked
    backward kernels (both schedules) and equal the plain backward's; the
    chunked and fused forwards agree on the same inputs."""
    from sgrt_tpu_torch.ops import cuda_chunked as tc

    dev = _card()
    args = _inputs(dev, n=384, r=256, counts=CHUNK_COUNTS)
    dcol = torch.randn((5, 3, 256), generator=torch.Generator().manual_seed(8)).to(dev)
    want = tc.chunked_backward_plain(*args, dcol, ck=128)
    for save_t, kernel in ((True, tc.CHUNKED_BWD_T), (False, tc.CHUNKED_BWD)):
        leaves = [a.clone().requires_grad_(True) for a in args[:5]]
        before = kernel.launches
        tc.render_fused_chunked(*leaves, args[5], ck=128, save_t=save_t).backward(dcol)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        _assert_grads_close([x.grad for x in leaves], want)
    fused = tk.fused_forward(*args)
    np.testing.assert_allclose(tc.chunked_forward(*args, ck=128).cpu().numpy(),
                               fused.cpu().numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="erf"):
        tc.chunked_forward(*args, ck=128, erf_name="spline")


# the anisotropic kernels (csrc/fused_fwd.cu, csrc/fused_bwd.cu over AnisoGeo
# rows): _inputs' rows with per-axis scales sigma * (1.6, 0.7, 1.0), the
# stretched teapot cell's multipliers
def _aniso_inputs(dev, **kw):
    oc, sig, mag, alb, d, cnt = _inputs(dev, **kw)
    scale = sig[..., None] * torch.tensor([1.6, 0.7, 1.0], device=dev)
    return [oc, (1.0 / (scale * scale)).contiguous(), mag, alb, d, cnt]


@pytest.mark.parametrize("erf_name,exp_name,pb,qb", [
    ("as5", "exact", 8, 32), ("as5", "exact", 16, 16), ("as3", "fast", 8, 32),
])
def test_aniso_forward_kernels_match_plain(erf_name, exp_name, pb, qb):
    from sgrt_tpu_torch.ops import cuda_aniso as ta

    args = _aniso_inputs(_card())
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
    for b, c in enumerate((96, 17, 0, 40, 96)):
        assert (t[b, :, c:] == 0).all()
    assert (out[2] == 0).all()


@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast")])
def test_aniso_backward_kernels_match_plain(erf_name, exp_name):
    """Both anisotropic backwards at R = 200 (two ray blocks, the second
    partial): within 5e-5 of scale of the plain backward, equal to each
    other bit for bit (the recompute's pass A is the forward's), dead rows
    and the dead tile exactly zero."""
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
    _assert_grads_close(g_t, ta.fused_backward_aniso_plain(*args, dcol, **kw))
    for a, b in zip(g_t, g_r):
        assert torch.equal(a, b)
    for g in g_t[:4]:
        assert (g[2] == 0).all() and (g[1, 17:] == 0).all() and (g[3, 40:] == 0).all()
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


# the chunked anisotropic kernels (kernel 13: the anisotropic forward's entry
# point with its own launch count; kernel 14: csrc/chunked_bwd.cu over
# AnisoGeo rows) on _aniso_inputs' rows at N = 384 in three chunks of 128:
# CHUNK_COUNTS give a tile with all three chunks live, one whose only live
# chunk is partly live (17), a dead tile, one whose second chunk is partly
# live (200) and one clamped to N; R = 200 is two ray blocks, the second
# partial. Kernel 14 forms doc and dinvd from sums that do not cancel (its
# source note), so its gradients are held against a float64 run of the
# plain version: as close to it as the float32 plain version is, x2, or
# within the JAX package's 5e-5 of scale.
def _double(args):
    return [x.double() if x.is_floating_point() else x for x in args]


def _assert_grads_f64_gate(got, plain, ref, rel=5e-5):
    for name, a, p, f in zip(GRAD_NAMES, got, plain, ref):
        assert torch.isfinite(a).all(), name
        scale = max(float(f.abs().max()), 1e-30)
        e_k = float((a.double() - f).abs().max()) / scale
        e_p = float((p.double() - f).abs().max()) / scale
        assert e_k <= max(rel, 2 * e_p), (name, e_k, e_p)


@pytest.mark.parametrize("erf_name,exp_name", [("as5", "exact"), ("as3", "fast")])
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


def test_chunked_aniso_route_on_card():
    """render_fused_chunked_aniso's gradients on the card come from the
    chunked anisotropic backward and agree with the plain backward; its
    forward is the fused anisotropic forward's kernel, so the colors are
    equal bit for bit; a chunk size that does not divide N raises."""
    from sgrt_tpu_torch.ops import cuda_aniso as ta
    from sgrt_tpu_torch.ops import cuda_chunked_aniso as tca

    dev = _card()
    args = _aniso_inputs(dev, n=384, r=256, counts=CHUNK_COUNTS)
    dcol = torch.randn((5, 3, 256), generator=torch.Generator().manual_seed(6)).to(dev)
    leaves = [a.clone().requires_grad_(True) for a in args[:5]]
    before = tca.CHUNKED_BWD_ANISO.launches
    tca.render_fused_chunked_aniso(*leaves, args[5], ck=128).backward(dcol)
    torch.cuda.synchronize()
    assert tca.CHUNKED_BWD_ANISO.launches == before + 1
    _assert_grads_f64_gate([x.grad for x in leaves],
                           tca.chunked_backward_aniso_plain(*args, dcol, ck=128),
                           tca.chunked_backward_aniso_plain(*_double(args), dcol.double(), ck=128))
    assert torch.equal(tca.chunked_forward_aniso(*args, ck=128), ta.fused_forward_aniso(*args))
    with pytest.raises(ValueError, match="chunks"):
        tca.chunked_backward_aniso(*args, dcol, ck=256)


# the split kernels (15-18, csrc/split.cu) on seeded planes: co non-zero on
# every row (base runs over all N), counts with a partial block, a dead tile
# and one clamped to N; R = 200 is two ray blocks, the second partial. The
# outputs are held against a float64 run of the plain versions as above
# (_assert_grads_f64_gate): as close to it as the float32 plain version is,
# x2, or within 2e-5 (tw, colors) and 5e-5 (gradients) of scale.
SPLIT_COUNTS = (96, 37, 0, 1000)
SPLIT_GRADS = ("dmb", "dco", "dsigma", "dinv", "dalbedo")


def _planes(dev, b=4, n=96, r=200, seed=0):
    g = torch.Generator().manual_seed(seed)
    mb = torch.randn((b, n, r), generator=g)
    co = torch.rand((b, n, r), generator=g) * 0.05
    sig = torch.rand((b, n), generator=g) * 0.3 + 0.3
    inv = 1.0 / (1.4142135623730951 * sig)
    alb = torch.rand((b, n, 3), generator=g)
    cnt = torch.tensor(SPLIT_COUNTS, dtype=torch.int32)
    return [t.to(dev).contiguous() for t in (mb, co, sig, inv, alb, cnt)]


def _gate(names, got, plain, ref, rel):
    for name, a, p, f in zip(names, got, plain, ref):
        assert torch.isfinite(a).all(), name
        scale = max(float(f.abs().max()), 1e-30)
        e_k = float((a.double() - f).abs().max()) / scale
        e_p = float((p.double() - f).abs().max()) / scale
        assert e_k <= max(rel, 2 * e_p), (name, e_k, e_p)


@pytest.mark.parametrize("erf_name,exp_name,pb", [("as5", "exact", 16), ("as5", "exact", 8),
                                                  ("as3", "fast", 16)])
def test_split_kernels_match_plain(erf_name, exp_name, pb):
    from sgrt_tpu_torch.ops import cuda_split as cs

    dev = _card()
    mb, co, sig, inv, alb, cnt = _planes(dev)
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


def test_split_ops_on_card():
    """tw_split and colors_split on the card: gradients from kernels 16 and
    18 equal the wrappers' (autograd adds nothing), and names the kernels
    do not implement raise."""
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
    with pytest.raises(ValueError, match="CUDA kernels implement"):
        cs.tw_split(mb, co, sig, inv, cnt, erf_name="taylor")
    with pytest.raises(ValueError, match="pb in"):
        cs.tw_split(mb, co, sig, inv, cnt, pb=32)
