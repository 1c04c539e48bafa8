"""Port parity: the fused anisotropic kernels' plain versions
(sgrt_tpu_torch.ops.cuda_aniso, kernels 9-12) against the JAX package's
pallas_aniso calls, run in interpret mode on the CPU, and the
differentiable op against jax.grad of the Pallas render.

On CPU tensors the wrappers run the plain versions; the CUDA kernels are
held against those on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, derived: the exponent of co is -(C - Bt mb)/2 with C ~ |oc|^2 /
scale^2, and the two packages round C and Bt mb differently (JAX: MXU dots
and lax.rsqrt; the port: ordered elementwise sums, an IEEE square root and
division). One rounding step of C is C 2^-24 relative, so co, T and the
colors may differ by about C_max 2^-24 relative; every comparison below is
held at 4 C_max 2^-24 of the output's scale (a factor 2 for the two
roundings, 2 for accumulation), computed from the inputs. At these inputs
(|oc| <= 3.6, scale >= 0.035) that is ~1.6e-3 at most; the JAX package's
own Pallas-vs-XLA tolerance is 1e-4 (tests/test_aniso.py), where both
round alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.ops import anisotropic as jan
from sgrt_tpu.ops import pallas_aniso as jpa
from sgrt_tpu_torch.ops import anisotropic as tan
from sgrt_tpu_torch.ops import cuda_aniso as ta
from sgrt_tpu_torch.ops import cuda_kernel as tk
from sgrt_tpu_torch.ops import cuda_render as cr

FIELDS = ("mu", "scale", "magnitude", "albedo")
GRADS = ("doc", "dinvd", "dmag", "dalbedo", "ddirs")


def _inputs(b=3, n=32, r=128, counts=(32, 11, 0), seed=0):
    """oc, invd, mag, albedo, dirs_t, counts as numpy; rows past each count
    are the inert dummies tiling produces (scale 1, magnitude 0)."""
    rng = np.random.default_rng(seed)
    oc = (rng.uniform(-1, 1, (b, n, 3)) + [0.0, 0.0, 2.5]).astype(np.float32)
    scale = (rng.uniform(0.05, 0.2, (b, n, 1)) * [1.6, 0.7, 1.0]).astype(np.float32)
    mag = rng.uniform(0.1, 0.5, (b, n)).astype(np.float32)
    alb = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3, r)) * np.array([0.3, 0.3, 1.0])[None, :, None]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cnt = np.asarray(counts, np.int32)
    dead = np.arange(n)[None, :] >= np.minimum(cnt, n)[:, None]
    oc[dead], scale[dead], mag[dead], alb[dead] = 0.0, 1.0, 0.0, 0.0
    return oc, (1.0 / (scale * scale)).astype(np.float32), mag, alb, d, cnt


def _tol(oc, invd) -> float:
    """4 C_max 2^-24: the relative float32 conditioning of co (module doc)."""
    c = np.sum(oc.astype(np.float64) ** 2 * invd, axis=-1)
    return 4.0 * float(c.max()) * 2.0 ** -24


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _jax_call(fn, args, **kw):
    return fn(*(jnp.asarray(a) for a in args), rb=128, pb=8, qb=16, erf_name="as5",
              exp_name="exact", interpret=True, **kw)


def _close(got, want, tol, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("counts", [(32, 11, 0), (7, 32, 25), (48, 33, 0)])
def test_forward_plain_matches_pallas(counts):
    """N = max(32, counts): at N 48 (a multiple of the Pallas call's qb 16)
    the kernel's forward sees a partial second 32-row split."""
    n = max(32, *counts)
    args = _inputs(n=n, counts=counts)
    tol = _tol(args[0], args[1])
    want_c, want_t = _jax_call(jpa._fused_fwd_t_aniso_call, args)
    want_colors = _jax_call(jpa._fused_fwd_aniso_call, args)
    colors = ta.fused_forward_aniso(*_torch(args))
    colors_t, t = ta.fused_forward_t_aniso(*_torch(args))
    _close(colors, want_colors, tol, "colors")
    _close(colors_t, want_c, tol, "colors (forward-with-T)")
    # T on live rows: the Pallas kernel writes T for every row of its last
    # partial p block, the port's contract is T = 0 past the count
    live = np.arange(n)[None, None, :, None] < np.asarray(counts)[:, None, None, None]
    _close(np.where(live, t.numpy(), 0.0), np.where(live, np.asarray(want_t), 0.0), tol, "T")
    assert torch.equal(colors, colors_t)
    for b, c in enumerate(counts):
        assert (t[b, :, c:] == 0).all()          # dead rows hold exactly T = 0
        if c == 0:
            assert (colors[b] == 0).all()


@pytest.mark.parametrize("saved_t", [True, False])
def test_backward_plain_matches_pallas(saved_t):
    """The five gradients of both backwards against the Pallas calls; dead
    rows and the dead tile exactly zero; saved-T equals recompute."""
    args = _inputs()
    tol = _tol(args[0], args[1])
    dcol = np.random.default_rng(3).normal(size=(3, 3, 128)).astype(np.float32)
    targs = _torch(args)
    if saved_t:
        _, jt = _jax_call(jpa._fused_fwd_t_aniso_call, args)
        want = _jax_call(jpa._fused_bwd_t_aniso_call, args + (np.asarray(jt), dcol))
        t = ta.fused_forward_t_aniso(*targs)[1]
        got = ta.fused_backward_aniso(*targs, torch.from_numpy(dcol), t)
    else:
        want = _jax_call(jpa._fused_bwd_aniso_call, args + (dcol,))
        got = ta.fused_backward_aniso(*targs, torch.from_numpy(dcol))
    for name, a, b in zip(GRADS, got, want):
        _close(a, b, tol, name)
    for g in got[:4]:
        assert (g[2] == 0).all() and (g[1, 11:] == 0).all()
    assert (got[4][2] == 0).all()
    other = ta.fused_backward_aniso(*targs, torch.from_numpy(dcol),
                                    None if saved_t else ta.fused_forward_t_aniso(*targs)[1])
    for a, b in zip(got, other):
        assert torch.equal(a, b)


def test_plain_backward_is_the_forward_vjp():
    """float64: the plain backward is the VJP of the plain forward (autograd
    through fused_forward_aniso_plain), and gradcheck holds, at a tiny size.
    With the exact erf: the backward takes erf' = 2/sqrt(pi) exp(-x^2), the
    exact derivative of erf, not of the A&S polynomial."""
    args = [torch.from_numpy(a).double() if a.dtype == np.float32 else torch.from_numpy(a)
            for a in _inputs(b=2, n=8, r=16, counts=(8, 5))]
    dcol = torch.randn((2, 3, 16), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    leaves = [a.clone().requires_grad_(True) for a in args[:5]]
    out = ta.fused_forward_aniso_plain(*leaves, args[5], erf_name="exact")
    auto = torch.autograd.grad(out, leaves, dcol)
    got = ta.fused_backward_aniso_plain(*args, dcol, erf_name="exact")
    for name, a, b in zip(GRADS, got, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12, err_msg=name)

    def f(oc, invd, mag, alb, d):
        return ta.fused_forward_aniso_plain(oc, invd, mag, alb, d, args[5], erf_name="exact")

    assert torch.autograd.gradcheck(f, tuple(leaves), eps=1e-6, atol=1e-6)


def test_fused_op_gradients_match_jax_grad():
    """The one op's gradients to mu, scale, magnitude and albedo over
    anisotropic rows, through the flat-ray front door (invd = scale^-2
    chained by autograd), against jax.grad of render_rays_pallas_aniso_impl;
    both geometries at one chunk and chunked differentiate through that one
    op."""
    from sgrt_tpu.models.camera import Camera as JCamera

    rng = np.random.default_rng(7)
    n = 8
    mu = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    mu[:, 2] = rng.uniform(0.5, 1.5, n)
    fields = (mu, rng.uniform(0.08, 0.4, (n, 3)).astype(np.float32),
              rng.uniform(0.5, 1.5, n).astype(np.float32),
              rng.uniform(0, 1, (n, 3)).astype(np.float32))
    cam = JCamera.create(position=(0.0, 0.0, -2.5), width=16, height=16)
    o, dirs = (np.asarray(x) for x in cam.rays())

    def jloss(s):
        c = jpa.render_rays_pallas_aniso_impl(jnp.asarray(o), jnp.asarray(dirs), s,
                                              interpret=True)
        return jnp.sum(c ** 2)

    jg = jax.grad(jloss)(jan.AnisoScene(*(jnp.asarray(f) for f in fields)))
    scene = tan.aniso_scene_from_numpy(*fields, device="cpu")
    leaves = {f: getattr(scene, f).clone().requires_grad_(True) for f in FIELDS}
    c = cr.render_rays(torch.from_numpy(o), torch.from_numpy(dirs), tan.AnisoScene(**leaves))
    torch.sum(c ** 2).backward()
    tol = 4.0 * float(np.max(np.sum((mu - o) ** 2 / fields[1] ** 2, axis=-1))) * 2.0 ** -24
    for f in FIELDS:
        _close(leaves[f].grad, getattr(jg, f), 4 * tol, f)
    for geometry, shape in ((cr.ISO, (1, 128)), (cr.ANISO, (1, 128, 3))):
        for ck in (None, 128):
            ops = (torch.zeros(1, 128, 3), torch.ones(shape), torch.zeros(1, 128),
                   torch.zeros(1, 128, 3), torch.ones(1, 3, 8))
            out = cr.render_batched(*(t.requires_grad_(True) for t in ops), geometry=geometry,
                                    ck=ck)
            assert type(out.grad_fn) is cr.TileRender._backward_cls, (geometry.scene, ck)


def test_tiles_render_matches_pallas_tiles():
    """The per-tile front door on an anisotropic tile against
    render_tiles_pallas_aniso on one padded tile with counts below K."""
    rng = np.random.default_rng(2)
    k, live = 16, 9
    mu = np.zeros((k, 3), np.float32)
    scale = np.ones((k, 3), np.float32)
    mag, alb = np.zeros(k, np.float32), np.zeros((k, 3), np.float32)
    mu[:live] = rng.uniform(-0.5, 0.5, (live, 3)) + [0.0, 0.0, 1.0]
    scale[:live] = rng.uniform(0.1, 0.3, (live, 3))
    mag[:live], alb[:live] = rng.uniform(0.5, 1.5, live), rng.uniform(0, 1, (live, 3))
    o = np.array([0.0, 0.0, -2.5], np.float32)
    d = rng.normal(size=(1, 128, 3)) * [0.2, 0.2, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    counts = np.array([live], np.int32)
    jt = jan.AnisoScene(*(jnp.asarray(x[None]) for x in (mu, scale, mag, alb)))
    want = jpa.render_tiles_pallas_aniso(jt, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(counts), pb=8, qb=8, interpret=True)
    tt = tan.AnisoScene(*(torch.from_numpy(x[None]) for x in (mu, scale, mag, alb)))
    got = cr.render_tiles(tt, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(counts),
                          pb=8, qb=8)
    tol = 4.0 * float(np.max(np.sum((mu[:live] - o) ** 2 / scale[:live] ** 2, -1))) * 2.0 ** -24
    _close(got, want, tol)


@pytest.mark.parametrize("kernel,symbol,line", [
    (ta.FUSED_BWD_T_ANISO, "sgrt_fused_bwd_t_aniso", 292),
    (ta.FUSED_BWD_ANISO, "sgrt_fused_bwd_aniso", 367),
    (tk.FUSED_BWD_T, "sgrt_fused_bwd_t", 948),
    (tk.FUSED_BWD, "sgrt_fused_bwd", 1073),
])
def test_fused_backwards_are_chunked_entry_points(kernel, symbol, line):
    """The fused backwards (kernels 3-4 over isotropic rows, 11-12 over
    anisotropic ones) are entry points of csrc/chunked.cu, the chunked
    backward at one chunk: each names its source, its symbol, the Pallas
    kernel it replaces, and times its parts (it takes part_ms, as the
    chunked backwards do)."""
    import re

    aniso = symbol.endswith("_aniso")
    tpu = "pallas_aniso.py" if aniso else "pallas_kernel.py"
    assert kernel.source.name == "chunked.cu"
    assert kernel.symbol == symbol
    assert kernel.replaces == f"sgrt_tpu/ops/{tpu}:{line}"
    assert kernel.timed
    src = kernel.source.read_text()
    assert re.search(rf"^int {symbol}\(", src, re.M), symbol
    body = src[src.index(f"int {symbol}("):]
    body = body[:body.index("\n}\n")]
    geo = "AnisoGeo" if aniso else "IsoGeo"
    assert f"launch_bwd<{geo}" in body and "if (ck != N)" in body


@pytest.mark.parametrize("kernel,symbol,line", [
    (ta.FUSED_FWD_ANISO, "sgrt_fused_fwd_aniso", 145),
    (ta.FUSED_FWD_T_ANISO, "sgrt_fused_fwd_t_aniso", 248),
    (tk.FUSED_FWD, "sgrt_fused_fwd", 862),
    (tk.FUSED_FWD_T, "sgrt_fused_fwd_t", 898),
])
def test_fused_aniso_forwards_are_chunked_entry_points(kernel, symbol, line):
    """The fused forwards (kernels 1-2 over isotropic rows, 9-10 over
    anisotropic ones) are entry points of csrc/chunked.cu, its forward at
    one chunk: each names its source, its symbol and the Pallas kernel it
    replaces, and its body runs launch_fwd<IsoGeo, ...> or
    launch_fwd<AnisoGeo, ...>."""
    import re

    aniso = symbol.endswith("_aniso")
    tpu = "pallas_aniso.py" if aniso else "pallas_kernel.py"
    assert kernel.source.name == "chunked.cu"
    assert kernel.symbol == symbol
    assert kernel.replaces == f"sgrt_tpu/ops/{tpu}:{line}"
    src = kernel.source.read_text()
    assert re.search(rf"^int {symbol}\(", src, re.M), symbol
    body = src[src.index(f"int {symbol}("):]
    body = body[:body.index("\n}\n")]
    geo = "AnisoGeo" if aniso else "IsoGeo"
    assert f"launch_fwd<{geo}" in body


def test_fused_fwd_cu_keeps_only_the_isotropic_forwards():
    """csrc/fused_fwd.cu, which last held the isotropic fused forwards
    (kernels 1-2), and csrc/split.cu, which last held the split forwards
    (kernels 15 and 17), are gone: no source of the port is either file, and
    all 20 renderer kernels of ops.kernels.KERNELS are entry points of
    csrc/chunked.cu, the port's one renderer source; the 21st, the tiling
    kernel, is csrc/tiling.cu's."""
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.ops.cuda_tiling import TILE_COMPACT
    from sgrt_tpu_torch.utils import nvcc

    for gone in ("fused_fwd.cu", "split.cu"):
        assert not (nvcc.CSRC_DIR / gone).exists()
        assert all(k.source.name != gone for k in kernels.KERNELS)
    assert len(kernels.KERNELS) == 21 and kernels.KERNELS[-1] is TILE_COMPACT
    assert all(k.source.name == "chunked.cu" for k in kernels.KERNELS[:20])
    assert TILE_COMPACT.source.name == "tiling.cu"
    assert sorted(p.name for p in nvcc.CSRC_DIR.glob("*.cu")) == ["chunked.cu", "tiling.cu"]


def test_fused_bwd_cu_keeps_only_the_isotropic_kernels():
    """csrc/fused_bwd.cu, which last held the isotropic fused backwards
    (kernels 3-4), is gone: no source of the port is that file and no kernel
    of ops.kernels.KERNELS names it; every backward of the port, the split
    ones too, is an entry point of csrc/chunked.cu."""
    from sgrt_tpu_torch.ops import kernels
    from sgrt_tpu_torch.utils import nvcc

    assert not (nvcc.CSRC_DIR / "fused_bwd.cu").exists()
    assert all(k.source.name != "fused_bwd.cu" for k in kernels.KERNELS)
    from sgrt_tpu_torch.ops import cuda_split as ts

    for k in (tk.FUSED_BWD_T, tk.FUSED_BWD, ta.FUSED_BWD_T_ANISO, ta.FUSED_BWD_ANISO,
              ts.SPLIT_BWD, ts.SPLIT_BWD_COLOR):
        assert k in kernels.KERNELS and k.source.name == "chunked.cu"


@pytest.mark.parametrize("name,symbol,line", [("SPLIT_BWD", "sgrt_split_bwd", 256),
                                              ("SPLIT_BWD_COLOR", "sgrt_split_bwd_color", 329)])
def test_split_backwards_are_chunked_entry_points(name, symbol, line):
    """The split backwards (kernels 16 and 18) are csrc/chunked.cu's
    recompute backward at one chunk over plane rows: each names its source,
    its symbol and the Pallas kernel it replaces, its body runs
    launch_bwd<PlaneGeo, false> with ck = N, and csrc/split.cu, which held
    them before, is gone."""
    import re

    from sgrt_tpu_torch.ops import cuda_split as ts

    kernel = getattr(ts, name)
    assert kernel.source.name == "chunked.cu" and kernel.timed
    assert kernel.symbol == symbol
    assert kernel.replaces == f"sgrt_tpu/ops/pallas_kernel.py:{line}"
    src = kernel.source.read_text()
    assert re.search(rf"^int {symbol}\(", src, re.M), symbol
    body = src[src.index(f"int {symbol}("):]
    body = body[:body.index("\n}\n")]
    assert "launch_bwd<PlaneGeo, false>" in body and "B, N, R, N, threads" in body
    assert not (kernel.source.parent / "split.cu").exists()


@pytest.mark.parametrize("name,symbol,line",
                         [("SPLIT_FWD", "sgrt_split_fwd", 181),
                          ("SPLIT_FWD_COLOR", "sgrt_split_fwd_color", 213)])
def test_split_forwards_are_chunked_entry_points(name, symbol, line):
    """The split forwards (kernels 15 and 17) are csrc/chunked.cu's forward
    at one chunk over plane rows: each names its source, its symbol and the
    Pallas kernel it replaces, its body runs launch_fwd<PlaneGeo, ...> with
    the planes' Args (the tw store for kernel 15, the colors alone for 17),
    and fwd_kernel is the kernel that launch_fwd launches."""
    import re

    from sgrt_tpu_torch.ops import cuda_split as ts
    from sgrt_tpu_torch.ops import kernels

    kernel = getattr(ts, name)
    assert kernel in kernels.KERNELS and not kernel.timed
    assert kernel.source.name == "chunked.cu" and kernel.symbol == symbol
    assert kernel.replaces == f"sgrt_tpu/ops/pallas_kernel.py:{line}"
    src = kernel.source.read_text()
    assert re.search(rf"^int {symbol}\(", src, re.M), symbol
    body = src[src.index(f"int {symbol}("):]
    body = body[:body.index("\n}\n")]
    store = "kStoreTw" if name == "SPLIT_FWD" else "kStoreNone"
    assert f"launch_fwd<PlaneGeo, {store}>" in body and "PlaneGeo::Args in{" in body
    assert "stream, in)" in body
    launch = src[src.index("int launch_fwd("):]
    launch = launch[:launch.index("\n}\n")]
    pick = src[src.index("FwdKernel<Geo> pick_fwd("):]
    pick = pick[:pick.index("\n}\n")]
    assert "pick_fwd<Geo, STORE>" in launch and "fwd_kernel<Geo, ERF, EXP, STORE>" in pick
