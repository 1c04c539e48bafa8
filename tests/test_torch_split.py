"""Port parity: the split ops (sgrt_tpu_torch.ops.cuda_split: tw_split,
colors_split, prep_terms_t) against the JAX package's tw_pallas,
colors_pallas and _prep_terms_T, Pallas in interpret mode on the CPU; and
the mirrors of tests/test_pallas.py's counts-prefix (:69), tiled
finite-difference (:215) and fit-step (:255) tests on the port.

On CPU tensors the wrappers run the kernels' plain versions; the CUDA
kernels are held against those on the card (tests/test_torch_cuda.py and
chip_smoke.py).

The port bounds tw and acc_k by the count, where the Pallas kernels work
in whole p and q blocks (see ops/cuda_split.py), so the cases with
non-zero co past the count take counts that are multiples of pb and qb:
there both compute the same function, base over every row included.
Tolerances are tests/test_pallas.py's: tw on live rows at rtol = atol =
2e-5 (:86-89), colors at 2e-5 absolute, and every gradient entry on every
row at 1e-5 of the output's largest magnitude (:183-186).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgrt_tpu  # noqa: F401
from sgrt_tpu.models.gaussians import GaussianScene as JScene
from sgrt_tpu.ops import pallas_kernel as jpk
from sgrt_tpu_torch.models.gaussians import GaussianScene, grid_scene
from sgrt_tpu_torch.ops import cuda_split as cs

B, N, R, RB = 2, 64, 128, 64   # two ray blocks
GRAD_REL = 1e-5
# cases that share blocks and names share one compiled Pallas function
CASES = {
    "prefix_coeff_past_count": dict(counts=(32, 48), pb=16, qb=16),
    "counts_none": dict(counts=None, pb=16, qb=16),
    "counts_over_n": dict(counts=(100, 64), pb=16, qb=16),
    "count_zero": dict(counts=(0, 32), pb=16, qb=16),
    "as3_fast": dict(counts=(32, 64), pb=8, qb=32, erf="as3", exp="fast"),
}


def _planes(seed=0, n=N, r=R):
    """mb, co (B,n,r), sigma, inv (B,n), albedo (B,n,3): co is non-zero on
    every row, past the count too."""
    rng = np.random.default_rng(seed)
    mb = rng.normal(0, 1, (B, n, r)).astype(np.float32)
    co = rng.uniform(0, 0.05, (B, n, r)).astype(np.float32)
    sig = rng.uniform(0.3, 0.6, (B, n)).astype(np.float32)
    inv = (1.0 / (np.sqrt(2.0) * sig)).astype(np.float32)
    alb = rng.uniform(0, 1, (B, n, 3)).astype(np.float32)
    return mb, co, sig, inv, alb


def _live(counts, n=N):
    cnt = np.full(B, n) if counts is None else np.minimum(counts, n)
    return np.arange(n)[None, :] < cnt[:, None]


@functools.lru_cache(maxsize=None)
def _pallas_vjp(colors, with_counts, pb, qb, erf, exp):
    """jit of (args, counts, cotangent) → (output, its VJP) through
    colors_pallas or tw_pallas."""
    op = jpk.colors_pallas if colors else jpk.tw_pallas

    def run(args, counts, ct):
        f = lambda *a: op(*a, counts if with_counts else None, rb=RB, pb=pb, qb=qb,  # noqa: E731
                          erf_name=erf, exp_name=exp, interpret=True)
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)

    return jax.jit(run)


def _port_vjp(op, args, counts, ct, pb, qb, erf, exp):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    cnt = None if counts is None else torch.tensor(counts, dtype=torch.int32)
    out = op(*leaves, cnt, rb=RB, pb=pb, qb=qb, erf_name=erf, exp_name=exp)
    out.backward(torch.from_numpy(ct))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _assert_grads(got, want, names):
    for name, a, w in zip(names, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a, w, atol=GRAD_REL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tw_split_matches_pallas(case):
    c = CASES[case]
    erf, exp = c.get("erf", "as5"), c.get("exp", "exact")
    mb, co, sig, inv, _ = _planes()
    live = _live(c["counts"])
    g = np.random.default_rng(1).normal(size=(B, N, R)).astype(np.float32)
    g = np.where(live[..., None], g, 0.0).astype(np.float32)   # zero past the count
    cnt = jnp.asarray(np.zeros(B, np.int32) if c["counts"] is None else c["counts"], jnp.int32)
    want_tw, want_g = _pallas_vjp(False, c["counts"] is not None, c["pb"], c["qb"], erf, exp)(
        tuple(jnp.asarray(a) for a in (mb, co, sig, inv)), cnt, jnp.asarray(g))
    tw, grads = _port_vjp(cs.tw_split, (mb, co, sig, inv), c["counts"], g, c["pb"], c["qb"],
                          erf, exp)
    want_tw = np.asarray(want_tw)
    np.testing.assert_allclose(tw[live], want_tw[live], rtol=2e-5, atol=2e-5)
    assert np.all(tw[~live] == 0.0)
    _assert_grads(grads, want_g, ("dmb", "dco", "dsigma", "dinv"))
    if c["counts"] is not None and min(c["counts"]) < N:
        # rows past the count: dco from the base path over every row
        assert np.abs(grads[1][~live]).max() > 0.1


@pytest.mark.parametrize("case", sorted(CASES))
def test_colors_split_matches_pallas(case):
    c = CASES[case]
    erf, exp = c.get("erf", "as5"), c.get("exp", "exact")
    args = _planes(seed=2)
    dcol = np.random.default_rng(3).normal(size=(B, 3, R)).astype(np.float32)
    cnt = jnp.asarray(np.zeros(B, np.int32) if c["counts"] is None else c["counts"], jnp.int32)
    want_c, want_g = _pallas_vjp(True, c["counts"] is not None, c["pb"], c["qb"], erf, exp)(
        tuple(jnp.asarray(a) for a in args), cnt, jnp.asarray(dcol))
    colors, grads = _port_vjp(cs.colors_split, args, c["counts"], dcol, c["pb"], c["qb"], erf,
                              exp)
    assert colors.shape == (B, 3, R)
    np.testing.assert_allclose(colors, np.asarray(want_c), atol=2e-5)
    _assert_grads(grads, want_g, ("dmb", "dco", "dsigma", "dinv", "dalbedo"))


@pytest.mark.parametrize("colors", [False, True], ids=["tw", "colors"])
def test_split_vjps_match_pallas_one_partial_block(colors):
    """N = 40 at pb = qb = 8: the shape of the CUDA backwards' one partial
    64-row block, at which tests/test_torch_cuda.py holds the kernels
    against these plain versions. Counts (40, 16): a full tile, and one
    whose rows past the count carry co (a multiple of pb and qb, so Pallas
    and the port compute the same function); one ray block of 64."""
    n, r = 40, RB
    args = _planes(seed=7, n=n, r=r)
    counts = (40, 16)
    live = _live(counts, n)
    rng = np.random.default_rng(8)
    if colors:
        ct = rng.normal(size=(B, 3, r)).astype(np.float32)
    else:
        ct = np.where(live[..., None], rng.normal(size=(B, n, r)), 0.0).astype(np.float32)
        args = args[:4]
    want, want_g = _pallas_vjp(colors, True, 8, 8, "as5", "exact")(
        tuple(jnp.asarray(a) for a in args), jnp.asarray(counts, jnp.int32), jnp.asarray(ct))
    got, grads = _port_vjp(cs.colors_split if colors else cs.tw_split, args, counts, ct, 8, 8,
                           "as5", "exact")
    want = np.asarray(want)
    if colors:
        np.testing.assert_allclose(got, want, atol=2e-5)
    else:
        np.testing.assert_allclose(got[live], want[live], rtol=2e-5, atol=2e-5)
    _assert_grads(grads, want_g, ("dmb", "dco", "dsigma", "dinv", "dalbedo"))
    assert np.abs(grads[1][~live]).max() > 0.1   # the base path reaches the rows past the count


def test_split_block_rules_and_names():
    """The JAX package's ValueError for blocks that do not divide the shape
    or are not multiples of 8; the plain versions take every erf/exp name."""
    mb, co, sig, inv, alb = (torch.from_numpy(a) for a in _planes())
    for kw in (dict(pb=24), dict(qb=12), dict(rb=48)):
        with pytest.raises(ValueError, match="not divisible by blocks"):
            cs.tw_split(mb, co, sig, inv, **kw)
        with pytest.raises(ValueError, match="not divisible by blocks"):
            jpk.tw_pallas(*(jnp.asarray(t.numpy()) for t in (mb, co, sig, inv)), **kw,
                          interpret=True)
        with pytest.raises(ValueError, match="not divisible by blocks"):
            cs.colors_split(mb, co, sig, inv, alb, **kw)
    out = cs.tw_split(mb[:, :16], co[:, :16], sig[:, :16], inv[:, :16], erf_name="spline",
                      exp_name="spline")
    assert out.shape == (B, 16, R) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="counts has shape"):
        cs.split_forward(mb, co, sig, inv, torch.zeros(3, dtype=torch.int32))


def _tile_scene(seed, n, live):
    """A tile of n rows, the rows past `live` inert dummies, at distance
    <= 3.5 with sigma >= 0.2 (tests/test_torch_backward.py's inputs)."""
    rng = np.random.default_rng(seed)
    mu = (rng.uniform(-1, 1, (n, 3)) + [0.0, 0.0, 2.5]).astype(np.float32)
    sig = rng.uniform(0.2, 0.4, n).astype(np.float32)
    mag = rng.uniform(0.1, 0.5, n).astype(np.float32)
    alb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    mu[live:], sig[live:], mag[live:], alb[live:] = 0.0, 1.0, 0.0, 0.0
    d = rng.normal(size=(R, 3)) * [0.3, 0.3, 1.0]
    return mu, sig, mag, alb, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_prep_terms_t_matches_pallas():
    """mb within a few ulp of |oc| (the port sums products in the kernels'
    order, XLA takes a dot); cbar and coeff within the exponent's float32
    floor, 2 ulp(|oc|^2) / (2 sigma^2) relative (< 5e-5 here); inv equal."""
    mu, sig, mag, alb, d = _tile_scene(4, N, N)
    o = np.array([0.1, -0.2, 0.0], np.float32)
    want = jpk._prep_terms_T(jnp.asarray(o), jnp.asarray(d),
                             JScene(*(jnp.asarray(a) for a in (mu, sig, mag, alb))))
    scene = GaussianScene(*(torch.from_numpy(a) for a in (mu, sig, mag, alb)))
    got = cs.prep_terms_t(torch.from_numpy(o), torch.from_numpy(d), scene)
    want = [np.asarray(w) for w in want]
    assert [tuple(t.shape) for t in got] == [(N, R)] * 3 + [(N,)]
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=4e-6 * 4.0)
    for a, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(a.numpy(), w, rtol=5e-5, atol=1e-7)
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=2e-7)


def test_split_route_matches_render_fused(count=37):
    """One tile through the split route (prep_terms_t, then colors_split)
    against the JAX package's render_fused: colors and the gradients of
    oc, sigma, mag, albedo and the ray directions at 5e-5 of each one's
    scale (tests/test_torch_backward.py's tolerance for these inputs).
    Rows past the count are inert, so a count inside a block works."""
    mu, sig, mag, alb, d = _tile_scene(5, N, count)
    dcol = np.random.default_rng(6).normal(size=(1, 3, R)).astype(np.float32)
    fields = (mu, sig, mag, alb)

    def jf(mu_, sig_, mag_, alb_, dirs_t):
        return jpk.render_fused(mu_[None], sig_[None], mag_[None], alb_[None], dirs_t,
                                jnp.asarray([count], jnp.int32), pb=8, qb=16, rb=RB,
                                interpret=True)

    want, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in fields), jnp.asarray(d.T[None]))
    want_g = vjp(jnp.asarray(dcol))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (*fields, d.T[None].copy())]
    scene = GaussianScene(*(t[None] for t in leaves[:4]))
    colors = cs.render_tiles_split(scene, torch.zeros(3), leaves[4].transpose(1, 2),
                                   torch.tensor([count], dtype=torch.int32), rb=RB, pb=8, qb=16)
    colors.transpose(1, 2).backward(torch.from_numpy(dcol))
    want = np.asarray(want)
    np.testing.assert_allclose(colors.transpose(1, 2).detach().numpy(), want,
                               atol=5e-5 * np.abs(want).max())
    for name, t, w in zip(("oc", "sigma", "mag", "albedo", "dirs"), leaves, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=5e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("erf_name", ["taylor", "spline_mirror"])
def test_split_route_vjp_without_pair_matches_saved_t(erf_name, count=37):
    """Under an erf without an (erf, gauss) pair, the split route's scene
    gradients are the one VJP of every route (ops/cuda_split.py's note: T
    from the named erf, every erf value and erf' of the cotangents from
    as5's pair): the JAX package's render_fused on its saved-T schedule,
    at 5e-5 of scale, as test_split_route_matches_render_fused. (A plain
    VJP that gives dco the named erf's value fails it under taylor.)"""
    mu, sig, mag, alb, d = _tile_scene(5, N, count)
    dcol = np.random.default_rng(6).normal(size=(1, 3, R)).astype(np.float32)
    fields = (mu, sig, mag, alb)

    def jf(mu_, sig_, mag_, alb_, dirs_t):
        return jpk.render_fused(mu_[None], sig_[None], mag_[None], alb_[None], dirs_t,
                                jnp.asarray([count], jnp.int32), pb=8, qb=16, rb=RB,
                                save_t=True, erf_name=erf_name, interpret=True)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in fields), jnp.asarray(d.T[None]))
    want_g = vjp(jnp.asarray(dcol))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (*fields, d.T[None].copy())]
    scene = GaussianScene(*(t[None] for t in leaves[:4]))
    colors = cs.render_tiles_split(scene, torch.zeros(3), leaves[4].transpose(1, 2),
                                   torch.tensor([count], dtype=torch.int32), rb=RB, pb=8, qb=16,
                                   erf_name=erf_name)
    colors.transpose(1, 2).backward(torch.from_numpy(dcol))
    for name, t, w in zip(("oc", "sigma", "mag", "albedo", "dirs"), leaves, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=5e-5 * np.abs(w).max(), err_msg=name)


def test_tw_split_counts_prefix_semantics():
    """tests/test_pallas.py:69 on the port: counts < N equal the count-free
    result on the live prefix when rows past it carry zero coeff."""
    rng = np.random.default_rng(3)
    b, r, n, count = 2, 128, 256, 100
    mb = torch.from_numpy(rng.normal(0, 1, (b, n, r)).astype(np.float32))
    co = torch.from_numpy(rng.uniform(0, 0.02, (b, n, r)).astype(np.float32))
    sig = torch.from_numpy(rng.uniform(0.2, 0.4, (b, n)).astype(np.float32))
    inv = 1.0 / (np.sqrt(2.0) * sig)
    co = co * (torch.arange(n) < count)[None, :, None]
    out = cs.tw_split(mb, co, sig, inv, torch.full((b,), count, dtype=torch.int32))
    full = cs.tw_split(mb, co, sig, inv, None)
    np.testing.assert_allclose(out[:, :count].numpy(), full[:, :count].numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.filterwarnings("ignore:Input #.* is not a double precision")
def test_frame_loss_finite_difference_gradients():
    """tests/test_pallas.py:215 on the port: finite differences through the
    tiled frame loss (tiling, gather, the kernel route, scatter-add), tile
    membership frozen outside the differentiated function. The kernel
    route's wrappers take float32 only, so float32 central differences in
    random directions (gradcheck's fast mode, as JAX's check_grads) at the
    JAX test's 2e-2."""
    from sgrt_tpu_torch.ops.cuda_render import render_tiles
    from sgrt_tpu_torch.ops.frame import orbit_camera
    from sgrt_tpu_torch.ops.render import _tile_rays
    from sgrt_tpu_torch.ops.tiling import gather_tiles, tile_indices

    scene = grid_scene(4, device="cpu")
    cam = orbit_camera(20.0, -4.0, 1.0, 32, 32, device="cpu")
    o, dirs = cam.rays()
    idx, counts = tile_indices(scene, cam.view_matrix, 2, 16)
    d = _tile_rays(dirs, 32, 32, 2)

    def loss(mu, sigma, mag, alb):
        colors = render_tiles(gather_tiles(GaussianScene(mu, sigma, mag, alb), idx), o, d,
                              counts, pb=8, qb=8)
        return torch.mean(colors ** 2)

    torch.manual_seed(0)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (scene.mu, scene.sigma, scene.magnitude, scene.albedo)]
    assert torch.autograd.gradcheck(loss, leaves, eps=1e-3, atol=2e-2, rtol=2e-2,
                                    fast_mode=True)


def test_fit_step_converges():
    """tests/test_pallas.py:255 on the port: one Adam step through the
    kernel route's VJP lowers the loss."""
    from sgrt_tpu_torch.models.camera import Camera
    from sgrt_tpu_torch.ops.cuda_render import render_rays
    from sgrt_tpu_torch.ops.render import render_rays_impl
    from sgrt_tpu_torch.parallel.fit import adam

    scene = grid_scene(4, device="cpu")
    cam = Camera.create(position=(0.0, 0.0, -4.0), width=16, height=16, device="cpu")
    o, dirs = cam.rays()
    target = render_rays_impl(o, dirs, scene, q_block=16, ray_block=256)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (scene.mu + 0.05, scene.sigma, scene.magnitude, scene.albedo)]

    def loss_fn():
        return torch.mean((render_rays(o, dirs, GaussianScene(*leaves)) - target) ** 2)

    opt = adam(5e-3)(leaves)
    l0 = loss_fn()
    l0.backward()
    opt.step()
    with torch.no_grad():
        assert float(loss_fn()) < float(l0)
