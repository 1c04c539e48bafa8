"""The frozen yardstick (benchmark/work.py and the culling it counts with):
counts equal a brute-force loop, and no share of the floor can pass 100%
against the time the peak rates allow."""

import math

import numpy as np
import pytest
from bench_helpers import ROOT  # noqa: F401  (puts the checkout on the path)

from benchmark import scenes, work
from benchmark.reference import render


def _scene(n, seed):
    return scenes.make_scene({"kind": "cube_surface", "n": n},
                             scenes.generator(seed, "cpu"), "cpu")


def _brute_counts(mu, sigma, view, tiles, focal):
    """Tile membership by loops over tiles and Gaussians, float32 scalars in
    the culling rule's order."""
    tx, ty = tiles
    f32 = np.float32
    mu, sigma, v = mu.numpy(), sigma.numpy(), view.numpy()
    counts = np.zeros(tx * ty, dtype=np.int64)
    for q in range(mu.shape[0]):
        p = [f32(f32(f32(f32(mu[q, 0] * v[i, 0]) + f32(mu[q, 1] * v[i, 1]))
                     + f32(mu[q, 2] * v[i, 2])) + v[i, 3]) for i in range(3)]
        if not p[2] >= 1.0:
            continue
        denom = f32(p[2] + f32(focal))
        m2 = [f32(f32(f32(focal) * p[0]) / denom), f32(f32(f32(focal) * p[1]) / denom)]
        sp = f32(f32(f32(focal) * sigma[q]) / denom)
        if sp < 1e-5:
            continue
        reach = f32(f32(3.3) * sp)
        for t in range(tx * ty):
            hx, hy = f32(1.0 / tx), f32(1.0 / ty)
            cx = f32(f32(-1.0 + hx) + f32(f32(2.0 * hx) * f32(t % tx)))
            cy = f32(f32(-1.0 + hy) + f32(f32(2.0 * hy) * f32(t // tx)))
            if (abs(f32(cx - m2[0])) <= f32(hx + reach)
                    and abs(f32(cy - m2[1])) <= f32(hy + reach)):
                counts[t] += 1
    return counts


@pytest.mark.parametrize("seed,angle", [(3, 0.0), (4, 37.0), (2**31 + 5, 300.0)])
def test_counts_equal_a_brute_force_loop(seed, angle):
    mu, sigma, _, _ = _scene(150, seed)
    _, view = render.orbit_view(angle, -4.0, 1.0, "cpu")
    got = render.tile_counts(mu, sigma, view, (4, 2), 1.0).numpy()
    assert np.array_equal(got, _brute_counts(mu, sigma, view, (4, 2), 1.0))
    assert got.sum() > 0


def _brute_work(counts, rays):
    fwd = bwd = 0
    rows = 0
    for c in counts:
        for _ray in range(rays):
            for _p in range(c):
                rows += 1
                for _q in range(c):
                    fwd += work.PAIR_FWD
                    bwd += work.PAIR_BWD
    return fwd + rows * work.ROW_FWD, bwd + rows * work.ROW_BWD


def test_work_equals_a_brute_force_count():
    counts = np.array([0, 3, 1, 5, 2])
    fwd, bwd = _brute_work(counts, 4)
    assert work.forward_work(counts, 4).flops == fwd
    assert work.backward_work(counts, 4).flops == bwd
    # bytes: rows' 8 floats, rays' directions and count, colors out (+ T)
    rows = counts.sum()
    assert work.forward_work(counts, 4).bytes == 4 * (8 * rows + 5 * (12 + 1) + 5 * 12)
    assert (work.forward_work(counts, 4, store_t=True).bytes
            == work.forward_work(counts, 4).bytes + 4 * 5 * rows * 4)


AS5_P = 0.3275911
AS5_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
K = np.arange(-4.0, 1.0)


def _erf_as5(x):
    t = 1.0 / (1.0 + AS5_P * np.abs(x))
    poly = sum(a * t ** (i + 1) for i, a in enumerate(AS5_A))
    return np.sign(x) * (1.0 - poly * np.exp(-x * x))


def _ray(seed, c=40):
    rng = np.random.default_rng(seed)
    return rng.uniform(1.0, 7.0, c), rng.uniform(0.03, 0.3, c), rng.uniform(0.1, 2.0, c)


def _acc_plain(mu, sigma, co):
    """sum_q co_q erf((s_pk - mu_q) / (sqrt2 sigma_q)), every tap on its own."""
    s = mu[:, None] + K[None, :] * sigma[:, None]                     # (p, k)
    x = (s[:, :, None] - mu[None, None, :]) / (np.sqrt(2.0) * sigma[None, None, :])
    return (co[None, None, :] * _erf_as5(x)).sum(axis=2)


def _acc_folded(mu, sigma, co):
    """The same sums by the folds the floors count (work.py's note): the
    argument pre-scaled for exp2 and shared by the 5 samples through a
    recurrence, t' = 1 / (|x'| + e) with the per-row factors and co_q
    folded into the polynomial's coefficients, and sgn co_q summed by a
    prefix sum over the members sorted along the ray."""
    r = np.sqrt(np.log2(np.e))
    a = r / (np.sqrt(2.0) * sigma)                     # per q
    b = a * mu                                         # per row
    e = r / AS5_P                                      # a constant
    coef = co[:, None] * np.array([ai * (r / AS5_P) ** (i + 1)
                                   for i, ai in enumerate(AS5_A)])[None, :]   # per row
    x = a[None, :] * (mu - 4 * sigma)[:, None] - b[None, :]          # x'_{-4}: (p, q)
    y = a[None, :] * sigma[:, None]                                   # per pair
    order = np.argsort(mu)
    cum = np.concatenate([[0.0], np.cumsum(2 * co[order])])
    acc = np.empty((mu.size, K.size))
    for k in range(K.size):
        if k:
            x = x + y                                                 # one ADD a tap
        t = 1.0 / (np.abs(x) + e)
        u = t * (coef[:, 0] + t * (coef[:, 1] + t * (coef[:, 2] + t * (coef[:, 3]
                                                                    + t * coef[:, 4]))))
        s = mu + K[k] * sigma
        sgn = np.sign(s[:, None] - mu[None, :])                       # comparisons
        left, right = (np.searchsorted(mu[order], s, side=side) for side in ("left", "right"))
        prefix = (cum[left] + cum[right]) / 2 - co.sum()              # sum_q sgn co_q
        acc[:, k] = prefix - (sgn * u * np.exp2(-x * x)).sum(axis=1)
    return acc


@pytest.mark.parametrize("seed", [0, 1])
def test_the_folds_the_floor_counts_compute_the_same_sums(seed):
    mu, sigma, co = _ray(seed)
    plain, folded = _acc_plain(mu, sigma, co), _acc_folded(mu, sigma, co)
    assert np.allclose(folded, plain, rtol=1e-10, atol=1e-10 * np.abs(co).sum())


def test_floor_derivation():
    assert (work.ARGS_PAIR, work.POLY_AS5, work.TAP_FWD, work.TAP_BWD) == (7, 7, 11, 17)
    assert (work.PAIR_FWD, work.ROW_FWD, work.PAIR_BWD, work.ROW_BWD) == (62, 46, 92, 80)
    # the folds of _acc_folded with Horner's rule for u (4 FMA + 1 MUL) issue
    # 1 + 1 + 9 + 1 + 1 a tap beyond the 7 of a pair's arguments: the floor
    # lies below a scheme that exists
    horner_pair = work.ARGS_PAIR + work.N_SAMPLES * (1 + 1 + 9 + 1 + 1)
    assert work.PAIR_FWD < horner_pair == 72
    # the kernel's own 17 FP32 instructions a forward tap take 34 FLOP slots
    assert work.PAIR_FWD < work.N_SAMPLES * 2 * 17


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_no_share_passes_100_at_the_peak_rate(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 600, size=rng.integers(1, 300))
    for w in (work.forward_work(counts, 128), work.forward_work(counts, 128, store_t=True),
              work.backward_work(counts, 128)):
        fastest = max(w.flops / work.FP32_FLOPS_PER_S, w.bytes / work.HBM_BYTES_PER_S)
        assert math.isclose(work.share_pct(w, fastest), 100.0, rel_tol=1e-12)
        assert work.flops_share_pct(w, fastest) <= 100.0 * (1 + 1e-12)
        for slower in (1.0001, 2.0, 50.0):
            assert work.share_pct(w, fastest * slower) < 100.0
    assert work.share_pct(work.Work(1.0, 1.0), 0.0) is None

