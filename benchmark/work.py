"""The yardstick of every roofline and mfu share: the work a frame or a
train step needs, counted from its inputs, costed at a floor, and the
card's published peaks.

Counting. The math contract (a frame of rays through Gaussians, each ray's
transmittance a sum of erf terms, radiance by a 5-point quadrature) gives,
per tile of R rays whose culled member list holds c Gaussians:

    pairs c^2 R     one (Gaussian p, Gaussian q, ray) pair: 5 erf terms
                    ("taps"), one per sample k of p, against q
    rows  c R       one (Gaussian, ray) row: mu_bar, cbar, the base erf
                    term and the 5 samples' transmittance and weights

c is the tile's live member count under the benchmark's own 3.3-sigma
culling (reference/render.py), of the scene and view of that step or
frame: never a capacity or a padded count of the program.

Costing. The work is costed at a floor: float32 FLOPs (an add or a
multiply one, an FMA two) under the fewest that an implementation of the
default stack's semantics (erf by Abramowitz & Stegun 7.1.26, "as5"; exp
exact; float32) must issue when it evaluates every live term, in any order
of summation and with every hoist and fold that the terms allow:

- what depends on fewer indices than a term is worked out where it is
  constant and not counted per term: per Gaussian q (the camera's origin is
  every ray's, so oc and |oc|^2 are per q), per row (q, ray), per sample
  (p, k, ray), per pair (p, q, ray);
- the reciprocal and the exp2 go to the special-function unit, 0; sign,
  absolute value, negation and comparisons are bit operations, 0;
- the argument is pre-scaled by sqrt(log2 e), x' = a_q s - b_q with
  a_q = sqrt(log2 e) / (sqrt2 sigma_q), b_q = a_q mu_bar_q, so that
  exp(-x^2) = exp2(-x'^2), and as5's t = 1 / (1 + p|x|) is, up to a
  per-q factor folded into the polynomial's coefficients,
  t' = 1 / (|x'| + e) with e = sqrt(log2 e) / p;
- as5's u(t') = sum_i c_i t'^i (i = 1..5, no constant term) takes the
  row's co_q into its coefficients, and is costed at the lower bounds for
  polynomials with preconditioned coefficients (Knuth, TAOCP 2, 4.6.4:
  Motzkin's floor(n/2) + 1 multiplications, Belaga's one addition per
  free coefficient but one): 3 multiplications and 4 additions, 7, where
  Horner's rule takes 4 FMA and 1 MUL, 9. A&S's coefficients are taken to
  obey no algebraic relation that would let a scheme do better;
- the 5 samples of a pair share x' by a recurrence: x'_{k+1} = x'_k + y
  with y = a_q sigma_p, so a pair's 5 arguments cost 7 (x'_{-4} one FMA,
  y one MUL, 4 ADD), not 10;
- co_q sgn(x') (as5's erf is odd: sgn(x) (1 - u g)) sums over the members
  sorted along the ray to 2 C(s) - sum co, C a prefix sum: one ADD and one
  MUL a row, not one a term; the backward's sum over samples of gA sgn
  likewise, one ADD a sample.

    forward pair (PAIR_FWD = 62): the 5 arguments 7; per tap (11 each):
        d = |x'| + e one ADD, x'^2 one MUL (exp2 of its negation), u(t') 7,
        u g one MUL, acc -= sgn u g one ADD.
    forward row (ROW_FWD = 46): mu_bar' = oc'_q . d (oc_q pre-scaled),
        3 MUL + 2 ADD 5; cbar's exponent K_q - mu_bar'^2 one FMA 2; its
        exp2 0; co_q and the row's weight, one MUL each 2; s_{p,-4} one
        ADD and b_q one MUL 2; the base term erf(-a_q mu_bar_q), a tap
        whose argument is -b_q (its sum of sgn co is the prefix sum's at
        s = 0), 11; the prefix sum of 2 co, one MUL and one ADD 2; per sample: the exponent base - acc one ADD and
        tw += W_k T one FMA, 3 (15 for the 5); the color
        L += albedo (W tw), one MUL and 3 FMA 7.
    backward pair (PAIR_BWD = 92): no implementation can hold the
        forward's per-tap values (5 c^2 R floats a tile: 302 GB for one
        step of the cube cloud), so the backward evaluates each live tap
        again: the 5 arguments 7; per tap (17 each): d 1, x'^2 1, u(t') 7,
        y = gA g one MUL, dco_q -= sgn u y one FMA 2, h = y c''_q (c''_q
        the row's co_q 2/sqrt(pi) a_q) one MUL, ds_pk += h and
        d mu_bar_q -= h one ADD each 2, d a_q += h x' one FMA 2. (The
        derivative of erf taken as 2/sqrt(pi) exp(-x^2), as5's own
        derivative costs more: the floor takes the cheaper.)
    backward row (ROW_BWD = 80): what the forward's row works out again or
        saves (mu_bar', cbar, co, the base term) is counted 0; dtw =
        (dcolor . albedo) W, 3 MUL + 2 ADD + 1 MUL 6; per sample: dT =
        dtw W_k one MUL, gA = -dT T one MUL, dbase one ADD, d mu_bar_p
        += ds_pk one ADD, d sigma_p += k ds_pk one FMA, the prefix sum of
        gA one ADD, 7 (35 for the 5); the base term's cotangents: dco_q
        one FMA, h0 2 MUL, d mu_bar_q one ADD, 5; the prefix's dco_q one
        FMA 2; dW one MUL 1; dalbedo += dcolor (W tw) one MUL and 3 FMA 7;
        cbar's chain, dE = dco C_q + dW D_q one MUL and one FMA 3, dE E 1,
        d mu_bar' 2 MUL and one FMA and one ADD 5; d oc'_q and the ray
        direction's gradient, 3 FMA each 12; d sigma_q 3.

Rows are a tile's c R against its pairs' c^2 R: at most a few percent of
the work where tiles hold tens of members, under 0.1% in dense tiles. So
a kernel that issues fewer instructions a term raises its share, and none
takes it past 100%.

Bytes: each input byte read once and each output byte written once,
whatever a kernel reads again: per live row its 8 floats (oc, sigma, mag,
albedo), per tile its R directions and count, the R colors out; the
forward-with-T writes and the saved-T backward reads 5 c R floats of T; the
backward reads the colors' cotangent and writes 8 floats a live row and the
directions' gradient.

Peaks: NVIDIA's data sheet of the H100 SXM, dense, at its 700 W limit:
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM. A run
prints the card's power limit beside its shares. The least time of some
work is the larger of its FLOPs over the FLOP peak and its bytes over the
bandwidth.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

N_SAMPLES = 5          # the quadrature's samples k in {-4, ..., 0}

# the FLOP floors; derivation in the module note
ARGS_PAIR = 2 + 1 + 4            # x'_{-4} one FMA, y one MUL, 4 ADD
POLY_AS5 = 3 + 4                 # u(t'): Motzkin's 3 MUL, Belaga's 4 ADD
TAP_FWD = 1 + 1 + POLY_AS5 + 1 + 1
PAIR_FWD = ARGS_PAIR + N_SAMPLES * TAP_FWD
ROW_FWD = 5 + 2 + 2 + 2 + TAP_FWD + 2 + N_SAMPLES * 3 + 7
TAP_BWD = 1 + 1 + POLY_AS5 + 1 + 2 + 1 + 2 + 2
PAIR_BWD = ARGS_PAIR + N_SAMPLES * TAP_BWD
ROW_BWD = 6 + N_SAMPLES * 7 + 5 + 2 + 1 + 7 + 3 + 1 + 5 + 12 + 3

ROW_FLOATS = 8         # oc (3), sigma, mag, albedo (3)
F32 = 4


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def bound_s(self) -> float:
        """The least time the card could take for this work."""
        return max(self.flops / FP32_FLOPS_PER_S, self.bytes / HBM_BYTES_PER_S)


def _sums(counts, rays_per_tile: int):
    c = np.asarray(counts, dtype=np.float64).reshape(-1)
    if np.any(c < 0):
        raise ValueError("tile counts must be >= 0")
    return float(np.sum(c * c)) * rays_per_tile, float(np.sum(c)) * rays_per_tile, c.size


def forward_work(counts, rays_per_tile: int, store_t: bool = False) -> Work:
    """The forward's work over tiles of `rays_per_tile` rays whose live
    member counts are `counts`; store_t adds the bytes of T written (the
    forward-with-T of a saved-T train step)."""
    pairs, rows, tiles = _sums(counts, rays_per_tile)
    flops = pairs * PAIR_FWD + rows * ROW_FWD
    nbytes = F32 * (ROW_FLOATS * rows / rays_per_tile + tiles * (3 * rays_per_tile + 1)
                    + tiles * 3 * rays_per_tile)
    if store_t:
        nbytes += F32 * N_SAMPLES * rows
    return Work(flops, nbytes)


def backward_work(counts, rays_per_tile: int) -> Work:
    """The saved-T backward's work over the same tiles: the analytic
    gradients of the colors with respect to every row and ray direction."""
    pairs, rows, tiles = _sums(counts, rays_per_tile)
    flops = pairs * PAIR_BWD + rows * ROW_BWD
    nbytes = F32 * (ROW_FLOATS * rows / rays_per_tile            # rows in
                    + tiles * (3 * rays_per_tile + 1)             # directions, count
                    + tiles * 3 * rays_per_tile                   # colors' cotangent
                    + N_SAMPLES * rows                            # T in
                    + ROW_FLOATS * rows / rays_per_tile           # row gradients out
                    + tiles * 3 * rays_per_tile)                  # ddirs out
    return Work(flops, nbytes)


def share_pct(work: Work, seconds: float) -> float | None:
    """The work's least time as a share of `seconds`, in %; None without
    a time to compare with."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * work.bound_s() / seconds


def flops_share_pct(work: Work, seconds: float) -> float | None:
    """The work's FLOPs over `seconds` as a share of the FP32 peak, in %."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * work.flops / (seconds * FP32_FLOPS_PER_S)
