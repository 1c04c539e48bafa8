"""Numerical erf/exp approximations (PyTorch port of sgrt_tpu.ops.approx).

The reference templates its renderer over exp/erf implementations
(f32_func_t typedefs, src/vrt/rt.h:22-23) and ships six approximations:
spline_erf (approx.cpp:9-41), spline_erf_mirror (:45-69), taylor_erf
(:71-88), abramowitz_stegun_erf (:90-110, the production choice), fast_exp
(Schraudolph bit trick, :112-138), spline_exp (:140-189). Here they are
plain tensor functions: float32, elementwise, shape-preserving. The CUDA
kernels carry device copies of every one (csrc/gauss_common.cuh), in the
same float32 order; the taylor terms and the spline fits reach them from
this module through kernel_tables(), so there is one fit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TWO_OVER_SQRT_PI = 1.1283791670955126  # erf'(0) = 2/sqrt(pi)


# ---------------------------------------------------------------------------
# erf
# ---------------------------------------------------------------------------

def erf_exact(x: torch.Tensor) -> torch.Tensor:
    """libm-accuracy erf (torch.erf)."""
    return torch.erf(x)


def erf_as5_and_gauss(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Abramowitz & Stegun 7.1.26 (5-term rational), |err| <= 1.5e-7 —
    below f32 resolution of erf. Returns (erf(x), exp(-x^2)) sharing the one
    exp (the backward needs both: erf'(x) = 2/sqrt(pi) * exp(-x^2))."""
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    g = torch.exp(-x * x)
    return torch.sign(x) * (1.0 - poly * g), g


def erf_as5(x: torch.Tensor) -> torch.Tensor:
    """A&S 5-term erf — the kernels' default ("exact" maps to it there)."""
    return erf_as5_and_gauss(x)[0]


def erf_as3_and_gauss(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(erf_as3(x), exp(-x^2)) sharing the single exp."""
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.47047 * a)
    poly = t * (0.3480242 + t * (-0.0958798 + t * 0.7478556))
    g = torch.exp(-x * x)
    return torch.sign(x) * (1.0 - poly * g), g


def erf_as3(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.25 (3-term), |err| <= 2.5e-5 — the
    reference's production erf (abramowitz_stegun_erf, approx.cpp:90-110)."""
    return erf_as3_and_gauss(x)[0]


# erf's Maclaurin terms (-1)^n / (n! (2n + 1)), n = 0..9
_TAYLOR_COEF = tuple(((-1.0) ** n) / (float(math.factorial(n)) * (2 * n + 1))
                     for n in range(10))


def erf_taylor(x: torch.Tensor) -> torch.Tensor:
    """10-term Maclaurin series, input clamped to [-2, 2] (the reference's
    taylor_erf, approx.cpp:71-88). Accurate near 0, ~0.5% off at the clamp."""
    x = torch.clamp(x, -2.0, 2.0)
    x2 = x * x
    acc = torch.zeros_like(x)
    for c in reversed(_TAYLOR_COEF):
        acc = acc * x2 + c
    return _TWO_OVER_SQRT_PI * x * acc


def _fit_segments(f, lo: float, hi: float, n_seg: int, deg: int) -> np.ndarray:
    """Least-squares polynomial per uniform segment → (n_seg, deg+1) coeffs
    (highest power first), fitted in numpy at import."""
    edges = np.linspace(lo, hi, n_seg + 1)
    out = np.zeros((n_seg, deg + 1), np.float64)
    for i in range(n_seg):
        xs = np.linspace(edges[i], edges[i + 1], 64)
        out[i] = np.polyfit(xs, f(xs), deg)
    return out


def _np_erf_ref(x: np.ndarray) -> np.ndarray:
    return np.vectorize(math.erf)(x)


_ERF_SEGS = 8
_ERF_HI = 4.0
_ERF_COEF = _fit_segments(_np_erf_ref, 0.0, _ERF_HI, _ERF_SEGS, 3)
# full-domain fit for the non-mirrored variant: 16 segments over [-4, 4]
_ERF_FULL_COEF = _fit_segments(_np_erf_ref, -_ERF_HI, _ERF_HI, 2 * _ERF_SEGS, 3)
_EXP_SEGS = 16
_EXP_LO = -16.0
_EXP_COEF = _fit_segments(np.exp, _EXP_LO, 0.0, _EXP_SEGS, 3)


def _eval_segments(x, coef: np.ndarray, lo: float, hi: float):
    """Piecewise-cubic evaluation with a where-chain. coef: (n_seg, 4)
    highest power first."""
    n_seg = coef.shape[0]
    width = (hi - lo) / n_seg
    xc = torch.clamp(x, lo, hi)
    result = torch.zeros_like(x)
    for i in range(n_seg):
        c3, c2, c1, c0 = (float(c) for c in coef[i])
        val = ((c3 * xc + c2) * xc + c1) * xc + c0
        top = lo + (i + 1) * width + (1e-6 if i == n_seg - 1 else 0.0)
        in_seg = (xc >= lo + i * width) & (xc <= top)
        result = torch.where(in_seg, val, result)
    return result


def erf_spline_mirror(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-cubic erf on [0,4] mirrored by odd symmetry, saturating to
    ±1 beyond (the reference's spline_erf_mirror, approx.cpp:45-69)."""
    a = torch.abs(x)
    val = torch.where(a >= _ERF_HI, torch.ones_like(a),
                      _eval_segments(a, _ERF_COEF, 0.0, _ERF_HI))
    return torch.sign(x) * val


def erf_spline(x: torch.Tensor) -> torch.Tensor:
    """Non-mirrored spline (reference spline_erf, approx.cpp:9-41): a direct
    piecewise-cubic fit over [-4, 4], saturating to ±1 outside."""
    val = _eval_segments(x, _ERF_FULL_COEF, -_ERF_HI, _ERF_HI)
    one = torch.ones_like(x)
    return torch.where(x <= -_ERF_HI, -one, torch.where(x >= _ERF_HI, one, val))


# ---------------------------------------------------------------------------
# exp
# ---------------------------------------------------------------------------

def exp_exact(x: torch.Tensor) -> torch.Tensor:
    """torch.exp."""
    return torch.exp(x)


def exp_fast(x: torch.Tensor) -> torch.Tensor:
    """Schraudolph bit-trick exp (reference fast_exp, approx.cpp:112-138):
    write A*x + B into the f32 exponent field via an int32 bitcast.
    Max relative error ~3%. Valid for x in (-87, 88); clamped."""
    x = torch.clamp(x, -87.0, 88.0)
    i = (12102203.0 * x + 1064866805.0).to(torch.int32)
    return i.view(torch.float32)


def exp_spline(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-cubic exp on [-16, 0], 0 below (reference spline_exp,
    approx.cpp:140-189); above 0 (outside the renderer's domain) exact."""
    val = _eval_segments(x, _EXP_COEF, _EXP_LO, 0.0)
    return torch.where(x < _EXP_LO, torch.zeros_like(x),
                       torch.where(x > 0.0, torch.exp(x), val))


def kernel_tables() -> np.ndarray:
    """What the CUDA kernels read of this module (csrc/gauss_common.cuh,
    kApproxTab): the taylor terms from n = 0, then the rows of _ERF_COEF,
    _ERF_FULL_COEF and _EXP_COEF (highest power first), each rounded to
    float32 as the plain versions' float32 arithmetic rounds a Python float.
    float32 (170,)."""
    parts = [np.asarray(_TAYLOR_COEF), _ERF_COEF.ravel(), _ERF_FULL_COEF.ravel(),
             _EXP_COEF.ravel()]
    return np.ascontiguousarray(np.concatenate(parts).astype(np.float32))


# ---------------------------------------------------------------------------
# registries (the reference's f32_func_t template parameters, rt.h:22-23)
# ---------------------------------------------------------------------------

ERF_IMPLS = {
    "exact": erf_exact,
    "as5": erf_as5,
    "as3": erf_as3,
    "taylor": erf_taylor,
    "spline": erf_spline,
    "spline_mirror": erf_spline_mirror,
}

EXP_IMPLS = {
    "exact": exp_exact,
    "fast": exp_fast,
    "spline": exp_spline,
}

# (erf, exp(-x^2)) fused pairs for gradient kernels; an erf without a pair
# (taylor, spline, spline_mirror) takes as5's in every backward.
ERF_AND_GAUSS_IMPLS = {
    "as5": erf_as5_and_gauss,
    "as3": erf_as3_and_gauss,
    "exact": lambda x: (torch.erf(x), torch.exp(-x * x)),
}

DEFAULT_KERNEL_ERF = "as5"
