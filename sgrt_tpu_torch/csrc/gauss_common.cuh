// Device math shared by the fused (fused_fwd.cu, fused_bwd.cu) and the
// chunked (chunked_bwd.cu) kernels: the erf/exp variants
// the kernels are compiled for, the rounding-controlled Gaussian exponent,
// the per-row constants that rows are staged with, the five quadrature
// taps, a warp sum, and pass A over staged rows.
//
// No fast-math anywhere: the A&S reciprocal is an IEEE division and expf is
// the accurate one, so "as5" is the float32-exact erf and the kernels agree
// with their plain PyTorch versions (sgrt_tpu_torch/ops/cuda_kernel.py) to
// summation order.

#pragma once

#include <cuda_runtime.h>

namespace sgrt {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 1.2533141373155001f;  // sqrt(pi/2)
constexpr float kSqrt2Pi = 0.7978845608028654f;     // sqrt(2/pi)
constexpr float kDerf = 1.1283791670955126f;        // 2/sqrt(pi) = erf'(0)
constexpr int kTaps = 5;
constexpr int kStageFields = 7;  // ocx ocy ocz |oc|^2 1/(2s^2) 1/(sqrt2 s) mag*s*sqrt(pi/2)

enum { kErfAs5 = 0, kErfAs3 = 1 };
enum { kExpExact = 0, kExpFast = 1 };

template <int EXP>
__device__ __forceinline__ float exp_fn(float x);

template <>
__device__ __forceinline__ float exp_fn<kExpExact>(float x) {
  return expf(x);
}

// Schraudolph's bit-trick exp (sgrt_tpu/ops/approx.py::exp_fast): the
// rounded-to-nearest multiply and add keep nvcc from contracting them into
// one FMA, so the bits match the float32 reference.
template <>
__device__ __forceinline__ float exp_fn<kExpFast>(float x) {
  x = fminf(fmaxf(x, -87.0f), 88.0f);
  const float y = __fadd_rn(__fmul_rn(12102203.0f, x), 1064866805.0f);
  return __int_as_float(__float2int_rz(y));
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// erf(x) and exp(-x^2) sharing the one expf (Abramowitz & Stegun 7.1.26
// for as5, 7.1.25 for as3); the backward needs both, since
// erf'(x) = 2/sqrt(pi) exp(-x^2). The polynomial's own exp is always the
// accurate expf, whatever EXP the kernel is built with.
template <int ERF>
__device__ __forceinline__ void erf_and_gauss(float x, float& e, float& g);

template <>
__device__ __forceinline__ void erf_and_gauss<kErfAs5>(float x, float& e, float& g) {
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  g = expf(-x * x);
  e = sign_of(x) * (1.0f - poly * g);
}

template <>
__device__ __forceinline__ void erf_and_gauss<kErfAs3>(float x, float& e, float& g) {
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.47047f * a);
  const float poly = t * (0.3480242f + t * (-0.0958798f + t * 0.7478556f));
  g = expf(-x * x);
  e = sign_of(x) * (1.0f - poly * g);
}

template <int ERF>
__device__ __forceinline__ float erf_fn(float x) {
  float e, g;
  erf_and_gauss<ERF>(x, e, g);
  return e;
}

// The Gaussian's exponent -(|oc|^2 - mb^2) / (2 sigma^2) subtracts two
// nearly equal numbers (|oc|^2 ~ mb^2 when the ray passes near the center),
// so one rounding step of mb or |oc|^2 moves co by up to ulp(|oc|^2) /
// (2 sigma^2) relative. These helpers round every product and sum to
// nearest, in the plain version's order, so nvcc cannot contract them into
// FMAs and the kernels' co matches the plain version's bit for bit.
__device__ __forceinline__ float dot3_rn(float ax, float ay, float az, float bx,
                                         float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// |oc|^2 - mb^2, rounded as the plain version rounds it.
__device__ __forceinline__ float ocsq_minus_mb2_rn(float ocsq, float mb) {
  return __fsub_rn(ocsq, __fmul_rn(mb, mb));
}

__device__ __forceinline__ float gauss_exponent_rn(float ocsq, float mb, float i2s2) {
  return __fmul_rn(-ocsq_minus_mb2_rn(ocsq, mb), i2s2);
}

// Per-row constants of Gaussian q, as they are staged in shared memory.
struct Row {
  float x, y, z, ocsq, i2s2, inv, cs;
};

__device__ __forceinline__ Row load_row(const float* oc, const float* sig, const float* mag,
                                        int q) {
  Row w;
  w.x = oc[3 * q];
  w.y = oc[3 * q + 1];
  w.z = oc[3 * q + 2];
  const float s = sig[q];
  w.ocsq = dot3_rn(w.x, w.y, w.z, w.x, w.y, w.z);
  w.i2s2 = 1.0f / (2.0f * s * s);
  w.inv = kInvSqrt2 / s;
  w.cs = mag[q] * s * kInvSqrt2Pi;
  return w;
}

// co(q, r) = mag sigma sqrt(pi/2) exp(-(|oc|^2 - mb^2) / (2 sigma^2)).
template <int EXP>
__device__ __forceinline__ float coeff(float cs, float ocsq, float mb, float i2s2) {
  return cs * exp_fn<EXP>(gauss_exponent_rn(ocsq, mb, i2s2));
}

// Rows q0 .. q0 + nq - 1 of one tile into shared memory, field-major
// (stage[f * qb + j]); the caller brackets this with __syncthreads().
__device__ __forceinline__ void stage_rows(float* stage, int qb, const float* oc,
                                           const float* sig, const float* mag, int q0,
                                           int nq) {
  for (int j = threadIdx.x; j < nq; j += blockDim.x) {
    const Row w = load_row(oc, sig, mag, q0 + j);
    stage[j] = w.x;
    stage[qb + j] = w.y;
    stage[2 * qb + j] = w.z;
    stage[3 * qb + j] = w.ocsq;
    stage[4 * qb + j] = w.i2s2;
    stage[5 * qb + j] = w.inv;
    stage[6 * qb + j] = w.cs;
  }
}

// Tap i in 0..4 is k = i - 4; its weight is w_k = exp(-k^2/2). Called with
// unrolled constant indices, both fold to literals.
__device__ __forceinline__ float tap_k(int i) { return static_cast<float>(i - 4); }

__device__ __forceinline__ float tap_weight(int i) {
  return i == 0 ? 3.354626279025119e-04f
       : i == 1 ? 1.110899653824231e-02f
       : i == 2 ? 1.353352832366127e-01f
       : i == 3 ? 6.065306597126334e-01f
                : 1.0f;
}

// Sum over the 32 lanes of a warp in a fixed butterfly (deterministic).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Pass A of PB p rows of one ray against the q rows [q_lo, q_hi) of one
// tile, staged qb rows at a time through shared memory:
//   acc[i][k] += co_q erf((mb_p + k sigma_p - mb_q) inv_q)
// and, with with_base, base += co_q erf(-mb_q inv_q). Every thread of the
// block calls it with the same bounds (it stages rows between barriers).
//
// The sums are two-level: each stage's qb terms are summed on their own,
// then added to the running sum. T = w exp(base - acc) subtracts two sums
// of up to N terms, so their rounding error is T's relative error; a single
// running sum over N terms loses ~N ulp in the worst case, two levels
// ~(qb + N/qb). At N ~ 4000 (the 50k-Gaussian sphere) a single running sum
// made T several times less accurate than the plain version's blocked sums.
template <int PB, int ERF, int EXP>
__device__ __forceinline__ void pass_a(float* stage, int qb, const float* oc_b,
                                       const float* sig_b, const float* mag_b, int q_lo,
                                       int q_hi, float dx, float dy, float dz,
                                       const float (&mbp)[PB], const float (&sgp)[PB],
                                       float (&acc)[PB][kTaps], bool with_base, float& base) {
  for (int q0 = q_lo; q0 < q_hi; q0 += qb) {
    const int nq = min(qb, q_hi - q0);
    __syncthreads();
    stage_rows(stage, qb, oc_b, sig_b, mag_b, q0, nq);
    __syncthreads();
    float part[PB][kTaps], base_part = 0.0f;
#pragma unroll
    for (int i = 0; i < PB; ++i) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) part[i][k] = 0.0f;
    }
    for (int j = 0; j < nq; ++j) {
      const float mbq = dot3_rn(stage[j], stage[qb + j], stage[2 * qb + j], dx, dy, dz);
      const float co = coeff<EXP>(stage[6 * qb + j], stage[3 * qb + j], mbq, stage[4 * qb + j]);
      const float invq = stage[5 * qb + j];
      if (with_base) base_part += co * erf_fn<ERF>(-mbq * invq);
#pragma unroll
      for (int i = 0; i < PB; ++i) {
        const float darg = (mbp[i] - mbq) * invq;
        const float ks = sgp[i] * invq;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) part[i][k] += co * erf_fn<ERF>(darg + tap_k(k) * ks);
      }
    }
    base += base_part;
#pragma unroll
    for (int i = 0; i < PB; ++i) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc[i][k] += part[i][k];
    }
  }
}

}  // namespace sgrt
