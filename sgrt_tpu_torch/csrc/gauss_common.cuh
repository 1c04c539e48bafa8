// Device math shared by the fused (fused_fwd.cu, fused_bwd.cu), the
// chunked (chunked_bwd.cu) and the split (split.cu) kernels: the erf/exp
// variants the kernels are compiled for, the rounding-controlled Gaussian
// exponent, the per-row constants that rows are staged with, the two row
// geometries (isotropic and anisotropic), the five quadrature taps, a warp
// sum, a block's per-row sums over rays, pass A over staged rows, and the
// ordered sum of per-block partials.
//
// No fast-math anywhere: the A&S reciprocal is an IEEE division and expf is
// the accurate one, so "as5" is the float32-exact erf and the kernels agree
// with their plain PyTorch versions (sgrt_tpu_torch/ops/cuda_kernel.py,
// cuda_aniso.py) to summation order.

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

// ---------------------------------------------------------------------------
// Row geometries. A Gaussian row seen along a ray is a 1-D Gaussian with
// per-(row, ray) parameters; the kernels are templates over how those are
// made, so that one pass A, one pass B and one p loop serve both:
//   mb  = the ray parameter of the peak (mu_bar)
//   sb  = the standard deviation along the ray (sigma_bar)
//   co  = mag sb sqrt(pi/2) exp(exponent)
//   inv = 1 / (sqrt2 sb)
// A geometry stages q rows in shared memory (kFields fields each, stage),
// reads a staged row's terms for one ray (staged) and a row's terms from
// device memory (row); both give the same bits for the same row and ray.
// ---------------------------------------------------------------------------

struct RayTerms {
  float mb, sb, co, inv;
};

// Isotropic rows: sigma (B,N) is one number per row, so sb = sigma and inv
// are per row; mb = oc . d and the exponent -(|oc|^2 - mb^2) / (2 sigma^2).
struct IsoGeo {
  static constexpr int kFields = kStageFields;
  const float* oc;
  const float* sig;
  const float* mag;

  // the rows of tile b: oc (B,N,3), sigma (B,N), mag (B,N)
  __device__ IsoGeo(const float* oc_, const float* sig_, const float* mag_, int b, int N)
      : oc(oc_ + static_cast<size_t>(b) * N * 3),
        sig(sig_ + static_cast<size_t>(b) * N),
        mag(mag_ + static_cast<size_t>(b) * N) {}

  __device__ void stage(float* st, int qb, int q0, int nq) const {
    stage_rows(st, qb, oc, sig, mag, q0, nq);
  }

  template <int EXP>
  __device__ RayTerms staged(const float* st, int qb, int j, float dx, float dy,
                             float dz) const {
    RayTerms t;
    t.mb = dot3_rn(st[j], st[qb + j], st[2 * qb + j], dx, dy, dz);
    t.co = coeff<EXP>(st[6 * qb + j], st[3 * qb + j], t.mb, st[4 * qb + j]);
    t.inv = st[5 * qb + j];
    t.sb = 0.0f;  // a q row's sigma enters only through inv
    return t;
  }

  template <int EXP>
  __device__ RayTerms row(int p, float dx, float dy, float dz) const {
    const Row w = load_row(oc, sig, mag, p);
    RayTerms t;
    t.mb = dot3_rn(w.x, w.y, w.z, dx, dy, dz);
    t.sb = sig[p];
    t.co = coeff<EXP>(w.cs, w.ocsq, t.mb, w.i2s2);
    t.inv = w.inv;
    return t;
  }
};

// Anisotropic rows (diagonal covariance, sgrt_tpu/ops/anisotropic.py's
// math): invd = scale^-2 (B,N,3) per axis, M = oc * invd, and per ray
//   A  = sum_i invd_i d_i^2,  Bt = sum_i M_i d_i,  C = sum_i oc_i^2 invd_i
//   sb = 1/sqrt(A),  mb = Bt sb sb,  inv = sqrt(A/2),
//   co = mag sqrt(pi/2) sb exp(-(C - Bt mb)/2).
// C - Bt mb cancels two numbers of size |oc|^2/scale^2 (~6400 on the
// stretched teapot cloud), so A, Bt, C and every product after them are
// rounded to nearest in a fixed order, as the plain version
// (ops/cuda_aniso.py) computes them; sb is an IEEE square root and
// division, not rsqrtf. Staged per q row: invd (3), M (3), C, mag sqrt(pi/2);
// the ray's terms are recomputed per (row, ray), about 25 FP32 instructions
// and 2 SFU operations against the 5 PB erf taps each staged row meets.
struct AnisoGeo {
  static constexpr int kFields = 8;
  const float* oc;
  const float* invd;
  const float* mag;

  // the rows of tile b: oc (B,N,3), invd (B,N,3), mag (B,N)
  __device__ AnisoGeo(const float* oc_, const float* invd_, const float* mag_, int b, int N)
      : oc(oc_ + static_cast<size_t>(b) * N * 3),
        invd(invd_ + static_cast<size_t>(b) * N * 3),
        mag(mag_ + static_cast<size_t>(b) * N) {}

  struct Fields {
    float ix, iy, iz, mx, my, mz, c, cs;
  };

  __device__ Fields fields(int q) const {
    const float ox = oc[3 * q], oy = oc[3 * q + 1], oz = oc[3 * q + 2];
    Fields f;
    f.ix = invd[3 * q];
    f.iy = invd[3 * q + 1];
    f.iz = invd[3 * q + 2];
    f.mx = __fmul_rn(ox, f.ix);
    f.my = __fmul_rn(oy, f.iy);
    f.mz = __fmul_rn(oz, f.iz);
    f.c = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ox, ox), f.ix), __fmul_rn(__fmul_rn(oy, oy), f.iy)),
                    __fmul_rn(__fmul_rn(oz, oz), f.iz));
    f.cs = __fmul_rn(mag[q], kInvSqrt2Pi);
    return f;
  }

  template <int EXP>
  static __device__ RayTerms terms(const Fields& f, float dx, float dy, float dz) {
    const float a = dot3_rn(f.ix, f.iy, f.iz, __fmul_rn(dx, dx), __fmul_rn(dy, dy),
                            __fmul_rn(dz, dz));
    const float bt = dot3_rn(f.mx, f.my, f.mz, dx, dy, dz);
    RayTerms t;
    t.sb = __fdiv_rn(1.0f, __fsqrt_rn(a));
    t.mb = __fmul_rn(__fmul_rn(bt, t.sb), t.sb);
    const float e = exp_fn<EXP>(__fmul_rn(-0.5f, __fsub_rn(f.c, __fmul_rn(bt, t.mb))));
    t.co = __fmul_rn(__fmul_rn(f.cs, t.sb), e);
    t.inv = __fsqrt_rn(__fmul_rn(0.5f, a));
    return t;
  }

  __device__ void stage(float* st, int qb, int q0, int nq) const {
    for (int j = threadIdx.x; j < nq; j += blockDim.x) {
      const Fields f = fields(q0 + j);
      st[j] = f.ix;
      st[qb + j] = f.iy;
      st[2 * qb + j] = f.iz;
      st[3 * qb + j] = f.mx;
      st[4 * qb + j] = f.my;
      st[5 * qb + j] = f.mz;
      st[6 * qb + j] = f.c;
      st[7 * qb + j] = f.cs;
    }
  }

  template <int EXP>
  __device__ RayTerms staged(const float* st, int qb, int j, float dx, float dy,
                             float dz) const {
    const Fields f = {st[j],          st[qb + j],     st[2 * qb + j], st[3 * qb + j],
                      st[4 * qb + j], st[5 * qb + j], st[6 * qb + j], st[7 * qb + j]};
    return terms<EXP>(f, dx, dy, dz);
  }

  template <int EXP>
  __device__ RayTerms row(int p, float dx, float dy, float dz) const {
    return terms<EXP>(fields(p), dx, dy, dz);
  }
};

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

// One row's S values summed over the block's rays in a fixed order (warp
// butterfly, then the warps in order); thread j < S writes sum j to out[j],
// or adds it with accumulate. red holds S floats per warp. Every thread of
// the block calls it.
template <int S>
__device__ __forceinline__ void row_sums(const float (&v)[S], float* red, float* out,
                                         bool accumulate = false) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float s = warp_sum(v[j]);
    if (lane == 0) red[warp * S + j] = s;
  }
  __syncthreads();
  if (threadIdx.x < S) {
    float s = 0.0f;
    const int nw = blockDim.x >> 5;
    for (int w = 0; w < nw; ++w) s += red[w * S + threadIdx.x];
    out[threadIdx.x] = accumulate ? out[threadIdx.x] + s : s;
  }
  __syncthreads();
}

// Pass A of PB p rows of one ray against the q rows [q_lo, q_hi) of one
// tile, staged qb rows at a time through shared memory:
//   acc[i][k] += co_q erf((mb_p + k sb_p - mb_q) inv_q)
// and, with with_base, base += co_q erf(-mb_q inv_q). sgp holds the p rows'
// sb (sigma for isotropic rows). Every thread of the block calls it with
// the same bounds (it stages rows between barriers).
//
// The sums are two-level: each stage's qb terms are summed on their own,
// then added to the running sum. T = w exp(base - acc) subtracts two sums
// of up to N terms, so their rounding error is T's relative error; a single
// running sum over N terms loses ~N ulp in the worst case, two levels
// ~(qb + N/qb). At N ~ 4000 (the 50k-Gaussian sphere) a single running sum
// made T several times less accurate than the plain version's blocked sums.
template <int PB, int ERF, int EXP, class Geo>
__device__ __forceinline__ void pass_a(float* stage, int qb, const Geo& geo, int q_lo,
                                       int q_hi, float dx, float dy, float dz,
                                       const float (&mbp)[PB], const float (&sgp)[PB],
                                       float (&acc)[PB][kTaps], bool with_base, float& base) {
  for (int q0 = q_lo; q0 < q_hi; q0 += qb) {
    const int nq = min(qb, q_hi - q0);
    __syncthreads();
    geo.stage(stage, qb, q0, nq);
    __syncthreads();
    float part[PB][kTaps], base_part = 0.0f;
#pragma unroll
    for (int i = 0; i < PB; ++i) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) part[i][k] = 0.0f;
    }
    for (int j = 0; j < nq; ++j) {
      const RayTerms tq = geo.template staged<EXP>(stage, qb, j, dx, dy, dz);
      const float mbq = tq.mb, co = tq.co, invq = tq.inv;
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

// The second level of a sum split over row blocks: out[b, e] = sum of
// part[b, z, e] over the blocks z of tile b that hold live rows, in block
// order (no atomics, deterministic), for e < per_tile. Block z covers rows
// row0 + z rows ..; at most n_blocks are stored per tile. It sums the fused
// and split forwards' per-split colors and the backwards' per-block db.
__global__ void ordered_block_sums(const float* __restrict__ part,
                                   const int* __restrict__ counts, float* __restrict__ out,
                                   int B, int N, int per_tile, int n_blocks, int rows,
                                   int row0) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * per_tile) return;
  const int b = static_cast<int>(i / per_tile);
  const int cnt = max(0, min(counts[b], N));
  const int live = min(max((cnt - row0 + rows - 1) / rows, 0), n_blocks);
  const float* src = part + static_cast<size_t>(b) * n_blocks * per_tile + i % per_tile;
  float s = 0.0f;
  for (int z = 0; z < live; ++z) s += src[static_cast<size_t>(z) * per_tile];
  out[i] = s;
}

inline cudaError_t launch_block_sums(const float* part, const int* counts, float* out, int B,
                                     int N, int per_tile, int n_blocks, int rows, int row0,
                                     cudaStream_t s) {
  const size_t n = static_cast<size_t>(B) * per_tile;
  ordered_block_sums<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      part, counts, out, B, N, per_tile, n_blocks, rows, row0);
  return cudaGetLastError();
}

}  // namespace sgrt
