// Split kernels of the Gaussian ray tracer for Hopper (sm_90a): the
// transmittance weights tw and the colors from precomputed Gaussian-major
// (B,N,R) planes, and their VJPs.
//
// Replaces the TPU kernels of sgrt_tpu/ops/pallas_kernel.py:
//   _fwd_kernel        (tw_pallas's forward)      entry point sgrt_split_fwd
//   _bwd_kernel        (tw_pallas's VJP)          entry point sgrt_split_bwd
//   _fwd_color_kernel  (colors_pallas's forward)  entry point sgrt_split_fwd_color
//   _bwd_color_kernel  (colors_pallas's VJP)      entry point sgrt_split_bwd_color
//
// The fused kernels' math (chunked.cu's note) with mb and co read from the
// planes instead of made from oc and the ray: for tile b, count = min(counts,
// N), ray r, taps k = -4..0,
//   base(r)    = sum over ALL N rows q of co(q,r) erf(-mb(q,r) inv_q)
//   acc_k(p,r) = sum_{q < count} co(q,r) erf((mb(p,r) + k sigma_p - mb(q,r)) inv_q)
//   T_k(p,r)   = w_k exp(base(r) - acc_k(p,r)),  tw = sum_k T_k   (p < count; 0 past it)
//   colors(:,r)= sum_{p < count} albedo_p sqrt(2/pi) co(p,r) tw(p,r)
// base sums every row, as the Pallas kernels do; sigma_p of the taps and inv
// are separate inputs (inv is not recomputed from sigma). The VJP from g =
// d tw (or, for colors, g = sqrt(2/pi) co albedo . dcol plus the weights
// path dco += sqrt(2/pi) tw albedo . dcol, dalbedo = sum_r sqrt(2/pi) co tw
// dcol): G_k = g T_k, db = sum_p g tw, and per live pair with x_k = (mb_p -
// mb_q + k sigma_p) inv_q, S0 = -2/sqrt(pi) co_q sum_k G_k exp(-x_k^2), S1 =
// the same with k G_k:
//   dmb_p += S0 inv_q, dsigma_p += S1 inv_q           (p side)
//   dco_q -= sum_k G_k erf(x_k), dmb_q -= S0 inv_q,
//   dinv_q += S0 (mb_p - mb_q) + S1 sigma_p           (q side)
// and per row q of all N (the base path) dco_q += db erf(-mb inv), dmb_q -=
// 2/sqrt(pi) db co exp(-(mb inv)^2) inv, dinv_q -= the same times mb / inv.
// dsigma and dinv are summed over rays.
//
// What bounds it on this card: operations. Per live (p, q, ray) the forward
// evaluates five erf taps (~17 FP32, 2 SFU each, gauss_common.cuh); the
// backward's p side redoes them (pass A) and adds five exp(-x^2) (~7 FP32, 1
// SFU), its q side five erf-and-gauss taps (~21 FP32, 2 SFU). The planes
// move far fewer bytes: each kernel reads and writes 2-5 (B,N,R) planes of 4
// bytes a (row, ray), against 5 to 15 taps per (row, ray) and live row.
//
// What the design does about it (with the p/q split of the chunked
// backward in chunked.cu):
//   * One thread owns one ray and keeps PB rows' state in registers. The
//     forward's and the p side's pass A is gauss_common.cuh's pass_a over
//     PlaneGeo rows: the q rows' mb and co of each thread's ray are staged
//     through shared memory (coalesced loads of qs rows at a time), with
//     their inv. base runs over all N rows in its own sweep (pass_a's base
//     would stop at the count).
//   * The p axis is split over blocks (32 rows in the forward, 64 in the
//     backward), so a tile spreads over many SMs. The Pallas backward's
//     serial p loop per (tile, ray block) is not carried over: the backward
//     is a p-side kernel (pass A, T, G = g T to scratch, db's partials, the
//     p side's pair sums), a db sum, and a q-side kernel (the q side's pair
//     sums against every live p row, reading G, then the base path), as
//     chunked.cu's backward splits its pairs. dmb and dco are per (row,
//     ray): the p side writes its part, the q side adds its part and the
//     base path in stream order. Per-row sums over rays (dsigma, dinv, dalbedo) are a warp
//     butterfly, the warps in order, then the ray blocks in order. No atomics:
//     every result is deterministic.
//   * Float32 at thousands of rows: every sum over the other side's rows
//     (acc, base, the p side's dmb and dsigma, the q side's dco, dmb, dinv)
//     is two-level, each block of kMaxStage rows summed on its own and then
//     added to the running sum; db is summed per 64-row block, then over the
//     blocks in order.
//
// Layouts (float32 unless noted, contiguous): mb, co, g, tw, dmb, dco
// (B,N,R); sigma, inv, dsigma, dinv (B,N); albedo, dalbedo (B,N,3); dcol,
// colors (B,3,R); counts (B,) int32. Scratch: partial (B, N/32, 3, R) for
// the colors; one buffer for the backwards (scratch_layout: G, db's
// partials and sums, the per-row sums).

#include <cuda_runtime.h>

#include "gauss_common.cuh"

namespace {

using namespace sgrt;

constexpr int kRowsPerBlock = 32;  // forward: p rows per block
constexpr int kRows = 64;          // backward: rows per block
constexpr int kPB = 8;             // backward: rows a thread keeps in registers
constexpr int kMaxThreads = 128;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kMaxStage = 32;      // rows per staged pass and per first-level sum
constexpr int kPSums = 4;          // per p row, summed over rays: dsigma, dalbedo rgb

// The split kernels' row geometry: a row's terms for the thread's ray are
// read from the planes. pass_a (gauss_common.cuh) calls stage and staged;
// each thread stages its own ray's mb and co of the qs rows (field-major,
// st[j * T + t], T = blockDim.x), then the rows' inv. A lane past R reads
// mb = co = 0, so every sum it makes is zero.
struct PlaneGeo {
  const float* mb;   // the thread's ray in tile b: mb[q * R]
  const float* co;
  const float* inv;  // tile b's rows
  int R;
  bool live;

  __device__ PlaneGeo(const float* mb_, const float* co_, const float* inv_, int b, int N,
                      int R_, int r)
      : mb(mb_ + static_cast<size_t>(b) * N * R_ + r),
        co(co_ + static_cast<size_t>(b) * N * R_ + r),
        inv(inv_ + static_cast<size_t>(b) * N),
        R(R_),
        live(r < R_) {}

  __device__ float mb_at(int q) const { return live ? mb[static_cast<size_t>(q) * R] : 0.0f; }
  __device__ float co_at(int q) const { return live ? co[static_cast<size_t>(q) * R] : 0.0f; }

  // floats of shared memory that stage() uses for qs rows and T threads
  static __host__ __device__ int stage_floats(int qs, int T) { return 2 * qs * T + qs; }

  __device__ void stage(float* st, int qs, int q0, int nq) const {
    const int T = blockDim.x, t = threadIdx.x;
    for (int j = 0; j < nq; ++j) {
      st[j * T + t] = mb_at(q0 + j);
      st[(qs + j) * T + t] = co_at(q0 + j);
    }
    for (int j = t; j < nq; j += T) st[2 * qs * T + j] = inv[q0 + j];
  }

  template <int EXP>
  __device__ RayTerms staged(const float* st, int qs, int j, float, float, float) const {
    const int T = blockDim.x, t = threadIdx.x;
    RayTerms terms;
    terms.mb = st[j * T + t];
    terms.co = st[(qs + j) * T + t];
    terms.inv = st[2 * qs * T + j];
    terms.sb = 0.0f;  // a q row's sigma enters only through inv
    return terms;
  }
};

// The backwards' scratch, n_rb ray blocks of threads rays, Rp = n_rb threads:
struct Scratch {
  float* G;        // (B, 5, N, Rp)  G_k = g T_k of the live rows
  float* db_part;  // (B, N/64, Rp)  db per 64-row block
  float* db;       // (B, Rp)
  float* rows_p;   // (B, n_rb, N, kPSums)
  float* rows_q;   // (B, n_rb, N)   dinv
};

// Floats of the scratch; with base, also the pointers into it.
size_t scratch_layout(int B, int N, int R, int threads, float* base = nullptr,
                      Scratch* s = nullptr) {
  const size_t n_rb = (R + threads - 1) / threads, Rp = n_rb * threads;
  const size_t nblk = (N + kRows - 1) / kRows, b = B;
  const size_t sizes[5] = {b * kTaps * N * Rp, b * nblk * Rp, b * Rp, b * n_rb * N * kPSums,
                           b * n_rb * N};
  size_t off[6] = {0};
  for (int i = 0; i < 5; ++i) off[i + 1] = off[i] + sizes[i];
  if (s != nullptr) *s = {base + off[0], base + off[1], base + off[2], base + off[3], base + off[4]};
  return off[5];
}

// base(r) over all N rows, two-level (blocks of kMaxStage rows).
template <int ERF>
__device__ float plane_base(const PlaneGeo& g, int N) {
  float base = 0.0f;
  for (int q0 = 0; q0 < N; q0 += kMaxStage) {
    const int q1 = min(q0 + kMaxStage, N);
    float part = 0.0f;
    for (int q = q0; q < q1; ++q) part += g.co_at(q) * erf_fn<ERF>(-g.mb_at(q) * g.inv[q]);
    base += part;
  }
  return base;
}

// ---------------------------------------------------------------------------
// forward: tw (COLORS false) or the colors' per-split partials (COLORS true)
// ---------------------------------------------------------------------------

template <int PB, int ERF, int EXP, bool COLORS>
__global__ void __launch_bounds__(kMaxThreads)
split_fwd_kernel(const float* __restrict__ mb, const float* __restrict__ co,
                 const float* __restrict__ sig, const float* __restrict__ inv,
                 const float* __restrict__ alb, const int* __restrict__ counts,
                 float* __restrict__ tw, float* __restrict__ partial, int N, int R, int qs,
                 int n_split) {
  extern __shared__ float stage[];
  const int b = blockIdx.z, split = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int cnt = max(0, min(counts[b], N));
  const int p_begin = split * kRowsPerBlock;
  const bool live_ray = r < R;
  float* tw_b = COLORS ? nullptr : tw + static_cast<size_t>(b) * N * R + r;
  if (!COLORS && live_ray) {  // rows of this split at or past the count: tw = 0
    for (int p = max(p_begin, cnt); p < min(p_begin + kRowsPerBlock, N); ++p)
      tw_b[static_cast<size_t>(p) * R] = 0.0f;
  }
  if (p_begin >= cnt) return;  // block-uniform: no live rows in this split
  const int p_end = min(p_begin + kRowsPerBlock, cnt);

  const PlaneGeo geo(mb, co, inv, b, N, R, r);
  const float* sig_b = sig + static_cast<size_t>(b) * N;
  const float* alb_b = COLORS ? alb + static_cast<size_t>(b) * N * 3 : nullptr;
  const float base = plane_base<ERF>(geo, N);
  float col_r = 0.0f, col_g = 0.0f, col_b = 0.0f, unused = 0.0f;

  for (int p0 = p_begin; p0 < p_end; p0 += PB) {
    float mbp[PB], sgp[PB], acc[PB][kTaps];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int p = p0 + i;
      mbp[i] = p < p_end ? geo.mb_at(p) : 0.0f;
      sgp[i] = p < p_end ? sig_b[p] : 1.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc[i][k] = 0.0f;
    }
    pass_a<PB, ERF, EXP>(stage, qs, geo, 0, cnt, 0.0f, 0.0f, 1.0f, mbp, sgp, acc, false, unused);
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int p = p0 + i;
      if (p < p_end) {
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) t += tap_weight(k) * exp_fn<EXP>(base - acc[i][k]);
        if (COLORS) {
          const float wp = kSqrt2Pi * geo.co_at(p) * t;
          col_r += alb_b[3 * p] * wp;
          col_g += alb_b[3 * p + 1] * wp;
          col_b += alb_b[3 * p + 2] * wp;
        } else if (live_ray) {
          tw_b[static_cast<size_t>(p) * R] = t;
        }
      }
    }
  }
  if (COLORS && live_ray) {
    float* out = partial + (static_cast<size_t>(b) * n_split + split) * 3 * R;
    out[r] = col_r;
    out[R + r] = col_g;
    out[2 * R + r] = col_b;
  }
}

// ---------------------------------------------------------------------------
// backward, p side: the live rows of one 64-row block
// ---------------------------------------------------------------------------

template <int ERF, int EXP, bool COLORS>
__global__ void __launch_bounds__(kMaxThreads)
split_bwd_p_kernel(const float* __restrict__ mb, const float* __restrict__ co,
                   const float* __restrict__ sig, const float* __restrict__ inv,
                   const float* __restrict__ alb, const int* __restrict__ counts,
                   const float* __restrict__ g, const float* __restrict__ dcol,
                   float* __restrict__ G, float* __restrict__ db_part,
                   float* __restrict__ rows_p, float* __restrict__ dmb,
                   float* __restrict__ dco, int N, int R, int Rp, int qs) {
  extern __shared__ float smem[];
  float* stage = smem;
  float* red = smem + PlaneGeo::stage_floats(qs, blockDim.x);
  const int b = blockIdx.z, blk = blockIdx.y, rblk = blockIdx.x;
  const int r = rblk * blockDim.x + threadIdx.x;  // < Rp always
  const int cnt = max(0, min(counts[b], N));
  const int p_begin = blk * kRows;
  if (p_begin >= cnt) return;  // block-uniform; the db sum skips dead blocks
  const int p_end = min(p_begin + kRows, cnt);
  const bool live_ray = r < R;
  const PlaneGeo geo(mb, co, inv, b, N, R, r);
  const float* sig_b = sig + static_cast<size_t>(b) * N;
  const float* inv_b = inv + static_cast<size_t>(b) * N;
  const size_t plane = static_cast<size_t>(b) * N * R + r;  // (b, 0, r) of a (B,N,R) plane
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (COLORS && live_ray) {
    const size_t o = static_cast<size_t>(b) * 3 * R;
    cr = dcol[o + r];
    cg = dcol[o + R + r];
    cb = dcol[o + 2 * R + r];
  }
  float* G_b = G + static_cast<size_t>(b) * kTaps * N * Rp + r;
  const int n_rb = gridDim.x;
  const float base = plane_base<ERF>(geo, N);
  float db = 0.0f, unused = 0.0f;

  for (int p0 = p_begin; p0 < p_end; p0 += kPB) {
    float mbp[kPB], sgp[kPB], Gk[kPB][kTaps];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      mbp[i] = p < p_end ? geo.mb_at(p) : 0.0f;
      sgp[i] = p < p_end ? sig_b[p] : 1.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) Gk[i][k] = 0.0f;
    }
    // pass A over every live q, as the forward runs it
    pass_a<kPB, ERF, EXP>(stage, qs, geo, 0, cnt, 0.0f, 0.0f, 1.0f, mbp, sgp, Gk, false, unused);

    // T, tw, the cotangent g, G_k = g T_k (to scratch), db and the weights path
    float tw[kPB], dco_w[kPB], wp[kPB];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      const bool live = p < p_end;
      tw[i] = dco_w[i] = wp[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        Gk[i][k] = live ? tap_weight(k) * exp_fn<EXP>(base - Gk[i][k]) : 0.0f;
        tw[i] += Gk[i][k];
      }
      float gp = 0.0f;
      if (live && live_ray) {
        if (COLORS) {
          const float A = alb[(static_cast<size_t>(b) * N + p) * 3] * cr +
                          alb[(static_cast<size_t>(b) * N + p) * 3 + 1] * cg +
                          alb[(static_cast<size_t>(b) * N + p) * 3 + 2] * cb;
          const float cop = geo.co_at(p);
          gp = kSqrt2Pi * cop * A;
          dco_w[i] = kSqrt2Pi * tw[i] * A;
          wp[i] = kSqrt2Pi * cop * tw[i];
        } else {
          gp = g[plane + static_cast<size_t>(p) * R];
        }
      }
      db += gp * tw[i];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        Gk[i][k] *= gp;
        if (live) G_b[(static_cast<size_t>(k) * N + p) * Rp] = Gk[i][k];
      }
    }

    // the pair pass, p side: only exp(-x^2) of each tap is needed here
    float dmbp[kPB], dsgp[kPB];
#pragma unroll
    for (int i = 0; i < kPB; ++i) dmbp[i] = dsgp[i] = 0.0f;
    for (int q0 = 0; q0 < cnt; q0 += kMaxStage) {
      const int q1 = min(q0 + kMaxStage, cnt);
      float pdmb[kPB], pdsg[kPB];
#pragma unroll
      for (int i = 0; i < kPB; ++i) pdmb[i] = pdsg[i] = 0.0f;
      for (int q = q0; q < q1; ++q) {
        const float mbq = geo.mb_at(q), invq = inv_b[q];
        const float nco = -kDerf * geo.co_at(q);
#pragma unroll
        for (int i = 0; i < kPB; ++i) {
          const float dd = mbp[i] - mbq;
          float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            const float x = (dd + tap_k(k) * sgp[i]) * invq;
            const float gg = Gk[i][k] * expf(-x * x);  // erf_and_gauss's gauss
            t0 += gg;
            t1 += tap_k(k) * gg;
          }
          pdmb[i] += (nco * t0) * invq;
          pdsg[i] += (nco * t1) * invq;
        }
      }
#pragma unroll
      for (int i = 0; i < kPB; ++i) {
        dmbp[i] += pdmb[i];
        dsgp[i] += pdsg[i];
      }
    }

    // the p side's parts of dmb and dco, and its per-row sums over rays
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      if (p >= p_end) break;  // block-uniform
      if (live_ray) {
        dmb[plane + static_cast<size_t>(p) * R] = dmbp[i];
        dco[plane + static_cast<size_t>(p) * R] = dco_w[i];
      }
      const float v[kPSums] = {dsgp[i], wp[i] * cr, wp[i] * cg, wp[i] * cb};
      row_sums<kPSums>(v, red, rows_p + ((static_cast<size_t>(b) * n_rb + rblk) * N + p) * kPSums);
    }
  }
  db_part[(static_cast<size_t>(b) * gridDim.y + blk) * Rp + r] = db;
}

// ---------------------------------------------------------------------------
// backward, q side: every row of one 64-row block (the pairs for live rows,
// the base path for all)
// ---------------------------------------------------------------------------

template <int ERF>
__global__ void __launch_bounds__(kMaxThreads)
split_bwd_q_kernel(const float* __restrict__ mb, const float* __restrict__ co,
                   const float* __restrict__ sig, const float* __restrict__ inv,
                   const int* __restrict__ counts, const float* __restrict__ G,
                   const float* __restrict__ db, float* __restrict__ rows_q,
                   float* __restrict__ dmb, float* __restrict__ dco, int N, int R, int Rp) {
  __shared__ float red[kWarps];
  const int b = blockIdx.z, blk = blockIdx.y, rblk = blockIdx.x;
  const int r = rblk * blockDim.x + threadIdx.x;
  const int cnt = max(0, min(counts[b], N));
  const int q_begin = blk * kRows, q_end = min(q_begin + kRows, N);
  const bool live_ray = r < R;
  const PlaneGeo geo(mb, co, inv, b, N, R, r);
  const float* sig_b = sig + static_cast<size_t>(b) * N;
  const float* inv_b = inv + static_cast<size_t>(b) * N;
  const float* G_b = G + static_cast<size_t>(b) * kTaps * N * Rp + r;
  const size_t plane = static_cast<size_t>(b) * N * R + r;
  const float dbr = db[static_cast<size_t>(b) * Rp + r];  // zero on dead lanes
  const int n_rb = gridDim.x;

  for (int q0 = q_begin; q0 < q_end; q0 += kPB) {
    float mbq[kPB], coq[kPB], invq[kPB], dcoq[kPB], dmbq[kPB], dinvq[kPB];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int q = min(q0 + i, q_end - 1);
      mbq[i] = geo.mb_at(q);
      coq[i] = geo.co_at(q);
      invq[i] = inv_b[q];
      dcoq[i] = dmbq[i] = dinvq[i] = 0.0f;
    }
    if (q0 < cnt) {  // block-uniform: the group has live rows
      for (int pp = 0; pp < cnt; pp += kMaxStage) {
        const int p1 = min(pp + kMaxStage, cnt);
        float pdco[kPB], pdmb[kPB], pdinv[kPB];
#pragma unroll
        for (int i = 0; i < kPB; ++i) pdco[i] = pdmb[i] = pdinv[i] = 0.0f;
        for (int p = pp; p < p1; ++p) {
          const float mbp = geo.mb_at(p), sgp = sig_b[p];
          float Gp[kTaps];
#pragma unroll
          for (int k = 0; k < kTaps; ++k) Gp[k] = G_b[(static_cast<size_t>(k) * N + p) * Rp];
#pragma unroll
          for (int i = 0; i < kPB; ++i) {
            const float dd = mbp - mbq[i];
            float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
            for (int k = 0; k < kTaps; ++k) {
              float ee, gau;
              erf_and_gauss<ERF>((dd + tap_k(k) * sgp) * invq[i], ee, gau);
              pdco[i] -= Gp[k] * ee;
              const float gg = Gp[k] * gau;
              t0 += gg;
              t1 += tap_k(k) * gg;
            }
            const float nco = -kDerf * coq[i];
            const float s0 = nco * t0, s1 = nco * t1;
            pdmb[i] -= s0 * invq[i];
            pdinv[i] += s0 * dd + s1 * sgp;
          }
        }
#pragma unroll
        for (int i = 0; i < kPB; ++i) {
          dcoq[i] += pdco[i];
          dmbq[i] += pdmb[i];
          dinvq[i] += pdinv[i];
        }
      }
    }

    // rows past the count keep only the base path; live rows add the p
    // side's parts written before
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int q = q0 + i;
      if (q >= q_end) break;  // block-uniform
      const bool live = q < cnt;
      float e1, g1;
      erf_and_gauss<ERF>(-mbq[i] * invq[i], e1, g1);
      const float derf1 = kDerf * dbr * coq[i] * g1;
      const size_t at = plane + static_cast<size_t>(q) * R;
      if (live_ray) {
        const float pco = live ? dco[at] : 0.0f, pmb = live ? dmb[at] : 0.0f;
        dco[at] = pco + (live ? dcoq[i] : 0.0f) + dbr * e1;
        dmb[at] = pmb + (live ? dmbq[i] : 0.0f) - derf1 * invq[i];
      }
      const float v[1] = {(live ? dinvq[i] : 0.0f) - derf1 * mbq[i]};
      row_sums<1>(v, red, rows_q + (static_cast<size_t>(b) * n_rb + rblk) * N + q);
    }
  }
}

// One thread per (tile, row): dsigma, dinv and dalbedo summed over the ray
// blocks in order; dsigma and dalbedo are zero past the count.
template <bool COLORS>
__global__ void split_rows_kernel(const int* __restrict__ counts,
                                  const float* __restrict__ rows_p,
                                  const float* __restrict__ rows_q, float* __restrict__ dsig,
                                  float* __restrict__ dinv, float* __restrict__ dalb, int B,
                                  int N, int n_rb) {
  const size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<size_t>(B) * N) return;
  const int b = static_cast<int>(row / N);
  const int p = static_cast<int>(row % N);
  const bool live = p < max(0, min(counts[b], N));
  float s[kPSums] = {0.0f, 0.0f, 0.0f, 0.0f}, si = 0.0f;
  for (int rb = 0; rb < n_rb; ++rb) {
    const size_t o = (static_cast<size_t>(b) * n_rb + rb) * N + p;
    si += rows_q[o];
    if (live) {
#pragma unroll
      for (int j = 0; j < kPSums; ++j) s[j] += rows_p[o * kPSums + j];
    }
  }
  dinv[row] = si;
  dsig[row] = s[0];
  if (COLORS) {
    dalb[3 * row] = s[1];
    dalb[3 * row + 1] = s[2];
    dalb[3 * row + 2] = s[3];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

using FwdKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const int*, float*, float*, int, int, int, int);
using PKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const int*, const float*, const float*, float*, float*, float*, float*,
                         float*, int, int, int, int);
using QKernel = void (*)(const float*, const float*, const float*, const float*, const int*,
                         const float*, const float*, float*, float*, float*, int, int, int);

template <int PB, bool COLORS>
FwdKernel pick_fwd_pb(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return split_fwd_kernel<PB, kErfAs5, kExpExact, COLORS>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return split_fwd_kernel<PB, kErfAs5, kExpFast, COLORS>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return split_fwd_kernel<PB, kErfAs3, kExpExact, COLORS>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return split_fwd_kernel<PB, kErfAs3, kExpFast, COLORS>;
  return nullptr;
}

template <bool COLORS>
PKernel pick_p(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return split_bwd_p_kernel<kErfAs5, kExpExact, COLORS>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return split_bwd_p_kernel<kErfAs5, kExpFast, COLORS>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return split_bwd_p_kernel<kErfAs3, kExpExact, COLORS>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return split_bwd_p_kernel<kErfAs3, kExpFast, COLORS>;
  return nullptr;
}

QKernel pick_q(int erf_id) {
  if (erf_id == kErfAs5) return split_bwd_q_kernel<kErfAs5>;
  if (erf_id == kErfAs3) return split_bwd_q_kernel<kErfAs3>;
  return nullptr;
}

unsigned blocks_for(size_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

bool bad_shape(int B, int N, int R, int threads, int qb) {
  return B < 1 || B > 65535 || N < 1 || R < 1 || threads < 32 || threads > kMaxThreads ||
         threads % 32 != 0 || qb < 1 || qb > 1024;
}

template <bool COLORS>
int launch_fwd(const float* mb, const float* co, const float* sig, const float* inv,
               const float* alb, const int* counts, float* tw, float* partial, float* colors,
               int B, int N, int R, int threads, int pb, int qb, int erf_id, int exp_id,
               void* stream) {
  FwdKernel fn = nullptr;
  if (pb == 8) fn = pick_fwd_pb<8, COLORS>(erf_id, exp_id);
  if (pb == 16) fn = pick_fwd_pb<16, COLORS>(erf_id, exp_id);
  const int n_split = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  if (fn == nullptr || bad_shape(B, N, R, threads, qb) || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qs = min(qb, kMaxStage);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * PlaneGeo::stage_floats(qs, threads);
  fn<<<dim3((R + threads - 1) / threads, n_split, B), threads, smem, s>>>(
      mb, co, sig, inv, alb, counts, tw, partial, N, R, qs, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !COLORS) return static_cast<int>(err);
  // colors = the live splits' partials summed in split order
  return static_cast<int>(
      launch_block_sums(partial, counts, colors, B, N, 3 * R, n_split, kRowsPerBlock, 0, s));
}

template <bool COLORS>
int launch_bwd(const float* mb, const float* co, const float* sig, const float* inv,
               const float* alb, const int* counts, const float* g, const float* dcol,
               float* scratch, float* dmb, float* dco, float* dsig, float* dinv, float* dalb,
               int B, int N, int R, int threads, int qb, int erf_id, int exp_id, void* stream) {
  PKernel pfn = pick_p<COLORS>(erf_id, exp_id);
  QKernel qfn = pick_q(erf_id);
  const int nblk = (N + kRows - 1) / kRows;
  if (pfn == nullptr || qfn == nullptr || bad_shape(B, N, R, threads, qb) || nblk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qs = min(qb, kMaxStage);
  const int n_rb = (R + threads - 1) / threads;
  const int Rp = n_rb * threads;
  Scratch sc;
  scratch_layout(B, N, R, threads, scratch, &sc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_p = sizeof(float) * (PlaneGeo::stage_floats(qs, threads) + kWarps * kPSums);
  cudaError_t err;
  pfn<<<dim3(n_rb, nblk, B), threads, smem_p, st>>>(mb, co, sig, inv, alb, counts, g, dcol, sc.G,
                                                    sc.db_part, sc.rows_p, dmb, dco, N, R, Rp, qs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // db = the live 64-row blocks summed in block order
  if ((err = launch_block_sums(sc.db_part, counts, sc.db, B, N, Rp, nblk, kRows, 0, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  qfn<<<dim3(n_rb, nblk, B), threads, 0, st>>>(mb, co, sig, inv, counts, sc.G, sc.db, sc.rows_q,
                                               dmb, dco, N, R, Rp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  split_rows_kernel<COLORS><<<blocks_for(static_cast<size_t>(B) * N, 256), 256, 0, st>>>(
      counts, sc.rows_p, sc.rows_q, dsig, dinv, dalb, B, N, n_rb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sgrt_split_fwd_rows_per_block() { return kRowsPerBlock; }

int sgrt_split_max_threads() { return kMaxThreads; }

// Floats of scratch that one backward launch needs (either backward).
long long sgrt_split_bwd_scratch_floats(int B, int N, int R, int threads) {
  return static_cast<long long>(scratch_layout(B, N, R, threads));
}

const char* sgrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// tw (B,N,R) from the planes. Returns a cudaError_t (cudaErrorInvalidValue
// for a configuration the kernels do not take).
int sgrt_split_fwd(const float* mb, const float* co, const float* sig, const float* inv,
                   const int* counts, float* tw, int B, int N, int R, int threads, int pb,
                   int qb, int erf_id, int exp_id, void* stream) {
  return launch_fwd<false>(mb, co, sig, inv, nullptr, counts, tw, nullptr, nullptr, B, N, R,
                           threads, pb, qb, erf_id, exp_id, stream);
}

// colors (B,3,R) from the planes and albedo; partial (B, N/32, 3, R) scratch.
int sgrt_split_fwd_color(const float* mb, const float* co, const float* sig, const float* inv,
                         const float* alb, const int* counts, float* partial, float* colors,
                         int B, int N, int R, int threads, int pb, int qb, int erf_id,
                         int exp_id, void* stream) {
  return launch_fwd<true>(mb, co, sig, inv, alb, counts, nullptr, partial, colors, B, N, R,
                          threads, pb, qb, erf_id, exp_id, stream);
}

// The VJP of sgrt_split_fwd for g (B,N,R): dmb, dco (B,N,R), dsig, dinv (B,N).
int sgrt_split_bwd(const float* mb, const float* co, const float* sig, const float* inv,
                   const int* counts, const float* g, float* scratch, float* dmb, float* dco,
                   float* dsig, float* dinv, int B, int N, int R, int threads, int qb,
                   int erf_id, int exp_id, void* stream) {
  return launch_bwd<false>(mb, co, sig, inv, nullptr, counts, g, nullptr, scratch, dmb, dco,
                           dsig, dinv, nullptr, B, N, R, threads, qb, erf_id, exp_id, stream);
}

// The VJP of sgrt_split_fwd_color for dcol (B,3,R): as sgrt_split_bwd, plus
// dalb (B,N,3).
int sgrt_split_bwd_color(const float* mb, const float* co, const float* sig, const float* inv,
                         const float* alb, const int* counts, const float* dcol, float* scratch,
                         float* dmb, float* dco, float* dsig, float* dinv, float* dalb, int B,
                         int N, int R, int threads, int qb, int erf_id, int exp_id,
                         void* stream) {
  return launch_bwd<true>(mb, co, sig, inv, alb, counts, nullptr, dcol, scratch, dmb, dco, dsig,
                          dinv, dalb, B, N, R, threads, qb, erf_id, exp_id, stream);
}

}  // extern "C"
