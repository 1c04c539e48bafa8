// Gaussian-axis chunked backward of the Gaussian ray tracer for Hopper
// (sm_90a): from the colors' cotangent dcol to the gradients of the raw tile
// scene and of the ray directions, with the Gaussian axis cut into chunks of
// ck rows.
//
// Replaces the TPU kernels sgrt_tpu/ops/pallas_chunked.py::_chunked_bwd_t_kernel
// (saved-T, launched by _chunked_bwd_t_call; entry point sgrt_chunked_bwd_t)
// and ::_chunked_bwd_kernel (recompute, launched by _chunked_bwd_call; entry
// point sgrt_chunked_bwd). Both run one template, bwd_p_kernel<..., SAVED_T>,
// and the kernels after it; they differ only in where T comes from.
//
// The function is the fused backward's VJP (fused_bwd.cu's note, same
// definitions and rounding). Every cotangent that reaches the raw inputs is
// LINEAR in the per-(row, ray) sums (dco, dmb, dinv, dsig_p, the albedo
// weight), and the base path is linear in db (pallas_chunked.py:46-51). So
// the pair work is split in two and summed in any fixed order:
//   p side (bwd_p_kernel), per live p row and ray, over every live q:
//     dmb_p += S0 inv_q, dsig_p += S1 inv_q; plus the direct terms
//     dco_p += sqrt(2/pi) tw_p A_p and dalb_p's weight sqrt(2/pi) co_p tw_p
//   q side (bwd_q_kernel), per live q row and ray, over the p rows of ONE
//     p-chunk a: dco_q -= sum_k G_k ee_k, dmb_q -= S0 inv_q,
//     dinv_q += S0 (mb_p - mb_q) + S1 sigma_p; then the base path with
//     chunk a's partial db_a = sum_{p in a} g_p tw_p, as the Pallas kernel
//     chains it per (a, bq) (pallas_chunked.py:493-508).
// Each side chains its sums through the prep (dcoco = dco co, dmb += dcoco
// 2/(2 sigma^2) mb) and reduces them over the block's rays into ten per-row
// sums; bwd_rows_kernel adds the p side's and the q side's and forms doc,
// dsig, dmag, dalb as fused_bwd.cu's bwd_rows_kernel does; ddirs sums the
// per-block partials of sum oc dmb, whose pair terms the p side adds as
// (oc_p - oc_q) S0 inv_q: the two sides' separate shares cancel, and summed
// apart they lost ~30x the plain version's accuracy at ~4000 rows. The host
// loops over p-chunks a in order (P, db_a, Q per chunk), so sums carried
// across chunks (the q side's) are read-modify-writes in stream order:
// deterministic, no atomics.
//
// T: the saved-T backward reads T (B,5,N,R) written by the forward-with-T
// (sgrt_fused_fwd_t, fused_fwd.cu, which the chunked route's forwards
// launch). The recompute backward has bwd_p_kernel redo pass A for its rows
// with the forward's pass_a and the same qb, so its T equals the forward's
// bit for bit, and write chunk a's T to a scratch of B x 5 x ck x Rp floats,
// which bwd_q_kernel reads.
//
// What bounds it on this card: operations. Per live (p, q, ray), the q side
// evaluates five erf-and-gauss taps (~17 FP32, 2 SFU each, plus ~4 to fold
// the cotangents) and the p side five exp(-x^2) (~7 FP32, 1 SFU each, plus
// ~3): about 155 FP32 instructions and 15 SFU operations per pair, against
// the fused backward's ~113 and 10, the price of splitting the sides so
// that neither needs a (row, ray) plane per p block. The recompute variant
// adds pass A (five erf taps per pair). Bytes: T is read once per q row
// group of 8 (2.5 B per pair and ray), well under the operations' time.
//
// What the design does about it:
//   * Blocks of 64 rows: bwd_p_kernel runs one block per (ray block, 64 p
//     rows of chunk a, tile), bwd_q_kernel one per (ray block, 64 q rows,
//     tile); a 5000-row tile spreads over ~80 blocks of each. The TPU's
//     serial grid and the fused backward's serial p loop (PERF.md: 2.7% of
//     its bound, the densest tile's block bounding the launch) are gone.
//   * One thread owns one ray and keeps 8 rows' state in registers (p side:
//     G_k, mb, sigma, dmb_p, dsig_p; q side: mb, co, inv, dco, dmb, dinv);
//     the other side's rows are staged through shared memory. The q side
//     reads G_k = g_p T_k(p, r) from T, coalesced across the warp's rays.
//   * Per-row sums over rays are a warp butterfly then warps in order in
//     shared memory, written once per (tile, ray block, row): no (row, ray)
//     plane ever reaches device memory, so the scratch is bounded by the
//     launch's tiles x rows, not tiles x rows x rays x chunks.
//   * Float32 at thousands of rows: every sum over the other side's rows
//     is two-level (each staged block of qb rows on its own, then the
//     running sum), since dco and T are differences of such sums; ddirs'
//     shares are accumulated in double, since the p side's and the q
//     side's chain terms cancel ~25x (measured on the 50k-Gaussian sphere).
//   * mb, |oc|^2 and |oc|^2 - mb^2 round as the plain version rounds them.
// Peak scratch, B tiles, N = C ck rows, R rays in n_rb blocks of Rp/n_rb:
//   rows_p, rows_q  2 x B n_rb N 10 floats   (0.88 GB)
//   dd_p, dd_q      2 x B (N/64) 3 Rp doubles (1.06 GB)
//   db_part, db     B (ck/64 + 1) Rp         (0.03 GB)
//   t_a (recompute) B 5 ck Rp                (9.4 GB)
// in brackets at the 50k-Gaussian sphere's whole 512^2 frame (B = 2048,
// N = 5376, ck = 1792, R = 128); a launch of fewer tiles scales them down.
//
// Layouts (float32 unless noted, contiguous): oc, albedo (B,N,3); sigma,
// mag (B,N); dirs, dcol (B,3,R); counts (B,) int32; t (B,5,N,R) (saved-T
// only); scratch as above (sgrt_chunked_bwd_scratch_floats); outputs doc,
// dalb (B,N,3), dsig, dmag (B,N), ddirs (B,3,R). Rows at or past the count
// get exactly zero gradient.

#include <cuda_runtime.h>

#include "gauss_common.cuh"

namespace {

using namespace sgrt;

constexpr int kPB = 8;           // rows a thread keeps in registers
constexpr int kRows = 64;        // rows per block; divides every chunk (ck % 128 == 0)
constexpr int kMaxThreads = 128;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kSums = 10;        // per-row sums over rays, in this order:
enum { kRow, kQmb, kDsig, kDinv, kOx, kOy, kOz, kAx, kAy, kAz };
constexpr int kPFields = 10;     // p rows staged for the q side: x y z |oc|^2 1/(2s^2)
                                 // mag s sqrt(pi/2), sigma, albedo rgb

// One row's kSums values summed over the block's rays in a fixed order
// (warp butterfly, then the warps in order); thread j < kSums writes sum j
// to out[j], or adds it with accumulate. Every thread of the block calls it.
__device__ __forceinline__ void row_sums(const float (&v)[kSums], float* red, float* out,
                                         bool accumulate) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    const float s = warp_sum(v[j]);
    if (lane == 0) red[warp * kSums + j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.0f;
    const int nw = blockDim.x >> 5;
    for (int w = 0; w < nw; ++w) s += red[w * kSums + threadIdx.x];
    out[threadIdx.x] = accumulate ? out[threadIdx.x] + s : s;
  }
  __syncthreads();
}

struct Scratch {
  float* rows_p;   // (B, n_rb, N, kSums)
  float* rows_q;   // (B, n_rb, N, kSums), summed over p chunks
  double* dd_p;    // (B, N/kRows, 3, Rp)
  double* dd_q;    // (B, N/kRows, 3, Rp), summed over p chunks
  float* db_part;  // (B, ck/kRows, Rp)
  float* db;       // (B, Rp)
  float* t_a;      // (B, kTaps, ck, Rp), recompute only
};

// Floats of the scratch; with base, also the pointers into it.
size_t scratch_layout(int B, int N, int R, int ck, int threads, bool recompute,
                      float* base = nullptr, Scratch* s = nullptr) {
  const size_t n_rb = (R + threads - 1) / threads;
  const size_t Rp = n_rb * threads;
  // in floats; the double buffers first, so that they stay 8-byte aligned
  const size_t dd = 2 * static_cast<size_t>(B) * (N / kRows) * 3 * Rp;
  const size_t sizes[7] = {
      dd, dd, static_cast<size_t>(B) * n_rb * N * kSums, static_cast<size_t>(B) * n_rb * N * kSums,
      static_cast<size_t>(B) * (ck / kRows) * Rp, static_cast<size_t>(B) * Rp,
      recompute ? static_cast<size_t>(B) * kTaps * ck * Rp : 0};
  size_t off[8] = {0};
  for (int i = 0; i < 7; ++i) off[i + 1] = off[i] + sizes[i];
  if (s != nullptr) {
    s->dd_p = reinterpret_cast<double*>(base + off[0]);
    s->dd_q = reinterpret_cast<double*>(base + off[1]);
    s->rows_p = base + off[2];
    s->rows_q = base + off[3];
    s->db_part = base + off[4];
    s->db = base + off[5];
    s->t_a = recompute ? base + off[6] : nullptr;
  }
  return off[7];
}

// ---------------------------------------------------------------------------
// p side: the rows of one 64-row block of p-chunk a
// ---------------------------------------------------------------------------

template <int ERF, int EXP, bool SAVED_T>
__global__ void __launch_bounds__(kMaxThreads)
bwd_p_kernel(const float* __restrict__ oc, const float* __restrict__ sig,
             const float* __restrict__ mag, const float* __restrict__ alb,
             const float* __restrict__ dirs, const int* __restrict__ counts,
             const float* __restrict__ dcol, const float* __restrict__ tsave,
             float* __restrict__ t_a, float* __restrict__ rows_p, double* __restrict__ dd_p,
             float* __restrict__ db_part, int N, int R, int Rp, int ck, int a, int qb) {
  extern __shared__ float smem[];
  float* stage = smem;
  float* red = smem + kStageFields * qb;
  const int b = blockIdx.z, blk = blockIdx.y, rblk = blockIdx.x;
  const int r = rblk * blockDim.x + threadIdx.x;  // < Rp always
  const int cnt = max(0, min(counts[b], N));
  const int p_begin = a * ck + blk * kRows;
  if (p_begin >= cnt) return;  // block-uniform; the sums after skip dead blocks
  const int p_end = min(p_begin + kRows, cnt);
  // Lanes past R trace a unit +z ray with a zero cotangent: every sum they
  // make is zero.
  const bool live_ray = r < R;
  float dx = 0.0f, dy = 0.0f, dz = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (live_ray) {
    const size_t o = static_cast<size_t>(b) * 3 * R;
    dx = dirs[o + r];
    dy = dirs[o + R + r];
    dz = dirs[o + 2 * R + r];
    cr = dcol[o + r];
    cg = dcol[o + R + r];
    cb = dcol[o + 2 * R + r];
  }
  const size_t row0 = static_cast<size_t>(b) * N;
  const float* oc_b = oc + row0 * 3;
  const float* sig_b = sig + row0;
  const float* mag_b = mag + row0;
  const float* alb_b = alb + row0 * 3;
  const int n_rb = gridDim.x;

  float base = 0.0f, db = 0.0f;
  double gx = 0.0, gy = 0.0, gz = 0.0;  // ddirs' share: its terms cancel, so in double
  for (int p0 = p_begin; p0 < p_end; p0 += kPB) {
    float mbp[kPB], sgp[kPB], G[kPB][kTaps];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      mbp[i] = 0.0f;
      sgp[i] = 1.0f;
      if (p < p_end) {
        mbp[i] = dot3_rn(oc_b[3 * p], oc_b[3 * p + 1], oc_b[3 * p + 2], dx, dy, dz);
        sgp[i] = sig_b[p];
      }
#pragma unroll
      for (int k = 0; k < kTaps; ++k) G[i][k] = 0.0f;
    }

    if (SAVED_T) {
      if (live_ray) {
        const float* t_b = tsave + static_cast<size_t>(b) * kTaps * N * R + r;
#pragma unroll
        for (int i = 0; i < kPB; ++i) {
          const int p = p0 + i;
          if (p < p_end) {
#pragma unroll
            for (int k = 0; k < kTaps; ++k) G[i][k] = t_b[(static_cast<size_t>(k) * N + p) * R];
          }
        }
      }
    } else {
      // pass A over every live q (the forward's sweep); base is complete
      // after the first group's sweep
      pass_a<kPB, ERF, EXP>(stage, qb, IsoGeo(oc, sig, mag, b, N), 0, cnt, dx, dy, dz, mbp,
                            sgp, G, p0 == p_begin, base);
      float* ta_b = t_a + static_cast<size_t>(b) * kTaps * ck * Rp + r;
#pragma unroll
      for (int i = 0; i < kPB; ++i) {
        const int p = p0 + i;
        const bool live = p < p_end;  // a dead row's G stays 0
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          G[i][k] = live ? tap_weight(k) * exp_fn<EXP>(base - G[i][k]) : 0.0f;
          if (live) ta_b[(static_cast<size_t>(k) * ck + (p - a * ck)) * Rp] = G[i][k];
        }
      }
    }

    // G_k = g T_k, db, and the direct terms' inputs tw and A
    float A[kPB], tw[kPB];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      A[i] = tw[i] = 0.0f;
      if (p < p_end) {
        const Row w = load_row(oc_b, sig_b, mag_b, p);
        const float co = coeff<EXP>(w.cs, w.ocsq, mbp[i], w.i2s2);
        A[i] = alb_b[3 * p] * cr + alb_b[3 * p + 1] * cg + alb_b[3 * p + 2] * cb;
        const float g = kSqrt2Pi * co * A[i];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) tw[i] += G[i][k];
        db += g * tw[i];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) G[i][k] *= g;
      }
    }

    // the pair pass, p side: only exp(-x^2) of each tap is needed here. A
    // pair adds S0 inv_q to dmb_p and takes it from dmb_q, so its share of
    // ddirs = sum_rows oc dmb is (oc_p - oc_q) S0 inv_q: summed here as that
    // difference, since the two sides' separate sums of oc dmb are large and
    // cancel (the q side leaves its pair terms out of ddirs).
    float dmbp[kPB], dsigp[kPB], xp[kPB], yp[kPB], zp[kPB];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = min(p0 + i, p_end - 1);
      dmbp[i] = dsigp[i] = 0.0f;
      xp[i] = oc_b[3 * p];
      yp[i] = oc_b[3 * p + 1];
      zp[i] = oc_b[3 * p + 2];
    }
    for (int q0 = 0; q0 < cnt; q0 += qb) {
      const int nq = min(qb, cnt - q0);
      __syncthreads();
      stage_rows(stage, qb, oc_b, sig_b, mag_b, q0, nq);
      __syncthreads();
      // this stage's sums, added to the running ones after it (two-level
      // sums, as pass_a's): ddirs' pair terms, dmb_p, dsig_p
      float sx = 0.0f, sy = 0.0f, sz = 0.0f, pdmb[kPB], pdsig[kPB];
#pragma unroll
      for (int i = 0; i < kPB; ++i) pdmb[i] = pdsig[i] = 0.0f;
      for (int j = 0; j < nq; ++j) {
        const float xq = stage[j], yq = stage[qb + j], zq = stage[2 * qb + j];
        const float mbq = dot3_rn(xq, yq, zq, dx, dy, dz);
        const float co = coeff<EXP>(stage[6 * qb + j], stage[3 * qb + j], mbq, stage[4 * qb + j]);
        const float invq = stage[5 * qb + j];
        const float nco = -kDerf * co;
#pragma unroll
        for (int i = 0; i < kPB; ++i) {
          const float dd = mbp[i] - mbq;
          float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            const float x = (dd + tap_k(k) * sgp[i]) * invq;
            const float gg = G[i][k] * expf(-x * x);  // erf_and_gauss's gauss
            t0 += gg;
            t1 += tap_k(k) * gg;
          }
          const float s0 = nco * t0, s1 = nco * t1;
          const float di = s0 * invq;  // zero for a dead row (its G is 0)
          pdmb[i] += di;
          pdsig[i] += s1 * invq;
          sx += (xp[i] - xq) * di;
          sy += (yp[i] - yq) * di;
          sz += (zp[i] - zq) * di;
        }
      }
      gx += sx;
      gy += sy;
      gz += sz;
#pragma unroll
      for (int i = 0; i < kPB; ++i) {
        dmbp[i] += pdmb[i];
        dsigp[i] += pdsig[i];
      }
    }

    // the prep chain of each row, reduced over the block's rays
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      if (p >= p_end) break;  // block-uniform
      const Row w = load_row(oc_b, sig_b, mag_b, p);
      const float co = coeff<EXP>(w.cs, w.ocsq, mbp[i], w.i2s2);
      const float dcoco = kSqrt2Pi * tw[i] * A[i] * co;
      const float chain = dcoco * (2.0f * w.i2s2) * mbp[i];
      const float dmb = dmbp[i] + chain;
      const float wp = kSqrt2Pi * co * tw[i];
      const float v[kSums] = {dcoco, dcoco * ocsq_minus_mb2_rn(w.ocsq, mbp[i]), dsigp[i], 0.0f,
                              dmb * dx, dmb * dy, dmb * dz, wp * cr, wp * cg, wp * cb};
      gx += w.x * chain;  // the pair terms are in already
      gy += w.y * chain;
      gz += w.z * chain;
      row_sums(v, red, rows_p + ((static_cast<size_t>(b) * n_rb + rblk) * N + p) * kSums, false);
    }
  }

  db_part[(static_cast<size_t>(b) * (ck / kRows) + blk) * Rp + r] = db;
  double* dd = dd_p + (static_cast<size_t>(b) * (N / kRows) + p_begin / kRows) * 3 * Rp + r;
  dd[0] = gx;
  dd[Rp] = gy;
  dd[2 * static_cast<size_t>(Rp)] = gz;
}

// db_a[b, r] = sum over the live 64-row blocks of chunk a, in block order.
__global__ void db_sum_kernel(const int* __restrict__ counts, const float* __restrict__ db_part,
                              float* __restrict__ db, int B, int N, int Rp, int ck, int a) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * Rp) return;
  const int b = static_cast<int>(i / Rp);
  const int r = static_cast<int>(i % Rp);
  const int cnt = max(0, min(counts[b], N));
  const int nb = ck / kRows;
  const int live = min(max((cnt - a * ck + kRows - 1) / kRows, 0), nb);
  const float* src = db_part + static_cast<size_t>(b) * nb * Rp + r;
  float s = 0.0f;
  for (int z = 0; z < live; ++z) s += src[static_cast<size_t>(z) * Rp];
  db[i] = s;
}

// ---------------------------------------------------------------------------
// q side: the rows of one 64-row block against the p rows of chunk a
// ---------------------------------------------------------------------------

__device__ __forceinline__ void stage_p_rows(float* st, int qb, const float* oc,
                                             const float* sig, const float* mag,
                                             const float* alb, int p0, int np) {
  for (int j = threadIdx.x; j < np; j += blockDim.x) {
    const int p = p0 + j;
    const Row w = load_row(oc, sig, mag, p);
    st[j] = w.x;
    st[qb + j] = w.y;
    st[2 * qb + j] = w.z;
    st[3 * qb + j] = w.ocsq;
    st[4 * qb + j] = w.i2s2;
    st[5 * qb + j] = w.cs;
    st[6 * qb + j] = sig[p];
    st[7 * qb + j] = alb[3 * p];
    st[8 * qb + j] = alb[3 * p + 1];
    st[9 * qb + j] = alb[3 * p + 2];
  }
}

template <int ERF, int EXP>
__global__ void __launch_bounds__(kMaxThreads)
bwd_q_kernel(const float* __restrict__ oc, const float* __restrict__ sig,
             const float* __restrict__ mag, const float* __restrict__ alb,
             const float* __restrict__ dirs, const int* __restrict__ counts,
             const float* __restrict__ dcol, const float* __restrict__ tsrc, int t_rows,
             int t_row0, int t_ld, const float* __restrict__ db, float* __restrict__ rows_q,
             double* __restrict__ dd_q, int N, int R, int Rp, int ck, int a, int qb) {
  extern __shared__ float smem[];
  float* stage = smem;
  float* red = smem + kPFields * qb;
  const int b = blockIdx.z, blk = blockIdx.y, rblk = blockIdx.x;
  const int r = rblk * blockDim.x + threadIdx.x;
  const int cnt = max(0, min(counts[b], N));
  const int q_begin = blk * kRows;
  const int p_lo = a * ck, p_hi = min(p_lo + ck, cnt);
  if (q_begin >= cnt || p_lo >= p_hi) return;  // block-uniform
  const int q_end = min(q_begin + kRows, cnt);
  const bool live_ray = r < R;
  float dx = 0.0f, dy = 0.0f, dz = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (live_ray) {
    const size_t o = static_cast<size_t>(b) * 3 * R;
    dx = dirs[o + r];
    dy = dirs[o + R + r];
    dz = dirs[o + 2 * R + r];
    cr = dcol[o + r];
    cg = dcol[o + R + r];
    cb = dcol[o + 2 * R + r];
  }
  const float dbr = db[static_cast<size_t>(b) * Rp + r];  // zero on dead lanes
  const size_t row0 = static_cast<size_t>(b) * N;
  const float* oc_b = oc + row0 * 3;
  const float* sig_b = sig + row0;
  const float* mag_b = mag + row0;
  const float* alb_b = alb + row0 * 3;
  const float* t_b = tsrc + static_cast<size_t>(b) * kTaps * t_rows * t_ld;
  const int n_rb = gridDim.x;
  const bool accumulate = a > 0;

  double gx = 0.0, gy = 0.0, gz = 0.0;  // ddirs' share, in double as on the p side
  for (int q0 = q_begin; q0 < q_end; q0 += kPB) {
    float mbq[kPB], coq[kPB], invq[kPB], dco[kPB], dmb[kPB], dinv[kPB];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int q = q0 + i;
      mbq[i] = coq[i] = 0.0f;  // a dead row has co = 0: every sum it makes is zero
      invq[i] = kInvSqrt2;
      dco[i] = dmb[i] = dinv[i] = 0.0f;
      if (q < q_end) {
        const Row w = load_row(oc_b, sig_b, mag_b, q);
        mbq[i] = dot3_rn(w.x, w.y, w.z, dx, dy, dz);
        coq[i] = coeff<EXP>(w.cs, w.ocsq, mbq[i], w.i2s2);
        invq[i] = w.inv;
      }
    }
    for (int pp = p_lo; pp < p_hi; pp += qb) {
      const int np = min(qb, p_hi - pp);
      __syncthreads();
      stage_p_rows(stage, qb, oc_b, sig_b, mag_b, alb_b, pp, np);
      __syncthreads();
      // this stage's sums, added to the running ones after it: dco_q is the
      // difference of the direct term and these sums, and at thousands of p
      // rows a single running sum lost ~20x the plain version's accuracy
      float pdco[kPB], pdmb[kPB], pdinv[kPB];
#pragma unroll
      for (int i = 0; i < kPB; ++i) pdco[i] = pdmb[i] = pdinv[i] = 0.0f;
      for (int j = 0; j < np; ++j) {
        const float mbp = dot3_rn(stage[j], stage[qb + j], stage[2 * qb + j], dx, dy, dz);
        const float cop = coeff<EXP>(stage[5 * qb + j], stage[3 * qb + j], mbp, stage[4 * qb + j]);
        const float sgp = stage[6 * qb + j];
        const float g = kSqrt2Pi * cop *
                        (stage[7 * qb + j] * cr + stage[8 * qb + j] * cg + stage[9 * qb + j] * cb);
        float Gk[kTaps];
#pragma unroll
        for (int k = 0; k < kTaps; ++k)
          Gk[k] = live_ray
                      ? g * t_b[(static_cast<size_t>(k) * t_rows + (pp + j - t_row0)) * t_ld + r]
                      : 0.0f;
#pragma unroll
        for (int i = 0; i < kPB; ++i) {
          const float dd = mbp - mbq[i];
          float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            float ee, gau;
            erf_and_gauss<ERF>((dd + tap_k(k) * sgp) * invq[i], ee, gau);
            pdco[i] -= Gk[k] * ee;
            const float gg = Gk[k] * gau;
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
        dco[i] += pdco[i];
        dmb[i] += pdmb[i];
        dinv[i] += pdinv[i];
      }
    }

    // the base path with chunk a's db, then the prep chain, reduced over rays
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int q = q0 + i;
      if (q >= q_end) break;  // block-uniform
      const Row w = load_row(oc_b, sig_b, mag_b, q);
      float e1, g1;
      erf_and_gauss<ERF>(-mbq[i] * invq[i], e1, g1);
      const float derf1 = kDerf * dbr * coq[i] * g1;
      const float dcoco = (dco[i] + dbr * e1) * coq[i];
      const float single = dcoco * (2.0f * w.i2s2) * mbq[i] - derf1 * invq[i];
      const float dmbt = dmb[i] + single;
      const float v[kSums] = {dcoco, dcoco * ocsq_minus_mb2_rn(w.ocsq, mbq[i]), 0.0f,
                              dinv[i] - derf1 * mbq[i], dmbt * dx, dmbt * dy, dmbt * dz,
                              0.0f, 0.0f, 0.0f};
      gx += w.x * single;  // the pair terms are in bwd_p_kernel's share
      gy += w.y * single;
      gz += w.z * single;
      row_sums(v, red, rows_q + ((static_cast<size_t>(b) * n_rb + rblk) * N + q) * kSums,
               accumulate);
    }
  }

  double* dd = dd_q + (static_cast<size_t>(b) * (N / kRows) + blk) * 3 * Rp + r;
  dd[0] = accumulate ? dd[0] + gx : gx;
  dd[Rp] = accumulate ? dd[Rp] + gy : gy;
  dd[2 * static_cast<size_t>(Rp)] = accumulate ? dd[2 * static_cast<size_t>(Rp)] + gz : gz;
}

// ---------------------------------------------------------------------------
// per-row gradients and ddirs from the partial sums
// ---------------------------------------------------------------------------

// One thread per (tile, row): the p side's and the q side's sums over the
// ray blocks in order, then the per-row gradients; rows at or past the count
// are written as zeros.
__global__ void bwd_rows_kernel(const float* __restrict__ oc, const float* __restrict__ sig,
                                const float* __restrict__ mag, const int* __restrict__ counts,
                                const float* __restrict__ rows_p,
                                const float* __restrict__ rows_q, float* __restrict__ doc,
                                float* __restrict__ dsig, float* __restrict__ dmag,
                                float* __restrict__ dalb, int B, int N, int n_rb) {
  const size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<size_t>(B) * N) return;
  const int b = static_cast<int>(row / N);
  const int q = static_cast<int>(row % N);
  const int cnt = max(0, min(counts[b], N));
  if (q >= cnt) {
    doc[3 * row] = doc[3 * row + 1] = doc[3 * row + 2] = 0.0f;
    dalb[3 * row] = dalb[3 * row + 1] = dalb[3 * row + 2] = 0.0f;
    dsig[row] = dmag[row] = 0.0f;
    return;
  }
  float s[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) s[j] = 0.0f;
  for (int rb = 0; rb < n_rb; ++rb) {
    const size_t o = ((static_cast<size_t>(b) * n_rb + rb) * N + q) * kSums;
#pragma unroll
    for (int j = 0; j < kSums; ++j) s[j] += rows_p[o + j] + rows_q[o + j];
  }
  const float x = oc[3 * row], y = oc[3 * row + 1], z = oc[3 * row + 2];
  const float sg = sig[row];
  const float i2s2 = 1.0f / (2.0f * sg * sg);
  const float inv = kInvSqrt2 / sg;
  const float docsq = s[kRow] * (-i2s2);
  dsig[row] = s[kDsig] + s[kDinv] * (-inv / sg) + s[kRow] / sg + s[kQmb] / (sg * sg * sg);
  const float m = mag[row];
  // guard only mag == 0 (inert rows): a negative magnitude keeps its sign
  dmag[row] = m * s[kRow] / (m == 0.0f ? 1.0f : m * m);
  doc[3 * row] = s[kOx] + 2.0f * x * docsq;
  doc[3 * row + 1] = s[kOy] + 2.0f * y * docsq;
  doc[3 * row + 2] = s[kOz] + 2.0f * z * docsq;
  dalb[3 * row] = s[kAx];
  dalb[3 * row + 1] = s[kAy];
  dalb[3 * row + 2] = s[kAz];
}

// ddirs[b, c, r] = the p side's live blocks in order, then the q side's.
__global__ void bwd_ddirs_kernel(const int* __restrict__ counts, const double* __restrict__ dd_p,
                                 const double* __restrict__ dd_q, float* __restrict__ ddirs,
                                 int B, int N, int R, int Rp) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t per_tile = static_cast<size_t>(3) * R;
  if (i >= per_tile * B) return;
  const int b = static_cast<int>(i / per_tile);
  const int c = static_cast<int>((i % per_tile) / R);
  const int r = static_cast<int>(i % R);
  const int cnt = max(0, min(counts[b], N));
  const int live = (cnt + kRows - 1) / kRows;
  const size_t stride = static_cast<size_t>(3) * Rp;
  const size_t o = static_cast<size_t>(b) * (N / kRows) * stride + static_cast<size_t>(c) * Rp + r;
  double s = 0.0;
  for (int z = 0; z < live; ++z) s += dd_p[o + z * stride];
  for (int z = 0; z < live; ++z) s += dd_q[o + z * stride];
  ddirs[i] = static_cast<float>(s);
}

using PKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const int*, const float*, const float*, float*, float*, double*,
                         float*, int, int, int, int, int, int);
using QKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const int*, const float*, const float*, int, int, int, const float*,
                         float*, double*, int, int, int, int, int, int);

template <bool SAVED_T>
PKernel pick_p(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return bwd_p_kernel<kErfAs5, kExpExact, SAVED_T>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return bwd_p_kernel<kErfAs5, kExpFast, SAVED_T>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return bwd_p_kernel<kErfAs3, kExpExact, SAVED_T>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return bwd_p_kernel<kErfAs3, kExpFast, SAVED_T>;
  return nullptr;
}

QKernel pick_q(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return bwd_q_kernel<kErfAs5, kExpExact>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return bwd_q_kernel<kErfAs5, kExpFast>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return bwd_q_kernel<kErfAs3, kExpExact>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return bwd_q_kernel<kErfAs3, kExpFast>;
  return nullptr;
}

unsigned blocks_for(size_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

template <bool SAVED_T>
int launch(const float* oc, const float* sig, const float* mag, const float* alb,
           const float* dirs, const int* counts, const float* dcol, const float* t,
           float* scratch, float* doc, float* dsig, float* dmag, float* dalb, float* ddirs,
           int B, int N, int R, int ck, int threads, int qb, int erf_id, int exp_id,
           void* stream) {
  PKernel pfn = pick_p<SAVED_T>(erf_id, exp_id);
  QKernel qfn = pick_q(erf_id, exp_id);
  if (pfn == nullptr || qfn == nullptr || B < 1 || B > 65535 || N < 1 || R < 1 ||
      ck < kRows || ck % kRows != 0 || N % ck != 0 || N / kRows > 65535 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || qb < 1 || qb > 1024 ||
      (SAVED_T && t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Scratch s;
  scratch_layout(B, N, R, ck, threads, !SAVED_T, scratch, &s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rb = (R + threads - 1) / threads;
  const int Rp = n_rb * threads;
  const size_t smem_p = sizeof(float) * (kStageFields * qb + kWarps * kSums);
  const size_t smem_q = sizeof(float) * (kPFields * qb + kWarps * kSums);
  cudaError_t err;
  for (int a = 0; a < N / ck; ++a) {
    pfn<<<dim3(n_rb, ck / kRows, B), threads, smem_p, st>>>(
        oc, sig, mag, alb, dirs, counts, dcol, t, s.t_a, s.rows_p, s.dd_p, s.db_part, N, R, Rp,
        ck, a, qb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    db_sum_kernel<<<blocks_for(static_cast<size_t>(B) * Rp, 256), 256, 0, st>>>(
        counts, s.db_part, s.db, B, N, Rp, ck, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    qfn<<<dim3(n_rb, N / kRows, B), threads, smem_q, st>>>(
        oc, sig, mag, alb, dirs, counts, dcol, SAVED_T ? t : s.t_a, SAVED_T ? N : ck,
        SAVED_T ? 0 : a * ck, SAVED_T ? R : Rp, s.db, s.rows_q, s.dd_q, N, R, Rp, ck, a, qb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  bwd_rows_kernel<<<blocks_for(static_cast<size_t>(B) * N, 256), 256, 0, st>>>(
      oc, sig, mag, counts, s.rows_p, s.rows_q, doc, dsig, dmag, dalb, B, N, n_rb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_ddirs_kernel<<<blocks_for(static_cast<size_t>(B) * 3 * R, 256), 256, 0, st>>>(
      counts, s.dd_p, s.dd_q, ddirs, B, N, R, Rp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sgrt_chunked_bwd_max_threads() { return kMaxThreads; }

// Floats of scratch that one launch needs (recompute: the backward without
// saved T).
long long sgrt_chunked_bwd_scratch_floats(int B, int N, int R, int ck, int threads,
                                          int recompute) {
  return static_cast<long long>(scratch_layout(B, N, R, ck, threads, recompute != 0));
}

const char* sgrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Saved-T chunked backward: reads T (B,5,N,R) from sgrt_fused_fwd_t.
// Returns a cudaError_t (cudaErrorInvalidValue for a configuration the
// kernels do not take).
int sgrt_chunked_bwd_t(const float* oc, const float* sig, const float* mag, const float* alb,
                       const float* dirs, const int* counts, const float* dcol, const float* t,
                       float* scratch, float* doc, float* dsig, float* dmag, float* dalb,
                       float* ddirs, int B, int N, int R, int ck, int threads, int qb,
                       int erf_id, int exp_id, void* stream) {
  return launch<true>(oc, sig, mag, alb, dirs, counts, dcol, t, scratch, doc, dsig, dmag, dalb,
                      ddirs, B, N, R, ck, threads, qb, erf_id, exp_id, stream);
}

// Recompute chunked backward: pass A is redone per p chunk into scratch.
int sgrt_chunked_bwd(const float* oc, const float* sig, const float* mag, const float* alb,
                     const float* dirs, const int* counts, const float* dcol, float* scratch,
                     float* doc, float* dsig, float* dmag, float* dalb, float* ddirs, int B,
                     int N, int R, int ck, int threads, int qb, int erf_id, int exp_id,
                     void* stream) {
  return launch<false>(oc, sig, mag, alb, dirs, counts, dcol, nullptr, scratch, doc, dsig, dmag,
                       dalb, ddirs, B, N, R, ck, threads, qb, erf_id, exp_id, stream);
}

}  // extern "C"
