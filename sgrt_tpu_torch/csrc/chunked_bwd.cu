// Gaussian-axis chunked backward of the Gaussian ray tracer for Hopper
// (sm_90a): from the colors' cotangent dcol to the gradients of the raw tile
// scene and of the ray directions, with the Gaussian axis cut into chunks of
// ck rows.
//
// Replaces the TPU kernels sgrt_tpu/ops/pallas_chunked.py::_chunked_bwd_t_kernel
// (saved-T, launched by _chunked_bwd_t_call; entry point sgrt_chunked_bwd_t)
// and ::_chunked_bwd_kernel (recompute, launched by _chunked_bwd_call; entry
// point sgrt_chunked_bwd). Both run one template, bwd_p_kernel<Geo, ...,
// SAVED_T> and the kernels after it, over a row geometry of gauss_common.cuh;
// they differ only in where T comes from. The anisotropic chunked backward
// (chunked_aniso.cu) has kernels of its own designed for the card; it shares
// the scratch and the chains of chunked_common.cuh's Side<Geo> (what the
// geometries do differently) with these.
//
// The function is the fused backward's VJP (fused_bwd.cu's note, same
// definitions and rounding). Every cotangent that reaches the raw inputs is
// LINEAR in the per-(row, ray) sums (dco, dmb, dinv, dsb_p, the albedo
// weight), and the base path is linear in db (pallas_chunked.py:46-51). So
// the pair work is split in two and summed in any fixed order:
//   p side (bwd_p_kernel), per live p row and ray, over every live q:
//     dmb_p += S0 inv_q, dsb_p += S1 inv_q; plus the direct terms
//     dco_p += sqrt(2/pi) tw_p A_p and dalb_p's weight sqrt(2/pi) co_p tw_p
//   q side (bwd_q_kernel), per live q row and ray, over the p rows of ONE
//     p-chunk a: dco_q -= sum_k G_k ee_k, dmb_q -= S0 inv_q,
//     dinv_q += S0 (mb_p - mb_q) + S1 sb_p; then the base path with
//     chunk a's partial db_a = sum_{p in a} g_p tw_p, as the Pallas kernel
//     chains it per (a, bq) (pallas_chunked.py:493-508).
// Each side chains its own sums through the geometry's prep and reduces
// them over the block's rays into ten per-row sums; bwd_rows_kernel adds the
// p side's and the q side's and forms the per-row gradients as fused_bwd.cu's
// row reductions do. The chains are linear too, so they split by side
// exactly, as the reference splits them (pallas_chunked_aniso.py:333-348:
// dsb on the p side, dinv on the q side):
//   isotropic: dcoco = dco co, dmb += dcoco 2/(2 sigma^2) mb; sums s_row,
//     s_qmb, dsig_p, dinv_q, sum dmb d, dalb's weight;
//   anisotropic: dcoco = dco co, dsb_tot = dsb + dcoco/sb - dinv inv/sb,
//     dBt = dmb sb^2 + dcoco mb, dA = -dmb mb sb^2 - dsb_tot sb^3/2 -
//     dcoco mb^2/2; sums s_row and, in u = oc - mb d where their terms do
//     not cancel (Side<AnisoGeo>::chain), P = sum (dBt d - dcoco oc) and
//     Q = sum (dA d^2 + dBt d oc - dcoco oc^2/2), and dalb's weight; then
//     doc = invd P, dinvd = Q, dmag = s_row / mag (fused_bwd.cu's
//     bwd_rows_aniso_kernel forms the same from sums that cancel).
// ddirs sums the per-block partials of each row's chain. A row's dmb reaches
// ddirs through J = d mb / d d (isotropic: oc; anisotropic: sb^2 (M - 2 mb
// invd d), M = oc invd), and a pair adds S0 inv_q to dmb_p and takes it
// from dmb_q, so the pair's share is (J_p - J_q) S0 inv_q: the p side sums it
// as that difference and the q side leaves its pair terms out of ddirs,
// since the two sides' separate sums are large and cancel (summed apart
// they lost ~30x the plain version's accuracy at ~4000 isotropic rows). The
// host loops over p-chunks a in order (P, db_a, Q per chunk), so sums
// carried across chunks (the q side's) are read-modify-writes in stream
// order: deterministic, no atomics.
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
// adds pass A (five erf taps per pair). Anisotropic rows (chunked_aniso.cu)
// add their terms per staged row and ray (~38 FP32, 3 SFU: A, Bt, two
// square roots and a division) and on the p side J_q (~10 FP32). Bytes:
// T is read once per q row group of 8 (2.5 B per pair and ray), well under
// the operations' time.
//
// What the design does about it:
//   * Blocks of 64 rows: bwd_p_kernel runs one block per (ray block, 64 p
//     rows of chunk a, tile), bwd_q_kernel one per (ray block, 64 q rows,
//     tile); a 5000-row tile spreads over ~80 blocks of each. The TPU's
//     serial grid and the fused backward's serial p loop (PERF.md: 2.7% of
//     its bound, the densest tile's block bounding the launch) are gone.
//   * One thread owns one ray and keeps 8 rows' state in registers (p side:
//     G_k, mb, sb, dmb_p, dsb_p, J_p; q side: mb, co, inv, dco, dmb, dinv);
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
//   * mb, |oc|^2 and |oc|^2 - mb^2 (isotropic) and A, Bt, C (anisotropic)
//     round as the plain version rounds them.
// Peak scratch, B tiles, N = C ck rows, R rays in n_rb blocks of Rp/n_rb:
//   rows_p, rows_q  2 x B n_rb N 10 floats   (0.88 GB)
//   dd_p, dd_q      2 x B (N/64) 3 Rp doubles (1.06 GB)
//   db_part, db     B (ck/64 + 1) Rp         (0.03 GB)
//   t_a (recompute) B 5 ck Rp                (9.4 GB)
// in brackets at the 50k-Gaussian sphere's whole 512^2 frame (B = 2048,
// N = 5376, ck = 1792, R = 128); a launch of fewer tiles scales them down.
//
// Layouts (float32 unless noted, contiguous): oc, albedo (B,N,3); sigma
// (B,N) or invd (B,N,3); mag (B,N); dirs, dcol (B,3,R); counts (B,) int32;
// t (B,5,N,R) (saved-T only); scratch as above
// (sgrt_chunked_bwd_scratch_floats); outputs doc, dalb (B,N,3), dsig (B,N)
// or dinvd (B,N,3), dmag (B,N), ddirs (B,3,R). Rows at or past the count
// get exactly zero gradient.

#include <cuda_runtime.h>

#include "chunked_common.cuh"
#include "gauss_common.cuh"

namespace {

using namespace sgrt;

constexpr int kPB = 8;           // rows a thread keeps in registers
constexpr int kMaxThreads = 128;
constexpr int kWarps = kMaxThreads / 32;

// ---------------------------------------------------------------------------
// p side: the rows of one 64-row block of p-chunk a
// ---------------------------------------------------------------------------

template <class Geo, int ERF, int EXP, bool SAVED_T>
__global__ void __launch_bounds__(kMaxThreads)
bwd_p_kernel(const float* __restrict__ oc, const float* __restrict__ shape,
             const float* __restrict__ mag, const float* __restrict__ alb,
             const float* __restrict__ dirs, const int* __restrict__ counts,
             const float* __restrict__ dcol, const float* __restrict__ tsave,
             float* __restrict__ t_a, float* __restrict__ rows_p, double* __restrict__ dd_p,
             float* __restrict__ db_part, int N, int R, int Rp, int ck, int a, int qb) {
  using S = Side<Geo>;
  extern __shared__ float smem[];
  float* stage = smem;
  float* red = smem + Geo::kFields * qb;
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
  const Geo geo(oc, shape, mag, b, N);
  const float* alb_b = alb + static_cast<size_t>(b) * N * 3;
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
        const RayTerms tp = geo.template row<EXP>(p, dx, dy, dz);
        mbp[i] = tp.mb;
        sgp[i] = tp.sb;
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
      pass_a<kPB, ERF, EXP>(stage, qb, geo, 0, cnt, dx, dy, dz, mbp, sgp, G, p0 == p_begin, base);
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
        const float co = geo.template row<EXP>(p, dx, dy, dz).co;
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
    // ddirs is (J_p - J_q) S0 inv_q: summed here as that difference, since
    // the two sides' separate sums of J dmb are large and cancel (the q
    // side leaves its pair terms out of ddirs).
    float dmbp[kPB], dsbp[kPB];
    Jac jp[kPB];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      dmbp[i] = dsbp[i] = 0.0f;
      jp[i] = S::template jac_row<EXP>(geo, min(p0 + i, p_end - 1), dx, dy, dz);
    }
    for (int q0 = 0; q0 < cnt; q0 += qb) {
      const int nq = min(qb, cnt - q0);
      __syncthreads();
      geo.stage(stage, qb, q0, nq);
      __syncthreads();
      // this stage's sums, added to the running ones after it (two-level
      // sums, as pass_a's): ddirs' pair terms, dmb_p, dsb_p
      float sx = 0.0f, sy = 0.0f, sz = 0.0f, pdmb[kPB], pdsb[kPB];
#pragma unroll
      for (int i = 0; i < kPB; ++i) pdmb[i] = pdsb[i] = 0.0f;
      for (int j = 0; j < nq; ++j) {
        const RayTerms tq = geo.template staged<EXP>(stage, qb, j, dx, dy, dz);
        const Jac jq = S::jac_staged(stage, qb, j, tq, dx, dy, dz);
        const float mbq = tq.mb, invq = tq.inv;
        const float nco = -kDerf * tq.co;
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
          pdsb[i] += s1 * invq;
          sx += (jp[i].x - jq.x) * di;
          sy += (jp[i].y - jq.y) * di;
          sz += (jp[i].z - jq.z) * di;
        }
      }
      gx += sx;
      gy += sy;
      gz += sz;
#pragma unroll
      for (int i = 0; i < kPB; ++i) {
        dmbp[i] += pdmb[i];
        dsbp[i] += pdsb[i];
      }
    }

    // the prep chain of each row, reduced over the block's rays
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      if (p >= p_end) break;  // block-uniform
      float v[kSums];
      S::template p_chain<EXP>(geo, p, dx, dy, dz, cr, cg, cb, mbp[i], tw[i], A[i], dmbp[i],
                               dsbp[i], v, gx, gy, gz);
      row_sums<kSums>(v, red, rows_p + ((static_cast<size_t>(b) * n_rb + rblk) * N + p) * kSums);
    }
  }

  db_part[(static_cast<size_t>(b) * (ck / kRows) + blk) * Rp + r] = db;
  double* dd = dd_p + (static_cast<size_t>(b) * (N / kRows) + p_begin / kRows) * 3 * Rp + r;
  dd[0] = gx;
  dd[Rp] = gy;
  dd[2 * static_cast<size_t>(Rp)] = gz;
}

// ---------------------------------------------------------------------------
// q side: the rows of one 64-row block against the p rows of chunk a
// ---------------------------------------------------------------------------

template <class Geo, int ERF, int EXP>
__global__ void __launch_bounds__(kMaxThreads)
bwd_q_kernel(const float* __restrict__ oc, const float* __restrict__ shape,
             const float* __restrict__ mag, const float* __restrict__ alb,
             const float* __restrict__ dirs, const int* __restrict__ counts,
             const float* __restrict__ dcol, const float* __restrict__ tsrc, int t_rows,
             int t_row0, int t_ld, const float* __restrict__ db, float* __restrict__ rows_q,
             double* __restrict__ dd_q, int N, int R, int Rp, int ck, int a, int qb) {
  using S = Side<Geo>;
  extern __shared__ float smem[];
  float* stage = smem;
  float* red = smem + S::kPFields * qb;
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
  const Geo geo(oc, shape, mag, b, N);
  const float* alb_b = alb + static_cast<size_t>(b) * N * 3;
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
        const RayTerms t = geo.template row<EXP>(q, dx, dy, dz);
        mbq[i] = t.mb;
        coq[i] = t.co;
        invq[i] = t.inv;
      }
    }
    for (int pp = p_lo; pp < p_hi; pp += qb) {
      const int np = min(qb, p_hi - pp);
      __syncthreads();
      S::stage_p(geo, alb_b, stage, qb, pp, np);
      __syncthreads();
      // this stage's sums, added to the running ones after it: dco_q is the
      // difference of the direct term and these sums, and at thousands of p
      // rows a single running sum lost ~20x the plain version's accuracy
      float pdco[kPB], pdmb[kPB], pdinv[kPB];
#pragma unroll
      for (int i = 0; i < kPB; ++i) pdco[i] = pdmb[i] = pdinv[i] = 0.0f;
      for (int j = 0; j < np; ++j) {
        const RayTerms tp = S::template staged_p<EXP>(geo, stage, qb, j, dx, dy, dz);
        const float mbp = tp.mb, sgp = tp.sb;
        const float g = kSqrt2Pi * tp.co *
                        (stage[S::kAlb * qb + j] * cr + stage[(S::kAlb + 1) * qb + j] * cg +
                         stage[(S::kAlb + 2) * qb + j] * cb);
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
      float v[kSums];
      S::template q_chain<ERF, EXP>(geo, q, dx, dy, dz, mbq[i], coq[i], invq[i], dbr, dco[i],
                                    dmb[i], dinv[i], v, gx, gy, gz);
      row_sums(v, red, rows_q + ((static_cast<size_t>(b) * n_rb + rblk) * N + q) * kSums,
               accumulate);
    }
  }

  double* dd = dd_q + (static_cast<size_t>(b) * (N / kRows) + blk) * 3 * Rp + r;
  dd[0] = accumulate ? dd[0] + gx : gx;
  dd[Rp] = accumulate ? dd[Rp] + gy : gy;
  dd[2 * static_cast<size_t>(Rp)] = accumulate ? dd[2 * static_cast<size_t>(Rp)] + gz : gz;
}


using PKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const int*, const float*, const float*, float*, float*, double*,
                         float*, int, int, int, int, int, int);
using QKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const int*, const float*, const float*, int, int, int, const float*,
                         float*, double*, int, int, int, int, int, int);

template <class Geo, bool SAVED_T>
PKernel pick_p(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return bwd_p_kernel<Geo, kErfAs5, kExpExact, SAVED_T>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return bwd_p_kernel<Geo, kErfAs5, kExpFast, SAVED_T>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return bwd_p_kernel<Geo, kErfAs3, kExpExact, SAVED_T>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return bwd_p_kernel<Geo, kErfAs3, kExpFast, SAVED_T>;
  return nullptr;
}

template <class Geo>
QKernel pick_q(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return bwd_q_kernel<Geo, kErfAs5, kExpExact>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return bwd_q_kernel<Geo, kErfAs5, kExpFast>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return bwd_q_kernel<Geo, kErfAs3, kExpExact>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return bwd_q_kernel<Geo, kErfAs3, kExpFast>;
  return nullptr;
}

// shape is sigma (B,N) for IsoGeo, invd (B,N,3) for AnisoGeo; dshape the
// matching gradient.
template <class Geo, bool SAVED_T>
int launch(const float* oc, const float* shape, const float* mag, const float* alb,
           const float* dirs, const int* counts, const float* dcol, const float* t,
           float* scratch, float* doc, float* dshape, float* dmag, float* dalb, float* ddirs,
           int B, int N, int R, int ck, int threads, int qb, int erf_id, int exp_id,
           void* stream) {
  PKernel pfn = pick_p<Geo, SAVED_T>(erf_id, exp_id);
  QKernel qfn = pick_q<Geo>(erf_id, exp_id);
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
  const size_t smem_p = sizeof(float) * (Geo::kFields * qb + kWarps * kSums);
  const size_t smem_q = sizeof(float) * (Side<Geo>::kPFields * qb + kWarps * kSums);
  cudaError_t err;
  for (int a = 0; a < N / ck; ++a) {
    pfn<<<dim3(n_rb, ck / kRows, B), threads, smem_p, st>>>(
        oc, shape, mag, alb, dirs, counts, dcol, t, s.t_a, s.rows_p, s.dd_p, s.db_part, N, R, Rp,
        ck, a, qb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    // db_a = the live 64-row blocks of chunk a summed in block order
    if ((err = launch_block_sums(s.db_part, counts, s.db, B, N, Rp, ck / kRows, kRows, a * ck,
                                 st)) != cudaSuccess)
      return static_cast<int>(err);
    qfn<<<dim3(n_rb, N / kRows, B), threads, smem_q, st>>>(
        oc, shape, mag, alb, dirs, counts, dcol, SAVED_T ? t : s.t_a, SAVED_T ? N : ck,
        SAVED_T ? 0 : a * ck, SAVED_T ? R : Rp, s.db, s.rows_q, s.dd_q, N, R, Rp, ck, a, qb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  bwd_rows_kernel<Geo><<<blocks_for(static_cast<size_t>(B) * N, 256), 256, 0, st>>>(
      oc, shape, mag, counts, s.rows_p, s.rows_q, doc, dshape, dmag, dalb, B, N, n_rb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_ddirs_kernel<<<blocks_for(static_cast<size_t>(B) * 3 * R, 256), 256, 0, st>>>(
      counts, s.dd_p, s.dd_q, ddirs, B, N, R, Rp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sgrt_chunked_bwd_max_threads() { return kMaxThreads; }

// Floats of scratch that one launch needs (recompute: the backward without
// saved T; the same for both geometries).
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
  return launch<IsoGeo, true>(oc, sig, mag, alb, dirs, counts, dcol, t, scratch, doc, dsig, dmag,
                              dalb, ddirs, B, N, R, ck, threads, qb, erf_id, exp_id, stream);
}

// Recompute chunked backward: pass A is redone per p chunk into scratch.
int sgrt_chunked_bwd(const float* oc, const float* sig, const float* mag, const float* alb,
                     const float* dirs, const int* counts, const float* dcol, float* scratch,
                     float* doc, float* dsig, float* dmag, float* dalb, float* ddirs, int B,
                     int N, int R, int ck, int threads, int qb, int erf_id, int exp_id,
                     void* stream) {
  return launch<IsoGeo, false>(oc, sig, mag, alb, dirs, counts, dcol, nullptr, scratch, doc, dsig,
                               dmag, dalb, ddirs, B, N, R, ck, threads, qb, erf_id, exp_id,
                               stream);
}

// Resources of kernel i of this library (as5, exact erf/exp) at `threads`
// rays per block and qb staged rows: kernel_resources's seven ints into
// out, its name into name. Returns -1 past the last kernel.
int sgrt_kernel_resources(int i, int threads, int qb, int* out, const char** name) {
  const size_t red = sizeof(float) * kWarps * kSums;
  const size_t p_iso = sizeof(float) * IsoGeo::kFields * qb + red;
  const size_t q_iso = sizeof(float) * Side<IsoGeo>::kPFields * qb + red;
  switch (i) {
    case 0:
      *name = "bwd_p_kernel<IsoGeo, SAVED_T>";
      return kernel_resources(bwd_p_kernel<IsoGeo, kErfAs5, kExpExact, true>, threads, p_iso, out);
    case 1:
      *name = "bwd_p_kernel<IsoGeo>";
      return kernel_resources(bwd_p_kernel<IsoGeo, kErfAs5, kExpExact, false>, threads, p_iso,
                              out);
    case 2:
      *name = "bwd_q_kernel<IsoGeo>";
      return kernel_resources(bwd_q_kernel<IsoGeo, kErfAs5, kExpExact>, threads, q_iso, out);
    default:
      return -1;
  }
}

}  // extern "C"
