// Gaussian-axis chunked backward of the Gaussian ray tracer for Hopper
// (sm_90a): from the colors' cotangent dcol to the gradients of the raw tile
// scene and of the ray directions, with the Gaussian axis cut into chunks of
// ck rows.
//
// Replaces the TPU kernels sgrt_tpu/ops/pallas_chunked.py::_chunked_bwd_t_kernel
// (saved-T, launched by _chunked_bwd_t_call; entry point sgrt_chunked_bwd_t)
// and ::_chunked_bwd_kernel (recompute, launched by _chunked_bwd_call; entry
// point sgrt_chunked_bwd), and sgrt_tpu/ops/pallas_chunked_aniso.py::
// _chunked_bwd_aniso_kernel (recompute over anisotropic rows, launched by
// _chunked_bwd_aniso_call; entry point sgrt_chunked_bwd_aniso; the reference
// has no saved-T variant of it). All run one template, bwd_p_kernel<Geo, ...,
// SAVED_T> and the kernels after it, over the row geometries of
// gauss_common.cuh (IsoGeo, AnisoGeo); Side<Geo> below holds what the two
// geometries do differently. The isotropic variants differ only in where T
// comes from.
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
// adds pass A (five erf taps per pair). Anisotropic rows add, per staged
// row and ray, their terms (~38 FP32, 3 SFU: A, Bt, two square roots and a
// division) and on the p side J_q (~10 FP32), once per 8-row group. Bytes:
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
//     the other side's rows are staged through shared memory, anisotropic
//     rows as their per-row fields (invd, M, C, mag), whose per-ray terms a
//     thread recomputes. The q side reads G_k = g_p T_k(p, r) from T,
//     coalesced across the warp's rays.
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

#include "gauss_common.cuh"

namespace {

using namespace sgrt;

constexpr int kPB = 8;           // rows a thread keeps in registers
constexpr int kRows = 64;        // rows per block; divides every chunk (ck % 128 == 0)
constexpr int kMaxThreads = 128;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kSums = 10;        // per-row sums over rays; Side<Geo> names them

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
// What the geometries do differently: how the q side stages p rows, J = d mb
// / d d of a row (ddirs' pair terms), each side's chain into the per-row sums
// and ddirs, and the per-row gradients from the sums.
// ---------------------------------------------------------------------------

struct Jac {
  float x, y, z;
};

template <class Geo>
struct Side;

template <>
struct Side<IsoGeo> {
  enum { kRow, kQmb, kDsig, kDinv, kOx, kOy, kOz, kAx, kAy, kAz };  // the sums
  // p rows staged for the q side: x y z |oc|^2 1/(2s^2) mag s sqrt(pi/2),
  // sigma, albedo rgb
  static constexpr int kPFields = 10;
  static constexpr int kAlb = 7;

  static __device__ void stage_p(const IsoGeo& g, const float* alb, float* st, int qb, int p0,
                                 int np) {
    for (int j = threadIdx.x; j < np; j += blockDim.x) {
      const int p = p0 + j;
      const Row w = load_row(g.oc, g.sig, g.mag, p);
      st[j] = w.x;
      st[qb + j] = w.y;
      st[2 * qb + j] = w.z;
      st[3 * qb + j] = w.ocsq;
      st[4 * qb + j] = w.i2s2;
      st[5 * qb + j] = w.cs;
      st[6 * qb + j] = g.sig[p];
      st[7 * qb + j] = alb[3 * p];
      st[8 * qb + j] = alb[3 * p + 1];
      st[9 * qb + j] = alb[3 * p + 2];
    }
  }

  // a staged p row's mb, co and sb (= sigma) for one ray
  template <int EXP>
  static __device__ RayTerms staged_p(const IsoGeo&, const float* st, int qb, int j, float dx,
                                      float dy, float dz) {
    RayTerms t;
    t.mb = dot3_rn(st[j], st[qb + j], st[2 * qb + j], dx, dy, dz);
    t.co = coeff<EXP>(st[5 * qb + j], st[3 * qb + j], t.mb, st[4 * qb + j]);
    t.sb = st[6 * qb + j];
    t.inv = 0.0f;  // not staged: the q side needs the p rows' sigma only
    return t;
  }

  // J = oc, of row p and of a q row staged by IsoGeo::stage
  template <int EXP>
  static __device__ Jac jac_row(const IsoGeo& g, int p, float, float, float) {
    return {g.oc[3 * p], g.oc[3 * p + 1], g.oc[3 * p + 2]};
  }

  static __device__ Jac jac_staged(const float* st, int qb, int j, const RayTerms&, float, float,
                                   float) {
    return {st[j], st[qb + j], st[2 * qb + j]};
  }

  // The p side's chain of row p: the direct dco = sqrt(2/pi) tw A and the
  // pair sums dmb, dsb (the pair terms of ddirs are in already).
  template <int EXP>
  static __device__ void p_chain(const IsoGeo& g, int p, float dx, float dy, float dz, float cr,
                                 float cg, float cb, float mb, float tw, float A, float dmb,
                                 float dsb, float (&v)[kSums], double& gx, double& gy,
                                 double& gz) {
    const Row w = load_row(g.oc, g.sig, g.mag, p);
    const float co = coeff<EXP>(w.cs, w.ocsq, mb, w.i2s2);
    const float dcoco = kSqrt2Pi * tw * A * co;
    const float chain = dcoco * (2.0f * w.i2s2) * mb;
    const float dmbt = dmb + chain;
    const float wp = kSqrt2Pi * co * tw;
    v[kRow] = dcoco;
    v[kQmb] = dcoco * ocsq_minus_mb2_rn(w.ocsq, mb);
    v[kDsig] = dsb;
    v[kDinv] = 0.0f;
    v[kOx] = dmbt * dx;
    v[kOy] = dmbt * dy;
    v[kOz] = dmbt * dz;
    v[kAx] = wp * cr;
    v[kAy] = wp * cg;
    v[kAz] = wp * cb;
    gx += w.x * chain;
    gy += w.y * chain;
    gz += w.z * chain;
  }

  // The q side's chain of row q: the pair sums dco, dmb, dinv plus the base
  // path with chunk a's db (ddirs takes the row's own terms only).
  template <int ERF, int EXP>
  static __device__ void q_chain(const IsoGeo& g, int q, float dx, float dy, float dz, float mb,
                                 float co, float inv, float dbr, float dco, float dmb, float dinv,
                                 float (&v)[kSums], double& gx, double& gy, double& gz) {
    const Row w = load_row(g.oc, g.sig, g.mag, q);
    float e1, g1;
    erf_and_gauss<ERF>(-mb * inv, e1, g1);
    const float derf1 = kDerf * dbr * co * g1;
    const float dcoco = (dco + dbr * e1) * co;
    const float single = dcoco * (2.0f * w.i2s2) * mb - derf1 * inv;
    const float dmbt = dmb + single;
    v[kRow] = dcoco;
    v[kQmb] = dcoco * ocsq_minus_mb2_rn(w.ocsq, mb);
    v[kDsig] = 0.0f;
    v[kDinv] = dinv - derf1 * mb;
    v[kOx] = dmbt * dx;
    v[kOy] = dmbt * dy;
    v[kOz] = dmbt * dz;
    v[kAx] = v[kAy] = v[kAz] = 0.0f;
    gx += w.x * single;  // the pair terms are in bwd_p_kernel's share
    gy += w.y * single;
    gz += w.z * single;
  }

  // doc, dsig, dmag, dalb of a live row from its summed sums
  static __device__ void finish(const float* oc, const float* sig, const float* mag, size_t row,
                                const float (&s)[kSums], float* doc, float* dsig, float* dmag,
                                float* dalb) {
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

  static __device__ void zero(size_t row, float* doc, float* dsig, float* dmag, float* dalb) {
    doc[3 * row] = doc[3 * row + 1] = doc[3 * row + 2] = 0.0f;
    dalb[3 * row] = dalb[3 * row + 1] = dalb[3 * row + 2] = 0.0f;
    dsig[row] = dmag[row] = 0.0f;
  }
};

template <>
struct Side<AnisoGeo> {
  // the sums: s_row, P = sum (dBt d - dcoco oc), Q = sum (dA d^2 + dBt d oc
  // + dC oc^2), dalb's weight; doc = invd P, dinvd = Q (see chain)
  enum { kRow, kPx, kPy, kPz, kQx, kQy, kQz, kAx, kAy, kAz };
  // p rows staged for the q side: AnisoGeo's fields (invd, M, C, mag
  // sqrt(pi/2)), then albedo rgb
  static constexpr int kPFields = AnisoGeo::kFields + 3;
  static constexpr int kAlb = AnisoGeo::kFields;

  static __device__ void stage_p(const AnisoGeo& g, const float* alb, float* st, int qb, int p0,
                                 int np) {
    g.stage(st, qb, p0, np);
    for (int j = threadIdx.x; j < np; j += blockDim.x) {
      const int p = p0 + j;
      st[kAlb * qb + j] = alb[3 * p];
      st[(kAlb + 1) * qb + j] = alb[3 * p + 1];
      st[(kAlb + 2) * qb + j] = alb[3 * p + 2];
    }
  }

  template <int EXP>
  static __device__ RayTerms staged_p(const AnisoGeo& g, const float* st, int qb, int j,
                                      float dx, float dy, float dz) {
    return g.template staged<EXP>(st, qb, j, dx, dy, dz);
  }

  // J = d mb / d d = sb^2 (M - 2 mb invd d), mb = Bt / A
  static __device__ Jac jac(float ix, float iy, float iz, float mx, float my, float mz,
                            const RayTerms& t, float dx, float dy, float dz) {
    const float sb2 = t.sb * t.sb, m2 = 2.0f * t.mb;
    return {sb2 * (mx - m2 * (ix * dx)), sb2 * (my - m2 * (iy * dy)), sb2 * (mz - m2 * (iz * dz))};
  }

  template <int EXP>
  static __device__ Jac jac_row(const AnisoGeo& g, int p, float dx, float dy, float dz) {
    const AnisoGeo::Fields f = g.fields(p);
    const RayTerms t = AnisoGeo::terms<EXP>(f, dx, dy, dz);
    return jac(f.ix, f.iy, f.iz, f.mx, f.my, f.mz, t, dx, dy, dz);
  }

  static __device__ Jac jac_staged(const float* st, int qb, int j, const RayTerms& t, float dx,
                                   float dy, float dz) {
    return jac(st[j], st[qb + j], st[2 * qb + j], st[3 * qb + j], st[4 * qb + j], st[5 * qb + j],
               t, dx, dy, dz);
  }

  // The sums of row q and one ray from its dcoco, dmb (the pair sums' part
  // dmb_pair, the row's own dmb_own) and dsb_tot. With dBt = dmb sb^2 +
  // dcoco mb, dA = -dmb mb sb^2 - dsb_tot sb^3/2 - dcoco mb^2/2 and dC =
  // -dcoco/2, the per-row gradients are doc = invd sum (dBt d + 2 dC oc) and
  // dinvd = sum (dA d^2 + dC oc^2 + dBt d oc); their dcoco terms are each
  // ~dcoco |oc|^2 and cancel to dcoco u^2, u = oc - mb d (the exponent's
  // own cancellation, ~|oc|^2/scale^2). Summed apart over a side's and a
  // chunk's rays, the cancelling sums lost up to 8x the plain version's
  // accuracy on dinvd (the 50k-Gaussian anisotropic sphere), so they are
  // summed in u, where nothing cancels:
  //   P = sum (dmb sb^2 d - dcoco u),
  //   Q = sum (dmb sb^2 d u - dcoco u^2/2 - dsb_tot sb^3 d^2/2).
  // ddirs' share is 2 d (invd dA) + M dBt without dmb_pair (bwd_p_kernel
  // sums the pairs' shares).
  static __device__ void chain(const AnisoGeo& g, int q, const AnisoGeo::Fields& f,
                               const RayTerms& t, float dx, float dy, float dz, float dcoco,
                               float dmb_pair, float dmb_own, float dsb_tot, float wp, float cr,
                               float cg, float cb, float (&v)[kSums], double& gx, double& gy,
                               double& gz) {
    const float inv_a = t.sb * t.sb;  // 1/A
    const float h = 0.5f * dsb_tot * t.sb * inv_a;
    const float e = (dmb_pair + dmb_own) * inv_a;
    const float ux = g.oc[3 * q] - t.mb * dx, uy = g.oc[3 * q + 1] - t.mb * dy,
                uz = g.oc[3 * q + 2] - t.mb * dz;
    v[kRow] = dcoco;
    v[kPx] = e * dx - dcoco * ux;
    v[kPy] = e * dy - dcoco * uy;
    v[kPz] = e * dz - dcoco * uz;
    v[kQx] = ux * (e * dx - 0.5f * dcoco * ux) - h * (dx * dx);
    v[kQy] = uy * (e * dy - 0.5f * dcoco * uy) - h * (dy * dy);
    v[kQz] = uz * (e * dz - 0.5f * dcoco * uz) - h * (dz * dz);
    v[kAx] = wp * cr;
    v[kAy] = wp * cg;
    v[kAz] = wp * cb;
    const float dbt_own = dmb_own * inv_a + dcoco * t.mb;
    const float da_own = -dmb_own * t.mb * inv_a - h - 0.5f * dcoco * t.mb * t.mb;
    gx += static_cast<double>(2.0f * dx * (f.ix * da_own) + f.mx * dbt_own);
    gy += static_cast<double>(2.0f * dy * (f.iy * da_own) + f.my * dbt_own);
    gz += static_cast<double>(2.0f * dz * (f.iz * da_own) + f.mz * dbt_own);
  }

  template <int EXP>
  static __device__ void p_chain(const AnisoGeo& g, int p, float dx, float dy, float dz, float cr,
                                 float cg, float cb, float, float tw, float A, float dmb,
                                 float dsb, float (&v)[kSums], double& gx, double& gy,
                                 double& gz) {
    const AnisoGeo::Fields f = g.fields(p);
    const RayTerms t = AnisoGeo::terms<EXP>(f, dx, dy, dz);
    const float dcoco = kSqrt2Pi * tw * A * t.co;
    const float dsb_tot = dsb + dcoco / t.sb;
    chain(g, p, f, t, dx, dy, dz, dcoco, dmb, 0.0f, dsb_tot, kSqrt2Pi * t.co * tw, cr, cg, cb, v,
          gx, gy, gz);
  }

  template <int ERF, int EXP>
  static __device__ void q_chain(const AnisoGeo& g, int q, float dx, float dy, float dz, float mb,
                                 float co, float inv, float dbr, float dco, float dmb, float dinv,
                                 float (&v)[kSums], double& gx, double& gy, double& gz) {
    const AnisoGeo::Fields f = g.fields(q);
    const RayTerms t = AnisoGeo::terms<EXP>(f, dx, dy, dz);  // its mb, co, inv are the arguments
    float e1, g1;
    erf_and_gauss<ERF>(-mb * inv, e1, g1);
    const float derf1 = kDerf * dbr * co * g1;
    const float dcoco = (dco + dbr * e1) * co;
    const float dinv_t = dinv - derf1 * mb;
    const float dsb_tot = dcoco / t.sb - dinv_t * inv / t.sb;
    chain(g, q, f, t, dx, dy, dz, dcoco, dmb, -derf1 * inv, dsb_tot, 0.0f, 0.0f, 0.0f, 0.0f, v,
          gx, gy, gz);
  }

  // doc, dinvd, dmag, dalb of a live row: doc = invd P, dinvd = Q
  static __device__ void finish(const float*, const float* invd, const float* mag, size_t row,
                                const float (&s)[kSums], float* doc, float* dinvd, float* dmag,
                                float* dalb) {
    for (int k = 0; k < 3; ++k) {
      dinvd[3 * row + k] = s[kQx + k];
      doc[3 * row + k] = invd[3 * row + k] * s[kPx + k];
      dalb[3 * row + k] = s[kAx + k];
    }
    const float m = mag[row];
    dmag[row] = s[kRow] / (m == 0.0f ? 1.0f : m);
  }

  static __device__ void zero(size_t row, float* doc, float* dinvd, float* dmag, float* dalb) {
    for (int c = 0; c < 3; ++c) doc[3 * row + c] = dinvd[3 * row + c] = dalb[3 * row + c] = 0.0f;
    dmag[row] = 0.0f;
  }
};

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

// ---------------------------------------------------------------------------
// per-row gradients and ddirs from the partial sums
// ---------------------------------------------------------------------------

// One thread per (tile, row): the p side's and the q side's sums over the
// ray blocks in order, then the geometry's per-row gradients; rows at or
// past the count are written as zeros.
template <class Geo>
__global__ void bwd_rows_kernel(const float* __restrict__ oc, const float* __restrict__ shape,
                                const float* __restrict__ mag, const int* __restrict__ counts,
                                const float* __restrict__ rows_p,
                                const float* __restrict__ rows_q, float* __restrict__ doc,
                                float* __restrict__ dshape, float* __restrict__ dmag,
                                float* __restrict__ dalb, int B, int N, int n_rb) {
  const size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<size_t>(B) * N) return;
  const int b = static_cast<int>(row / N);
  const int q = static_cast<int>(row % N);
  const int cnt = max(0, min(counts[b], N));
  if (q >= cnt) {
    Side<Geo>::zero(row, doc, dshape, dmag, dalb);
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
  Side<Geo>::finish(oc, shape, mag, row, s, doc, dshape, dmag, dalb);
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

unsigned blocks_for(size_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
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
    db_sum_kernel<<<blocks_for(static_cast<size_t>(B) * Rp, 256), 256, 0, st>>>(
        counts, s.db_part, s.db, B, N, Rp, ck, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
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

// The anisotropic recompute chunked backward: invd (B,N,3) = scale^-2 in
// place of sigma, dinvd (B,N,3) in place of dsig; T recomputed as the
// anisotropic forward (sgrt_fused_fwd_aniso) computes it.
int sgrt_chunked_bwd_aniso(const float* oc, const float* invd, const float* mag,
                           const float* alb, const float* dirs, const int* counts,
                           const float* dcol, float* scratch, float* doc, float* dinvd,
                           float* dmag, float* dalb, float* ddirs, int B, int N, int R, int ck,
                           int threads, int qb, int erf_id, int exp_id, void* stream) {
  return launch<AnisoGeo, false>(oc, invd, mag, alb, dirs, counts, dcol, nullptr, scratch, doc,
                                 dinvd, dmag, dalb, ddirs, B, N, R, ck, threads, qb, erf_id,
                                 exp_id, stream);
}

}  // extern "C"
