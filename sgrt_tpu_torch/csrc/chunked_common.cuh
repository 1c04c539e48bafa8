// What the chunked backward's kernels (chunked.cu) build on: the scratch
// layout, what the row geometries do differently there (Side<Geo>: J and
// each side's chain into the per-row sums) and the per-row gradient and
// ddirs kernels. chunked.cu's head note states the function and the sums.

#pragma once

#include <cuda_runtime.h>

#include "gauss_common.cuh"

namespace sgrt {

constexpr int kRows = 64;        // rows per block; divides every chunk of a launch with
                                 // C > 1 chunks, and a one-chunk launch's (ck = N) last
                                 // block may be partial
constexpr int kSums = 10;        // per-row sums over rays; Side<Geo> names them

// Row blocks of kRows that cover n rows (the last one possibly partial).
__host__ __device__ constexpr int row_blocks(int n) { return (n + kRows - 1) / kRows; }

struct Scratch {
  float* rows_p;   // (B, n_rb, N, sums)
  float* rows_q;   // (B, n_rb, N, sums), summed over p chunks
  double* dd_p;    // (B, row_blocks(N), 3, Rp), with ddirs
  double* dd_q;    // (B, row_blocks(N), 3, Rp), summed over p chunks, with ddirs
  float* db_part;  // (B, row_blocks(ck), Rp)
  float* db;       // (B, Rp)
  float* t_a;      // (B, kTaps, ck, Rp), recompute only
};

// Floats of the scratch, for `sums` per-row sums (Side<Geo>::kN) and, with
// ddirs, the ddirs shares; with base, also the pointers into it.
size_t scratch_layout(int B, int N, int R, int ck, int threads, bool recompute, int sums,
                      bool ddirs, float* base = nullptr, Scratch* s = nullptr) {
  const size_t n_rb = (R + threads - 1) / threads;
  const size_t Rp = n_rb * threads;
  // in floats; the double buffers first, so that they stay 8-byte aligned
  const size_t dd = ddirs ? 2 * static_cast<size_t>(B) * row_blocks(N) * 3 * Rp : 0;
  const size_t sizes[7] = {
      dd, dd, static_cast<size_t>(B) * n_rb * N * sums, static_cast<size_t>(B) * n_rb * N * sums,
      static_cast<size_t>(B) * row_blocks(ck) * Rp, static_cast<size_t>(B) * Rp,
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
// What the geometries do differently: J = d mb / d d of a row (ddirs' pair
// terms), each side's chain into the per-row sums and ddirs, and the
// per-row gradients from the sums.
// ---------------------------------------------------------------------------

struct Jac {
  float x, y, z;
};

template <class Geo>
struct Side;

template <>
struct Side<IsoGeo> {
  enum { kRow, kQmb, kDsig, kDinv, kOx, kOy, kOz, kAx, kAy, kAz };  // the sums
  static constexpr int kN = kSums;

  // J = oc, of a row from its fields and of row p
  static __device__ Jac jac(const IsoGeo::Fields& f, const RayTerms&, float, float, float) {
    return {f.w.x, f.w.y, f.w.z};
  }

  template <int EXP>
  static __device__ Jac jac_row(const IsoGeo& g, int p, float, float, float) {
    return {g.oc[3 * p], g.oc[3 * p + 1], g.oc[3 * p + 2]};
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
  static constexpr int kN = kSums;

  // J = d mb / d d = sb^2 (M - 2 mb invd d), mb = Bt / A, of a row from its
  // fields and terms and of row p
  static __device__ Jac jac(const AnisoGeo::Fields& f, const RayTerms& t, float dx, float dy,
                            float dz) {
    const float sb2 = t.sb * t.sb, m2 = 2.0f * t.mb;
    return {sb2 * (f.mx - m2 * (f.ix * dx)), sb2 * (f.my - m2 * (f.iy * dy)),
            sb2 * (f.mz - m2 * (f.iz * dz))};
  }

  template <int EXP>
  static __device__ Jac jac_row(const AnisoGeo& g, int p, float dx, float dy, float dz) {
    const AnisoGeo::Fields f = g.fields(p);
    return jac(f, AnisoGeo::terms<EXP>(f, dx, dy, dz), dx, dy, dz);
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

// Plane rows: the outputs are the planes' own gradients, so there is no
// chain. The p side writes its part of each live row's dmb (the pair sums
// S0 inv_q) and dco (the direct sqrt(2/pi) tw A, colors only); the q side
// then adds its pair sums and the base path, in stream order, for every row
// of the tile: rows past the count keep the base path alone (base sums all
// N rows). dsig (the p side's dsb), dinv (the q side's) and the albedo
// weight sqrt(2/pi) co tw dcol are the per-row sums over rays. No J, no
// ddirs.
template <>
struct Side<PlaneGeo> {
  enum { kDsig, kDinv, kAx, kAy, kAz, kN };  // the sums

  template <int EXP>
  static __device__ void p_chain(const PlaneGeo& g, int p, float, float, float, float cr,
                                 float cg, float cb, float, float tw, float A, float dmb,
                                 float dsb, float (&v)[kN], double&, double&, double&) {
    if (g.live) {
      g.dmb[g.at(p)] = dmb;
      g.dco[g.at(p)] = kSqrt2Pi * tw * A;
    }
    const float wp = kSqrt2Pi * g.co_at(p) * tw;
    v[kDsig] = dsb;
    v[kDinv] = 0.0f;
    v[kAx] = wp * cr;
    v[kAy] = wp * cg;
    v[kAz] = wp * cb;
  }

  // Row q's base path with db (dbr) and, for a live row (live_row), the
  // pair sums: dco, and dmb and dinv without the row's -2/sqrt(pi) co_q.
  // mb and inv are the row's, from the q side's slots (read again from the
  // planes here, their addresses would stay live across the pair pass and
  // spill).
  template <int ERF>
  static __device__ void q_chain(const PlaneGeo& g, int q, bool live_row, float mb, float inv,
                                 float dbr, float dco, float dmb, float dinv, float (&v)[kN]) {
    const float co = g.co_at(q);
    float e1, g1;
    erf_and_gauss<ERF>(-mb * inv, e1, g1);
    const float derf1 = kDerf * dbr * co * g1;
    const float nco = -kDerf * co;
    if (g.live) {
      const int at = g.at(q);
      const float pco = live_row ? g.dco[at] : 0.0f, pmb = live_row ? g.dmb[at] : 0.0f;
      g.dco[at] = pco + (live_row ? dco : 0.0f) + dbr * e1;
      g.dmb[at] = pmb + (live_row ? nco * dmb : 0.0f) - derf1 * inv;
    }
    v[kDsig] = 0.0f;
    v[kDinv] = (live_row ? nco * dinv : 0.0f) - derf1 * mb;
    v[kAx] = v[kAy] = v[kAz] = 0.0f;
  }
};

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

// Plane rows, one thread per (tile, row): dsig, dinv and, if dalb is not
// null, dalb, the p side's sums (live rows) and the q side's (every row)
// over the ray blocks in order; dsig and dalb are zero past the count.
__global__ void plane_rows_kernel(const int* __restrict__ counts, const float* __restrict__ rows_p,
                                  const float* __restrict__ rows_q, float* __restrict__ dsig,
                                  float* __restrict__ dinv, float* __restrict__ dalb, int B, int N,
                                  int n_rb) {
  using S = Side<PlaneGeo>;
  const size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<size_t>(B) * N) return;
  const int b = static_cast<int>(row / N);
  const int q = static_cast<int>(row % N);
  const bool live = q < max(0, min(counts[b], N));
  float s[S::kN];
#pragma unroll
  for (int j = 0; j < S::kN; ++j) s[j] = 0.0f;
  for (int rb = 0; rb < n_rb; ++rb) {
    const size_t o = ((static_cast<size_t>(b) * n_rb + rb) * N + q) * S::kN;
#pragma unroll
    for (int j = 0; j < S::kN; ++j) s[j] += (live ? rows_p[o + j] : 0.0f) + rows_q[o + j];
  }
  dsig[row] = s[S::kDsig];
  dinv[row] = s[S::kDinv];
  if (dalb != nullptr) {
    for (int c = 0; c < 3; ++c) dalb[3 * row + c] = s[S::kAx + c];
  }
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
  const int live = row_blocks(cnt);
  const size_t stride = static_cast<size_t>(3) * Rp;
  const size_t o =
      static_cast<size_t>(b) * row_blocks(N) * stride + static_cast<size_t>(c) * Rp + r;
  double s = 0.0;
  for (int z = 0; z < live; ++z) s += dd_p[o + z * stride];
  for (int z = 0; z < live; ++z) s += dd_q[o + z * stride];
  ddirs[i] = static_cast<float>(s);
}

unsigned blocks_for(size_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace sgrt
