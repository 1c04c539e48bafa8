// Fused backward of the Gaussian ray tracer for Hopper (sm_90a): from the
// colors' cotangent dcol to the gradients of the raw isotropic tile scene
// and of the ray directions.
//
// Replaces the TPU kernels sgrt_tpu/ops/pallas_kernel.py::_fused_bwd_t_kernel
// (saved-T backward, launched by _fused_bwd_t_call; entry point
// sgrt_fused_bwd_t) and ::_fused_bwd_kernel (recompute backward, launched
// by _fused_bwd_call; entry point sgrt_fused_bwd). Both are one template,
// bwd_rays_kernel<..., SAVED_T> over IsoGeo rows (gauss_common.cuh),
// followed by a row reduction (bwd_rows_kernel). (The anisotropic fused
// backwards are chunked.cu's p/q-split backward at one chunk.)
//
// The VJP, in the reference's order (pallas_kernel.py:125-174, :1028-1070),
// with the forward's definitions (fused_fwd.cu: mb, co, inv per (row, ray),
// sb = sigma) and for live p, q:
//   A_p      = albedo_p . dcol(r);  g_p = sqrt(2/pi) co_p A_p
//   T_k(p)   = saved, or recomputed from acc_k (pass A);  tw_p = sum_k T_k(p)
//   G_k(p)   = g_p T_k(p);  db = sum_p g_p tw_p
//   dco_p   += sqrt(2/pi) tw_p A_p;   dalb_p += sum_r sqrt(2/pi) co_p tw_p dcol(r)
//   grad pass, per (p, q): off_k = mb_p - mb_q + k sb_p,
//     (ee_k, gau_k) = (erf, exp(-x^2))(off_k inv_q),
//     dco_q -= sum_k G_k ee_k;  S0 = -2/sqrt(pi) co_q sum_k G_k gau_k;  S1 = the same with k G_k
//     dmb_p += S0 inv_q;  dmb_q -= S0 inv_q;  dinv_q += S0 (mb_p - mb_q) + S1 sb_p;
//     dsb_p += S1 inv_q
//   base path: dco_q += db e1_q;  dmb_q -= 2/sqrt(pi) db co_q g1_q inv_q;
//     dinv_q -= 2/sqrt(pi) db co_q g1_q mb_q,  (e1, g1) = (erf, exp(-x^2))(-mb_q inv_q)
// then the chain through the prep to the raw inputs: dcoco = dco co;
//   dmb += dcoco 2/(2 sigma^2) mb;  ddirs(r) = sum_q oc_q dmb_q;
//   per row, summed over rays: s_row = sum dcoco, s_qmb = sum dcoco (|oc|^2 - mb^2),
//   dsig = sum dsb_p - sum dinv inv/sigma + s_row/sigma + s_qmb/sigma^3,
//   dmag = mag s_row / (mag == 0 ? 1 : mag^2),  doc = sum_r dmb d(r) - 2 oc s_row/(2 sigma^2)
// Rows at or past the count get exactly zero gradient.
//
// What bounds it on this card: operations. The grad pass costs, per live
// (p, q, ray), five erf-and-gauss taps of about 17 FP32 instructions and 2
// SFU operations each (the erf tap of fused_fwd.cu; its exp(-x^2) is the
// one the erf needs anyway), plus 4 FP32 instructions per tap that fold the
// cotangents (the offset, dco, S0, S1) and about 8 per (p, q) pair (mb_p -
// mb_q, S0 and S1 scaling, dmb, dinv, dsb): about 25 FP32 and 2 SFU per
// tap. The recompute variant adds pass A, the forward's 5 erf taps per
// (p, q, ray). Bytes: the inputs and outputs are O(B N + B R); the scratch
// planes below are O(B N R), read and written once per (p block, q), 40
// bytes per 8 x 5 taps.
//
// What the design does about it:
//   * One thread owns one ray of one tile and runs the p axis serially in
//     blocks of kPB rows held in registers (their G_k, mb, sb and the
//     p-side sums dmb_p, dsb_p), as the TPU grid step does. The q rows
//     are staged through shared memory as in the forward; the recompute
//     variant's pass A is the forward's own (gauss_common.cuh, pass_a).
//   * The q-side sums (dco_q, dmb_q, dinv_q) of a ray go to a global
//     scratch column that only this thread reads and writes: the Pallas
//     kernel's (N, RB) VMEM planes do not fit an SM's shared memory at the
//     train capacities, and a per-thread column is race-free and
//     deterministic without atomics.
//   * The reductions over rays (the Pallas kernel's revisit-accumulation
//     across ray blocks, which needs an in-order grid) run in a second
//     kernel: one warp per row sums the ray planes in a fixed lane order
//     and a fixed butterfly, so gradients summed over ray blocks are
//     deterministic.
//   * Float32 at thousands of rows: dco_q and T are differences of sums
//     over a tile's rows (dco_q cancels the pair sum against db e1_q), and
//     ddirs cancels the rows' large oc dmb terms. So every such sum is
//     kept to more than float32's single running sum: the p-side sums
//     dmb_p and dsb_p are two-level (each staged block of qb rows on its
//     own, then the running sum, as pass_a's), and the q-side columns,
//     db and ddirs, whose running sums see one term per p block or per
//     row, are accumulated in double. A single running float per sum was
//     6x-20x further from a float64 run than the plain version at ~4300
//     rows (the chunked kernels, PERF.md).
//   * mb, |oc|^2 and |oc|^2 - mb^2 are rounded as the plain version rounds
//     them (gauss_common.cuh), since the chain multiplies by mb and the
//     exponent cancels.
//   Known cost of this simple form: the densest tile's serial p loop bounds
//   the launch (one block per 128-ray block of a tile).
//
// Layouts (float32 unless noted, contiguous): oc, albedo (B,N,3); sigma,
// mag (B,N); dirs, dcol (B,3,R); counts (B,) int32; t (B,5,N,R) (saved-T
// only); planes: kPlanes floats per (tile, row, ray lane), Rp = the
// launched ray lanes: doubles (B,3,N,Rp) for the q-side columns (dco, dmb,
// dinv; after the chain: dcoco and dmb), then floats (B,2,N,Rp) (dsb_p, the
// albedo weight w_p); outputs doc, dalb (B,N,3), dsig, dmag (B,N), ddirs
// (B,3,R).

#include <cuda_runtime.h>

#include "gauss_common.cuh"

namespace {

using namespace sgrt;

constexpr int kPB = 8;        // p rows a thread keeps in registers
constexpr int kPlanes = 8;    // floats per (row, ray): 3 double columns, 2 float planes
constexpr int kRowWarps = 8;  // rows per block of the reduction kernels

// The planes of tile b, column of ray lane r.
struct Planes {
  double* dco;
  double* dmb;
  double* dinv;
  float* dsb;
  float* w;
};

__device__ __forceinline__ Planes planes_of(float* planes, int B, int N, int Rp, int b, int r) {
  const size_t plane = static_cast<size_t>(N) * Rp;
  double* d = reinterpret_cast<double*>(planes) + static_cast<size_t>(b) * 3 * plane + r;
  float* f = planes + static_cast<size_t>(B) * 6 * plane + static_cast<size_t>(b) * 2 * plane + r;
  return {d, d + plane, d + 2 * plane, f, f + plane};
}

// The chain of one live row q and ray, after the base path: writes the
// planes the row reduction reads and adds the row's share of ddirs. dco
// becomes dcoco, dmb gains the prep's term.
__device__ __forceinline__ void chain(const IsoGeo& geo, int q, const RayTerms& t, float dco,
                                      float dmb, float dinv, const Planes& P, size_t o,
                                      double& gx, double& gy, double& gz) {
  const Row w = load_row(geo.oc, geo.sig, geo.mag, q);
  const float dcoco = dco * t.co;
  const float dmb_tot = dmb + dcoco * (2.0f * w.i2s2) * t.mb;
  P.dco[o] = dcoco;
  P.dmb[o] = dmb_tot;
  P.dinv[o] = dinv;
  gx += static_cast<double>(w.x * dmb_tot);
  gy += static_cast<double>(w.y * dmb_tot);
  gz += static_cast<double>(w.z * dmb_tot);
}

template <int ERF, int EXP, bool SAVED_T>
__global__ void __launch_bounds__(128)
bwd_rays_kernel(const float* __restrict__ oc, const float* __restrict__ sig,
                const float* __restrict__ mag, const float* __restrict__ alb,
                const float* __restrict__ dirs, const int* __restrict__ counts,
                const float* __restrict__ dcol, const float* __restrict__ tsave,
                float* __restrict__ planes, float* __restrict__ ddirs, int B, int N, int R,
                int Rp, int qb) {
  extern __shared__ float stage[];
  const int b = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;  // < Rp always
  const int cnt = max(0, min(counts[b], N));
  // Lanes past R trace a unit +z ray with a zero cotangent: every sum they
  // make is zero, their scratch columns lie inside Rp, and they write no
  // output.
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
  float* dd_out = ddirs + static_cast<size_t>(b) * 3 * R;
  if (cnt == 0) {  // block-uniform
    if (live_ray) dd_out[r] = dd_out[R + r] = dd_out[2 * R + r] = 0.0f;
    return;
  }

  const IsoGeo geo(oc, sig, mag, b, N);
  const float* alb_b = alb + static_cast<size_t>(b) * N * 3;
  const Planes P = planes_of(planes, B, N, Rp, b, r);

  for (int q = 0; q < cnt; ++q) {
    const size_t o = static_cast<size_t>(q) * Rp;
    P.dco[o] = P.dmb[o] = P.dinv[o] = 0.0;
  }

  // base(r) feeds the recomputed T only; pass A of the first p block sums it
  float base = 0.0f;
  double db = 0.0;
  for (int p0 = 0; p0 < cnt; p0 += kPB) {
    float mbp[kPB], sgp[kPB], G[kPB][kTaps];
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      mbp[i] = 0.0f;
      sgp[i] = 1.0f;
      if (p < cnt) {
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
          if (p < cnt) {
#pragma unroll
            for (int k = 0; k < kTaps; ++k) G[i][k] = t_b[(static_cast<size_t>(k) * N + p) * R];
          }
        }
      }
    } else {
      // pass A: acc_k of this p block into G, then T_k = w_k exp(base - acc_k).
      // The forward's pass_a with the same qb, so T equals the forward's
      // bit for bit and this is the exact VJP of the forward that ran.
      pass_a<kPB, ERF, EXP>(stage, qb, geo, 0, cnt, dx, dy, dz, mbp, sgp, G, p0 == 0, base);
#pragma unroll
      for (int i = 0; i < kPB; ++i) {
        const bool live = p0 + i < cnt;  // a dead row's G stays 0 in pass B
#pragma unroll
        for (int k = 0; k < kTaps; ++k)
          G[i][k] = live ? tap_weight(k) * exp_fn<EXP>(base - G[i][k]) : 0.0f;
      }
    }

    // G_k = g T_k, the direct dco term, w = sqrt(2/pi) co tw for dalb
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      if (p < cnt) {
        const float co = geo.template row<EXP>(p, dx, dy, dz).co;
        const float A = alb_b[3 * p] * cr + alb_b[3 * p + 1] * cg + alb_b[3 * p + 2] * cb;
        const float g = kSqrt2Pi * co * A;
        float tw = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) tw += G[i][k];
        db += static_cast<double>(g * tw);
#pragma unroll
        for (int k = 0; k < kTaps; ++k) G[i][k] *= g;
        const size_t o = static_cast<size_t>(p) * Rp;
        P.dco[o] += static_cast<double>(kSqrt2Pi * tw * A);
        P.w[o] = kSqrt2Pi * co * tw;
      }
    }

    // pass B: the gradient q-pass. The p-side sums are two-level: each
    // stage's qb terms on their own, then added to the running sums.
    float dmbp[kPB], dsbp[kPB];
#pragma unroll
    for (int i = 0; i < kPB; ++i) dmbp[i] = dsbp[i] = 0.0f;
    for (int q0 = 0; q0 < cnt; q0 += qb) {
      const int nq = min(qb, cnt - q0);
      __syncthreads();
      geo.stage(stage, qb, q0, nq);
      __syncthreads();
      float pdmb[kPB], pdsb[kPB];
#pragma unroll
      for (int i = 0; i < kPB; ++i) pdmb[i] = pdsb[i] = 0.0f;
      for (int j = 0; j < nq; ++j) {
        const RayTerms tq = geo.template staged<EXP>(stage, qb, j, dx, dy, dz);
        const float mbq = tq.mb, invq = tq.inv;
        const float nco = -kDerf * tq.co;
        float dco_q = 0.0f, dmb_q = 0.0f, dinv_q = 0.0f;
#pragma unroll
        for (int i = 0; i < kPB; ++i) {
          const float dd = mbp[i] - mbq;
          float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            float ee, gau;
            erf_and_gauss<ERF>((dd + tap_k(k) * sgp[i]) * invq, ee, gau);
            dco_q -= G[i][k] * ee;
            const float gg = G[i][k] * gau;
            t0 += gg;
            t1 += tap_k(k) * gg;
          }
          const float s0 = nco * t0, s1 = nco * t1;
          const float di = s0 * invq;
          pdmb[i] += di;
          dmb_q -= di;
          dinv_q += s0 * dd + s1 * sgp[i];
          pdsb[i] += s1 * invq;
        }
        const size_t q = static_cast<size_t>(q0 + j) * Rp;
        P.dco[q] += static_cast<double>(dco_q);
        P.dmb[q] += static_cast<double>(dmb_q);
        P.dinv[q] += static_cast<double>(dinv_q);
      }
#pragma unroll
      for (int i = 0; i < kPB; ++i) {
        dmbp[i] += pdmb[i];
        dsbp[i] += pdsb[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kPB; ++i) {
      const int p = p0 + i;
      if (p < cnt) {
        const size_t o = static_cast<size_t>(p) * Rp;
        P.dmb[o] += static_cast<double>(dmbp[i]);
        P.dsb[o] = dsbp[i];
      }
    }
  }

  // base-path gradients, then the chain; ddirs sums over this ray's rows
  const float dbf = static_cast<float>(db);
  double gx = 0.0, gy = 0.0, gz = 0.0;
  for (int q = 0; q < cnt; ++q) {
    const RayTerms t = geo.template row<EXP>(q, dx, dy, dz);
    float e1, g1;
    erf_and_gauss<ERF>(-t.mb * t.inv, e1, g1);
    const size_t o = static_cast<size_t>(q) * Rp;
    const float dco = static_cast<float>(P.dco[o]) + dbf * e1;
    const float derf1 = kDerf * dbf * t.co * g1;
    const float dmb = static_cast<float>(P.dmb[o]) - derf1 * t.inv;
    const float dinv = static_cast<float>(P.dinv[o]) - derf1 * t.mb;
    chain(geo, q, t, dco, dmb, dinv, P, o, gx, gy, gz);
  }
  if (live_ray) {
    dd_out[r] = static_cast<float>(gx);
    dd_out[R + r] = static_cast<float>(gy);
    dd_out[2 * R + r] = static_cast<float>(gz);
  }
}

// One warp per (tile, row): the sums over rays of the ray planes, then the
// per-row gradients of isotropic rows. Rows at or past the count are
// written as zeros.
__global__ void __launch_bounds__(32 * kRowWarps)
bwd_rows_kernel(const float* __restrict__ oc, const float* __restrict__ sig,
                const float* __restrict__ mag, const float* __restrict__ dirs,
                const int* __restrict__ counts, const float* __restrict__ dcol,
                float* __restrict__ planes, float* __restrict__ doc,
                float* __restrict__ dsig, float* __restrict__ dmag,
                float* __restrict__ dalb, int B, int N, int R, int Rp) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= N) return;  // warp-uniform
  const size_t row = static_cast<size_t>(b) * N + q;
  const int cnt = max(0, min(counts[b], N));
  if (q >= cnt) {
    if (lane == 0) {
      doc[3 * row] = doc[3 * row + 1] = doc[3 * row + 2] = 0.0f;
      dalb[3 * row] = dalb[3 * row + 1] = dalb[3 * row + 2] = 0.0f;
      dsig[row] = dmag[row] = 0.0f;
    }
    return;
  }
  const float x = oc[3 * row], y = oc[3 * row + 1], z = oc[3 * row + 2];
  const float ocsq = dot3_rn(x, y, z, x, y, z);
  const size_t o = static_cast<size_t>(q) * Rp;
  const Planes P = planes_of(planes, B, N, Rp, b, 0);
  const float* d = dirs + static_cast<size_t>(b) * 3 * R;
  const float* c = dcol + static_cast<size_t>(b) * 3 * R;
  float s_row = 0.0f, s_qmb = 0.0f, s_dsig = 0.0f, s_dinv = 0.0f;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int r = lane; r < R; r += 32) {
    const float dx = d[r], dy = d[R + r], dz = d[2 * R + r];
    const float mb = dot3_rn(x, y, z, dx, dy, dz);
    const float dcoco = static_cast<float>(P.dco[o + r]);
    const float dmb = static_cast<float>(P.dmb[o + r]);
    const float w = P.w[o + r];
    s_row += dcoco;
    s_qmb += dcoco * ocsq_minus_mb2_rn(ocsq, mb);
    s_dinv += static_cast<float>(P.dinv[o + r]);
    s_dsig += P.dsb[o + r];
    ox += dmb * dx;
    oy += dmb * dy;
    oz += dmb * dz;
    ax += w * c[r];
    ay += w * c[R + r];
    az += w * c[2 * R + r];
  }
  s_row = warp_sum(s_row);
  s_qmb = warp_sum(s_qmb);
  s_dsig = warp_sum(s_dsig);
  s_dinv = warp_sum(s_dinv);
  ox = warp_sum(ox);
  oy = warp_sum(oy);
  oz = warp_sum(oz);
  ax = warp_sum(ax);
  ay = warp_sum(ay);
  az = warp_sum(az);
  if (lane == 0) {
    const float s = sig[row];
    const float i2s2 = 1.0f / (2.0f * s * s);
    const float inv = kInvSqrt2 / s;
    const float docsq = s_row * (-i2s2);
    dsig[row] = s_dsig + s_dinv * (-inv / s) + s_row / s + s_qmb / (s * s * s);
    const float m = mag[row];
    dmag[row] = m * s_row / (m == 0.0f ? 1.0f : m * m);
    doc[3 * row] = ox + 2.0f * x * docsq;
    doc[3 * row + 1] = oy + 2.0f * y * docsq;
    doc[3 * row + 2] = oz + 2.0f * z * docsq;
    dalb[3 * row] = ax;
    dalb[3 * row + 1] = ay;
    dalb[3 * row + 2] = az;
  }
}

using RaysKernel = void (*)(const float*, const float*, const float*, const float*,
                            const float*, const int*, const float*, const float*, float*,
                            float*, int, int, int, int, int);

template <bool SAVED_T>
RaysKernel pick_fn(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return bwd_rays_kernel<kErfAs5, kExpExact, SAVED_T>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return bwd_rays_kernel<kErfAs5, kExpFast, SAVED_T>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return bwd_rays_kernel<kErfAs3, kExpExact, SAVED_T>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return bwd_rays_kernel<kErfAs3, kExpFast, SAVED_T>;
  return nullptr;
}

template <bool SAVED_T>
int launch(const float* oc, const float* sig, const float* mag, const float* alb,
           const float* dirs, const int* counts, const float* dcol, const float* t,
           float* planes, float* doc, float* dsig, float* dmag, float* dalb, float* ddirs,
           int B, int N, int R, int threads, int qb, int erf_id, int exp_id, void* stream) {
  RaysKernel fn = pick_fn<SAVED_T>(erf_id, exp_id);
  if (fn == nullptr || B < 1 || B > 65535 || N < 1 || R < 1 || threads < 32 ||
      threads > 128 || threads % 32 != 0 || qb < 1 || qb > 1024 || (SAVED_T && t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ray_blocks = (R + threads - 1) / threads;
  const int Rp = ray_blocks * threads;
  const size_t smem = sizeof(float) * IsoGeo::kFields * qb;
  fn<<<dim3(ray_blocks, B), threads, smem, s>>>(oc, sig, mag, alb, dirs, counts, dcol, t, planes,
                                                ddirs, B, N, R, Rp, qb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kRowWarps - 1) / kRowWarps, B);
  bwd_rows_kernel<<<grid, 32 * kRowWarps, 0, s>>>(oc, sig, mag, dirs, counts, dcol, planes, doc,
                                                  dsig, dmag, dalb, B, N, R, Rp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sgrt_fused_bwd_planes() { return kPlanes; }

int sgrt_fused_bwd_max_threads() { return 128; }

const char* sgrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Saved-T backward: reads T (B,5,N,R) from sgrt_fused_fwd_t instead of
// recomputing pass A. Returns a cudaError_t (cudaErrorInvalidValue for a
// configuration the kernels do not take).
int sgrt_fused_bwd_t(const float* oc, const float* sig, const float* mag, const float* alb,
                     const float* dirs, const int* counts, const float* dcol,
                     const float* t, float* planes, float* doc, float* dsig, float* dmag,
                     float* dalb, float* ddirs, int B, int N, int R, int threads, int qb,
                     int erf_id, int exp_id, void* stream) {
  return launch<true>(oc, sig, mag, alb, dirs, counts, dcol, t, planes, doc, dsig, dmag, dalb,
                      ddirs, B, N, R, threads, qb, erf_id, exp_id, stream);
}

// Recompute backward: pass A (acc_k) is recomputed per p block.
int sgrt_fused_bwd(const float* oc, const float* sig, const float* mag, const float* alb,
                   const float* dirs, const int* counts, const float* dcol, float* planes,
                   float* doc, float* dsig, float* dmag, float* dalb, float* ddirs, int B,
                   int N, int R, int threads, int qb, int erf_id, int exp_id, void* stream) {
  return launch<false>(oc, sig, mag, alb, dirs, counts, dcol, nullptr, planes, doc, dsig, dmag,
                       dalb, ddirs, B, N, R, threads, qb, erf_id, exp_id, stream);
}

}  // extern "C"
