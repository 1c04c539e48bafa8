// Fused forward of the Gaussian ray tracer: per-tile colors from raw tile
// scenes, for Hopper (sm_90a), optionally also writing the transmittance
// factors T that the saved-T backward reads.
//
// Replaces the TPU kernels sgrt_tpu/ops/pallas_kernel.py::_fused_fwd_kernel
// (launched by _fused_fwd_call; entry point sgrt_fused_fwd) and
// ::_fused_fwd_t_kernel (launched by _fused_fwd_t_call; entry point
// sgrt_fused_fwd_t, the SAVE_T instantiation), and for capacities above
// 4096 rows also sgrt_tpu/ops/pallas_chunked.py::_chunked_fwd_kernel and
// ::_chunked_fwd_t_kernel: the TPU cuts the Gaussian axis into chunks only
// because a dense tile's rows do not fit VMEM, and a q sweep chunk by chunk
// stages here exactly the rows of one sweep over the live prefix, while the
// p split below already spreads a dense tile over many blocks (at the
// 50k-Gaussian sphere's dense bucket, a 64-row chunked copy of this kernel
// took 1221 ms against this one's 1202 ms on an NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py). The anisotropic entry points (sgrt_fused_fwd_aniso,
// sgrt_fused_fwd_t_aniso) replace sgrt_tpu/ops/pallas_aniso.py's
// ::_fused_fwd_aniso_kernel and ::_fused_fwd_t_aniso_kernel: the same
// kernel over AnisoGeo rows (gauss_common.cuh), whose sb, inv and co vary
// per (row, ray); the TPU kernel keeps them as four (N, ray block) VMEM
// planes, here each thread recomputes a staged row's terms for its ray.
// For each tile b, over the live prefix count_b = min(counts[b], N) of its
// Gaussian rows, and each ray r (isotropic rows: sb = sigma, mb = oc . d):
//
//   co(q,r)   = mag_q sb(q,r) sqrt(pi/2) exp(exponent(q,r))
//   inv(q,r)  = 1 / (sqrt2 sb(q,r))
//   base(r)   = sum_q co(q,r) erf(-mb(q,r) inv(q,r))
//   acc_k(p,r)= sum_q co(q,r) erf((mb(p,r) + k sb(p,r) - mb(q,r)) inv(q,r)),  k = -4..0
//   T_k(p,r)  = w_k exp(base(r) - acc_k(p,r)),  w_k = exp(-k^2/2)
//   colors(:,r) = sum_p albedo_p sqrt(2/pi) co(p,r) sum_k T_k(p,r)
//
// SAVE_T also writes T (B,5,N,R); rows at or past the count hold T = 0, as
// the TPU kernel's up-front clear leaves them (the saved-T backward relies
// on it).
//
// What bounds it on this card: operations, not bytes. The inputs are
// O(B N) floats, the work O(sum_b count_b^2 R): five erf evaluations per
// (p, q, ray). Each A&S 5-term erf tap is about 17 FP32 instructions (FMA,
// MUL, the Newton steps of the IEEE reciprocal and the range reduction of
// expf) and 2 SFU operations (MUFU.RCP, MUFU.EX2). At 16 SFU results per
// clock per SM (compute capability 9.0) the SFU pipe and the FP32 pipe
// bound a tap at about the same rate, ~2e12 taps/s on an H100 SXM. SAVE_T
// adds 20 bytes per (p, ray) of writes, which stays far below the
// operations' time at any count above a few rows.
//
// What the design does about it:
//   * Nothing per (q, ray) or (p, q, ray) goes to device memory: one thread
//     owns one ray, keeps PB p-rows' 5 accumulators in registers, and
//     recomputes mb and co of each q row from staged rows (one exp per q
//     against 5*PB erfs).
//   * The q rows are staged through shared memory, qb rows at a time, with
//     their per-row constants (|oc|^2, 1/(2 sigma^2), 1/(sqrt2 sigma),
//     mag sigma sqrt(pi/2)) precomputed once per stage; each stage's terms
//     are summed on their own before they join acc_k and base
//     (gauss_common.cuh, pass_a), which keeps T accurate at thousands of rows.
//   * Loops run over the live prefix only, and p rows past the count are
//     never read, so cost follows count^2, not capacity^2.
//   * The p axis of a tile is split over blocks of kRowsPerBlock rows, so a
//     dense tile spreads over many SMs instead of bounding the launch by
//     itself. Each split writes its partial colors; a second kernel sums
//     the live splits of each tile in a fixed order. No atomics: the result
//     is deterministic. With SAVE_T every split writes its own rows of T
//     (zeros past the count), so T needs no clearing pass.
//
// Layouts (all float32, contiguous): oc (B,N,3), sigma (B,N) or, for
// anisotropic rows, invd (B,N,3), mag (B,N),
// albedo (B,N,3), dirs (B,3,R) ray-minor, counts (B,) int32; partial
// (B, n_split, 3, R) scratch, colors (B,3,R) and, with SAVE_T, t
// (B,5,N,R) are written.

#include <cuda_runtime.h>

#include "gauss_common.cuh"

namespace {

using namespace sgrt;

constexpr int kRowsPerBlock = 32;  // p rows per block (split of the p axis)

template <int PB, int ERF, int EXP, bool SAVE_T, class Geo>
__global__ void __launch_bounds__(128)
fused_fwd_kernel(const float* __restrict__ oc, const float* __restrict__ shape,
                 const float* __restrict__ mag, const float* __restrict__ alb,
                 const float* __restrict__ dirs, const int* __restrict__ counts,
                 float* __restrict__ partial, float* __restrict__ t, int N, int R,
                 int qb, int n_split) {
  extern __shared__ float stage[];
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int cnt = max(0, min(counts[b], N));
  const int p_begin = split * kRowsPerBlock;
  // Lanes past R trace a unit +z ray so their math stays finite; they stage
  // rows and take part in the barriers but write nothing.
  const bool live_ray = r < R;

  // T rows of this split at or past the count are zero
  float* t_b = SAVE_T ? t + static_cast<size_t>(b) * kTaps * N * R : nullptr;
  if (SAVE_T && live_ray) {
    const int dead_end = min(p_begin + kRowsPerBlock, N);
    for (int p = max(p_begin, cnt); p < dead_end; ++p) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) t_b[(static_cast<size_t>(k) * N + p) * R + r] = 0.0f;
    }
  }
  if (p_begin >= cnt) return;  // block-uniform: this split has no live rows
  const int p_end = min(p_begin + kRowsPerBlock, cnt);

  const Geo geo(oc, shape, mag, b, N);
  const float* alb_b = alb + static_cast<size_t>(b) * N * 3;

  float dx = 0.0f, dy = 0.0f, dz = 1.0f;
  if (live_ray) {
    const float* d = dirs + static_cast<size_t>(b) * 3 * R;
    dx = d[r];
    dy = d[R + r];
    dz = d[2 * R + r];
  }

  float base = 0.0f;
  float col_r = 0.0f, col_g = 0.0f, col_b = 0.0f;

  for (int p0 = p_begin; p0 < p_end; p0 += PB) {
    float mbp[PB], sgp[PB], acc[PB][kTaps];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int p = p0 + i;
      mbp[i] = 0.0f;
      sgp[i] = 1.0f;
      if (p < p_end) {
        const RayTerms tp = geo.template row<EXP>(p, dx, dy, dz);
        mbp[i] = tp.mb;
        sgp[i] = tp.sb;
      }
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc[i][k] = 0.0f;
    }
    // base is summed once, by the first group
    pass_a<PB, ERF, EXP>(stage, qb, geo, 0, cnt, dx, dy, dz, mbp, sgp, acc, p0 == p_begin,
                         base);

#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int p = p0 + i;
      if (p < p_end) {
        float tw = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const float tk = tap_weight(k) * exp_fn<EXP>(base - acc[i][k]);
          if (SAVE_T && live_ray) t_b[(static_cast<size_t>(k) * N + p) * R + r] = tk;
          tw += tk;
        }
        const float wp = kSqrt2Pi * geo.template row<EXP>(p, dx, dy, dz).co * tw;
        col_r += alb_b[3 * p] * wp;
        col_g += alb_b[3 * p + 1] * wp;
        col_b += alb_b[3 * p + 2] * wp;
      }
    }
  }

  if (live_ray) {
    float* out = partial + (static_cast<size_t>(b) * n_split + split) * 3 * R;
    out[r] = col_r;
    out[R + r] = col_g;
    out[2 * R + r] = col_b;
  }
}

using FwdKernel = void (*)(const float*, const float*, const float*, const float*,
                           const float*, const int*, float*, float*, int, int, int, int);

template <int PB, bool SAVE_T, class Geo>
FwdKernel pick_fn(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return fused_fwd_kernel<PB, kErfAs5, kExpExact, SAVE_T, Geo>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return fused_fwd_kernel<PB, kErfAs5, kExpFast, SAVE_T, Geo>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return fused_fwd_kernel<PB, kErfAs3, kExpExact, SAVE_T, Geo>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return fused_fwd_kernel<PB, kErfAs3, kExpFast, SAVE_T, Geo>;
  return nullptr;
}

template <bool SAVE_T, class Geo>
int launch(const float* oc, const float* shape, const float* mag, const float* alb,
           const float* dirs, const int* counts, float* partial, float* colors, float* t,
           int B, int N, int R, int threads, int pb, int qb, int erf_id, int exp_id,
           void* stream) {
  FwdKernel fn = nullptr;
  if (pb == 8) fn = pick_fn<8, SAVE_T, Geo>(erf_id, exp_id);
  if (pb == 16) fn = pick_fn<16, SAVE_T, Geo>(erf_id, exp_id);
  if (fn == nullptr || B < 1 || B > 65535 || N < 1 || R < 1 || threads < 32 ||
      threads > 128 || threads % 32 != 0 || qb < 1 || qb > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  if (n_split > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + threads - 1) / threads, n_split, B);
  const size_t smem = sizeof(float) * Geo::kFields * qb;
  fn<<<grid, threads, smem, s>>>(oc, shape, mag, alb, dirs, counts, partial, t, N, R, qb,
                                 n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // colors = the live splits' partials summed in split order
  return static_cast<int>(
      launch_block_sums(partial, counts, colors, B, N, 3 * R, n_split, kRowsPerBlock, 0, s));
}

}  // namespace

extern "C" {

int sgrt_fused_fwd_rows_per_block() { return kRowsPerBlock; }

int sgrt_fused_fwd_max_threads() { return 128; }

const char* sgrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the fused forward and the split reduction on `stream`. Returns
// a cudaError_t: the launch's own error, or cudaErrorInvalidValue for a
// configuration the kernel does not take.
int sgrt_fused_fwd(const float* oc, const float* sig, const float* mag,
                   const float* alb, const float* dirs, const int* counts,
                   float* partial, float* colors, int B, int N, int R,
                   int threads, int pb, int qb, int erf_id, int exp_id,
                   void* stream) {
  return launch<false, IsoGeo>(oc, sig, mag, alb, dirs, counts, partial, colors, nullptr, B,
                               N, R, threads, pb, qb, erf_id, exp_id, stream);
}

// The same forward, also writing T (B,5,N,R) for the saved-T backward.
int sgrt_fused_fwd_t(const float* oc, const float* sig, const float* mag,
                     const float* alb, const float* dirs, const int* counts,
                     float* partial, float* colors, float* t, int B, int N, int R,
                     int threads, int pb, int qb, int erf_id, int exp_id,
                     void* stream) {
  return launch<true, IsoGeo>(oc, sig, mag, alb, dirs, counts, partial, colors, t, B, N, R,
                              threads, pb, qb, erf_id, exp_id, stream);
}

// The anisotropic forward: invd (B,N,3) = scale^-2 in place of sigma.
int sgrt_fused_fwd_aniso(const float* oc, const float* invd, const float* mag,
                         const float* alb, const float* dirs, const int* counts,
                         float* partial, float* colors, int B, int N, int R,
                         int threads, int pb, int qb, int erf_id, int exp_id,
                         void* stream) {
  return launch<false, AnisoGeo>(oc, invd, mag, alb, dirs, counts, partial, colors, nullptr,
                                 B, N, R, threads, pb, qb, erf_id, exp_id, stream);
}

// The anisotropic forward, also writing T (B,5,N,R).
int sgrt_fused_fwd_t_aniso(const float* oc, const float* invd, const float* mag,
                           const float* alb, const float* dirs, const int* counts,
                           float* partial, float* colors, float* t, int B, int N, int R,
                           int threads, int pb, int qb, int erf_id, int exp_id,
                           void* stream) {
  return launch<true, AnisoGeo>(oc, invd, mag, alb, dirs, counts, partial, colors, t, B, N,
                                R, threads, pb, qb, erf_id, exp_id, stream);
}

}  // extern "C"
