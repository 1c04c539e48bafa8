// The split forward kernels of the Gaussian ray tracer for Hopper (sm_90a):
// the transmittance weights tw and the colors from precomputed
// Gaussian-major (B,N,R) planes.
//
// Replaces the TPU kernels of sgrt_tpu/ops/pallas_kernel.py:
//   _fwd_kernel        (tw_pallas's forward)      entry point sgrt_split_fwd
//   _fwd_color_kernel  (colors_pallas's forward)  entry point sgrt_split_fwd_color
// Their VJPs, _bwd_kernel and _bwd_color_kernel (sgrt_split_bwd,
// sgrt_split_bwd_color), are chunked.cu's recompute backward at one chunk
// over the same planes (gauss_common.cuh, PlaneGeo).
//
// The fused kernels' math (chunked.cu's note) with mb and co read from the
// planes instead of made from oc and the ray: for tile b, count = min(counts,
// N), ray r, taps k = -4..0,
//   base(r)    = sum over ALL N rows q of co(q,r) erf(-mb(q,r) inv_q)
//   acc_k(p,r) = sum_{q < count} co(q,r) erf((mb(p,r) + k sigma_p - mb(q,r)) inv_q)
//   T_k(p,r)   = w_k exp(base(r) - acc_k(p,r)),  tw = sum_k T_k   (p < count; 0 past it)
//   colors(:,r)= sum_{p < count} albedo_p sqrt(2/pi) co(p,r) tw(p,r)
// base sums every row, as the Pallas kernels do; sigma_p of the taps and inv
// are separate inputs (inv is not recomputed from sigma).
//
// What bounds it on this card: operations. Per live (p, q, ray) the forward
// evaluates five erf taps (~17 FP32, 2 SFU each, gauss_common.cuh). The
// planes move far fewer bytes: each kernel reads 2-3 (B,N,R) planes of 4
// bytes a (row, ray), against 5 taps per (row, ray) and live row.
//
// What the design does about it:
//   * One thread owns one ray and keeps PB rows' state in registers; pass A
//     is gauss_common.cuh's pass_a over StagedPlanes rows: the q rows' mb
//     and co of each thread's ray are staged through shared memory
//     (coalesced loads of qs rows at a time), with their inv. base runs over all N rows
//     in its own sweep (pass_a's base would stop at the count).
//   * The p axis is split over blocks of 32 rows, so a tile spreads over
//     many SMs; the colors' per-split partials are summed in split order. No
//     atomics: every result is deterministic.
//   * Float32 at thousands of rows: acc and base are two-level, each block
//     of kMaxStage rows summed on its own and then added to the running sum.
//
// Layouts (float32 unless noted, contiguous): mb, co, tw (B,N,R); sigma, inv
// (B,N); albedo (B,N,3); colors (B,3,R); counts (B,) int32. Scratch: partial
// (B, N/32, 3, R) for the colors.

#include <cuda_runtime.h>

#include "gauss_common.cuh"

namespace {

using namespace sgrt;

constexpr int kRowsPerBlock = 32;  // forward: p rows per block
constexpr int kMaxThreads = 128;
constexpr int kMaxStage = 32;      // rows per staged pass and per first-level sum

// The split forwards' rows: a row's terms for the thread's ray are read
// from the planes (as gauss_common.cuh's PlaneGeo reads them for the
// backwards). pass_a (gauss_common.cuh) calls stage and staged;
// each thread stages its own ray's mb and co of the qs rows (field-major,
// st[j * T + t], T = blockDim.x), then the rows' inv. A lane past R reads
// mb = co = 0, so every sum it makes is zero.
struct StagedPlanes {
  const float* mb;   // the thread's ray in tile b: mb[q * R]
  const float* co;
  const float* inv;  // tile b's rows
  int R;
  bool live;

  __device__ StagedPlanes(const float* mb_, const float* co_, const float* inv_, int b, int N,
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

// base(r) over all N rows, two-level (blocks of kMaxStage rows).
template <int ERF>
__device__ float plane_base(const StagedPlanes& g, int N) {
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

  const StagedPlanes geo(mb, co, inv, b, N, R, r);
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
// launches
// ---------------------------------------------------------------------------

using FwdKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const int*, float*, float*, int, int, int, int);

template <int PB, bool COLORS>
FwdKernel pick_fwd_pb(int erf_id, int exp_id) {
  if (erf_id == kErfAs5 && exp_id == kExpExact) return split_fwd_kernel<PB, kErfAs5, kExpExact, COLORS>;
  if (erf_id == kErfAs5 && exp_id == kExpFast) return split_fwd_kernel<PB, kErfAs5, kExpFast, COLORS>;
  if (erf_id == kErfAs3 && exp_id == kExpExact) return split_fwd_kernel<PB, kErfAs3, kExpExact, COLORS>;
  if (erf_id == kErfAs3 && exp_id == kExpFast) return split_fwd_kernel<PB, kErfAs3, kExpFast, COLORS>;
  return nullptr;
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
  const size_t smem = sizeof(float) * StagedPlanes::stage_floats(qs, threads);
  fn<<<dim3((R + threads - 1) / threads, n_split, B), threads, smem, s>>>(
      mb, co, sig, inv, alb, counts, tw, partial, N, R, qs, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !COLORS) return static_cast<int>(err);
  // colors = the live splits' partials summed in split order
  return static_cast<int>(
      launch_block_sums(partial, counts, colors, B, N, 3 * R, n_split, kRowsPerBlock, 0, s));
}

}  // namespace

extern "C" {

int sgrt_split_fwd_rows_per_block() { return kRowsPerBlock; }

int sgrt_split_max_threads() { return kMaxThreads; }

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

}  // extern "C"
