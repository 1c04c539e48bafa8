// Tiling for Hopper (sm_90a): per tile, the first K member Gaussians in
// ascending index order and the true member count, in one launch.
//
// Replaces no Pallas kernel: the JAX package tiles with a chain of XLA
// operations (sgrt_tpu/ops/tiling.py:162 tile_indices: projection, the
// (T2, N) membership matrix, counts and a top-k compaction). The port's
// plain version of that chain (sgrt_tpu_torch/ops/tiling.py:
// project_gaussians, tile_membership, compact_rows) is ~120 small torch
// operations a call, and it uploaded the focal length each call with a copy
// that synchronised the stream. This kernel does the chain's work in one
// launch, reads the focal length through a device pointer and synchronises
// nothing.
//
// Design: one block per tile walks the Gaussians in ascending order, 256 at
// a time. Each thread projects one Gaussian and tests it against the tile;
// a block-wide exclusive scan of the test (warp ballots, then the warps'
// counts in shared memory) gives each member its slot. Slots below K are
// written, the rest of the row is filled with the dummy index N, and the
// true count is written. No atomics: the output is the same on every run
// and equals the plain version's "first K members, ascending" rule.
// Every tile projects every Gaussian again (T2 x N projections, ~2 M at the
// north star's 32x16 tiles and 3644 Gaussians): a few microseconds, and no
// second launch. The bound is the throughput of the projection's ~20
// instructions a (tile, Gaussian) pair; the reads (16 N bytes a tile) come
// from L2.
//
// The float32 result equals the plain version's bit for bit: every product,
// sum and quotient is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn;
// no FMA contraction), in the plain version's order:
//   p_i    = ((mu0 v_i0 + mu1 v_i1) + mu2 v_i2) + v_i3     (i = 0, 1, 2)
//   valid  = p_2 >= 1; with a focal length f: denom = p_2 + f,
//            mu' = (f p_xy) / denom, sigma' = (f sigma) / denom;
//            without one: mu' = p_xy / p_2, sigma' = sigma / p_2
//   valid &= sigma' >= 1e-5f
//   member = valid and |c - mu'| <= (float)(1/tx) + 3.3f sigma' on x
//            (1/ty on y), c the tile's centre from tile_centers.

#include <cuda_runtime.h>

#include "gauss_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Tile {
  float cx, cy, hx, hy;
};

// Whether Gaussian q lies in the tile (the plain version's tight test).
__device__ __forceinline__ bool member_of(const float* __restrict__ mu,
                                          const float* __restrict__ sigma, const float (&v)[12],
                                          const float* f, const Tile& t, int q) {
  const float m0 = mu[3 * q], m1 = mu[3 * q + 1], m2 = mu[3 * q + 2];
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m0, v[4 * i]), __fmul_rn(m1, v[4 * i + 1])),
                               __fmul_rn(m2, v[4 * i + 2])),
                     v[4 * i + 3]);
  if (!(p[2] >= 1.0f)) return false;
  float x = p[0], y = p[1], s = sigma[q], denom = p[2];
  if (f != nullptr) {
    const float fl = *f;
    denom = __fadd_rn(denom, fl);
    x = __fmul_rn(fl, x);
    y = __fmul_rn(fl, y);
    s = __fmul_rn(fl, s);
  }
  x = __fdiv_rn(x, denom);
  y = __fdiv_rn(y, denom);
  s = __fdiv_rn(s, denom);
  if (!(s >= 1e-5f)) return false;
  const float reach = __fmul_rn(3.3f, s);
  return fabsf(__fsub_rn(t.cx, x)) <= __fadd_rn(t.hx, reach) &&
         fabsf(__fsub_rn(t.cy, y)) <= __fadd_rn(t.hy, reach);
}

// One block per tile: idx (T2, K) int32, counts (T2,) int32 from mu (N, 3),
// sigma (N,), view (>= 3 rows of 4, row-major), focal (one float or null)
// and centers (T2, 2).
__global__ void __launch_bounds__(kThreads)
    tile_compact_kernel(const float* __restrict__ mu, const float* __restrict__ sigma,
                        const float* __restrict__ view, const float* __restrict__ focal,
                        const float* __restrict__ centers, int* __restrict__ idx,
                        int* __restrict__ counts, int N, int tx, int ty, int K) {
  __shared__ int warp_count[kWarps];
  const int tile = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tile t{centers[2 * tile], centers[2 * tile + 1], __double2float_rn(1.0 / tx),
               __double2float_rn(1.0 / ty)};
  float v[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) v[i] = view[i];
  int* row = idx + static_cast<size_t>(tile) * K;
  int before_chunk = 0;  // members of the tile among the Gaussians already walked
  for (int q0 = 0; q0 < N; q0 += kThreads) {
    const int q = q0 + threadIdx.x;
    const bool in = q < N && member_of(mu, sigma, v, focal, t, q);
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = before_chunk + __popc(ballot & ((1u << lane) - 1u)), chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      slot += w < warp ? c : 0;
      chunk += c;
    }
    if (in && slot < K) row[slot] = q;
    before_chunk += chunk;
    __syncthreads();  // warp_count is written again by the next chunk
  }
  for (int s = min(before_chunk, K) + threadIdx.x; s < K; s += kThreads) row[s] = N;
  if (threadIdx.x == 0) counts[tile] = before_chunk;
}

}  // namespace

extern "C" {

const char* sgrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// This library reads no approximation table (CudaKernel fills one before a
// library's first launch on a device): nothing to fill.
int sgrt_set_approx_tables(const float*, int) { return 0; }

// The tiling on `stream`: idx (T2, K) and counts (T2,), T2 = tx ty, from mu
// (N, 3), sigma (N,), view (4, 4), focal (a float on the card, or null for
// the view-frame projection) and centers (T2, 2), all contiguous. Returns a
// cudaError_t.
int sgrt_tile_compact(const float* mu, const float* sigma, const float* view, const float* focal,
                      const float* centers, int* idx, int* counts, int N, int tx, int ty, int K,
                      void* stream) {
  if (N < 0 || tx < 1 || ty < 1 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  tile_compact_kernel<<<tx * ty, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mu, sigma, view, focal, centers, idx, counts, N, tx, ty, K);
  return static_cast<int>(cudaGetLastError());
}

// Resources of kernel i of this library (one kernel, at its block size):
// kernel_resources's seven ints into out, its name into name. Returns -1
// past the last kernel.
int sgrt_kernel_resources(int i, int, int, int* out, const char** name) {
  if (i != 0) return -1;
  *name = "tiling tile_compact_kernel";
  return sgrt::kernel_resources(tile_compact_kernel, kThreads, 0, out);
}

}  // extern "C"
