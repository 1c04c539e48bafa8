// The Gaussian-axis chunked kernels for Hopper (sm_90a), designed for the
// card, over the row geometries of gauss_common.cuh (IsoGeo, AnisoGeo, and
// for the split kernels PlaneGeo):
// the forward (colors, and by its store mode the transmittance factors T or
// their sum tw) and the backward (p side, q side; from saved T or
// recomputing it), with the Gaussian axis cut into chunks of ck rows.
//
// Replaces the TPU kernels sgrt_tpu/ops/pallas_chunked.py::
// _chunked_fwd_kernel (entry point sgrt_chunked_fwd), ::_chunked_fwd_t_kernel
// (sgrt_chunked_fwd_t), ::_chunked_bwd_t_kernel (sgrt_chunked_bwd_t, from
// saved T) and ::_chunked_bwd_kernel (sgrt_chunked_bwd, recomputing T), and
// sgrt_tpu/ops/pallas_chunked_aniso.py::_chunked_fwd_aniso_kernel
// (sgrt_chunked_fwd_aniso and, with T, sgrt_chunked_fwd_t_aniso, the
// saved-T schedule's forward) and ::_chunked_bwd_aniso_kernel
// (sgrt_chunked_bwd_aniso, recomputing T; sgrt_chunked_bwd_t_aniso is its
// saved-T schedule, which the reference leaves out only for lack of TPU
// memory, pallas_chunked_aniso.py:19-22). Isotropic and anisotropic entry
// points run the same templates; the geometry decides a row's per-ray terms
// and J = d mb / d d (Side<Geo>, chunked_common.cuh).
//
// The fused kernels are this forward and backward at one chunk (ck = N):
// the same functions, since a fused kernel is the chunked one with C = 1.
// The forwards: sgrt_tpu/ops/pallas_kernel.py::_fused_fwd_kernel
// (sgrt_fused_fwd; pallas_kernel.py:862) and ::_fused_fwd_t_kernel
// (sgrt_fused_fwd_t; :898) over isotropic rows, and
// sgrt_tpu/ops/pallas_aniso.py::_fused_fwd_aniso_kernel
// (sgrt_fused_fwd_aniso) and ::_fused_fwd_t_aniso_kernel
// (sgrt_fused_fwd_t_aniso) over anisotropic ones. The backwards:
// pallas_kernel.py::_fused_bwd_t_kernel (sgrt_fused_bwd_t, from
// sgrt_fused_fwd_t's T) and ::_fused_bwd_kernel (sgrt_fused_bwd,
// recomputing T) over isotropic rows, and
// pallas_aniso.py::_fused_bwd_t_aniso_kernel (sgrt_fused_bwd_t_aniso, from
// sgrt_fused_fwd_t_aniso's T) and ::_fused_bwd_aniso_kernel
// (sgrt_fused_bwd_aniso) over anisotropic ones. N need not be a multiple
// of 32 or 64 there (the route pads it to its p and q blocks): the last
// 32-row forward split and 64-row backward block are partial, and every
// row read or written stays below min(count, N); T rows at or past the
// count, up to N, are written as zeros. The recompute's forward-with-T is
// the fused forward-with-T itself (the same kernel at the same qb; pb
// does not change it), so the two fused backwards of a geometry give the
// same gradients.
//
// The split kernels are this forward and the recompute backward at one
// chunk over a third geometry, plane rows (PlaneGeo, Side<PlaneGeo>). The
// forwards: sgrt_tpu/ops/pallas_kernel.py::_fwd_kernel (sgrt_split_fwd;
// :181, tw_pallas's forward, storing tw) and ::_fwd_color_kernel
// (sgrt_split_fwd_color; :213, colors_pallas's forward, colors only). The
// backwards: ::_bwd_kernel (sgrt_split_bwd; :256, tw_pallas's VJP) and
// ::_bwd_color_kernel (sgrt_split_bwd_color; :329, colors_pallas's VJP). A
// row's mb and co are read per (row, ray) from (B,N,R) planes, sb = sigma
// and inv from (B,N) inputs of their own (inv is not made from sigma). The
// math below with one difference: base sums ALL N rows, past the count too,
// as the Pallas kernels do (pass_a_planes stages the rows past the count
// for base alone):
//   base(r)    = sum over all N rows q of co(q,r) erf(-mb(q,r) inv_q)
//   tw(p,r)    = sum_k T_k(p,r)   (p < count; 0 at or past it, up to N)
// The backwards are the same T, p side and q side, where the cotangent of
// tw is g from its plane (sgrt_split_bwd, no direct terms) or sqrt(2/pi) co
// A with the direct terms (sgrt_split_bwd_color); and the outputs are the
// planes' own gradients, dmb and dco per (row, ray) and dsig, dinv (and
// dalb) per row, so there is no chain, no J and no ddirs. The p side writes
// its part of dmb and dco, the q side adds its pair sums and the base path
// in stream order; the base path reaches every row of the tile, so rows
// past the count get dco = db e1, dmb = -2/sqrt(pi) db co g1 inv and the
// matching dinv (q side blocks past the count run it alone), and a tile
// with count 0 gets zeros (its db is 0).
//
// The forward, for each tile b, over the live prefix count_b = min(counts[b],
// N) of its Gaussian rows, and each ray r (isotropic rows: sb = sigma,
// mb = oc . d; over anisotropic rows sb, inv and co vary per (row, ray),
// gauss_common.cuh AnisoGeo):
//   co(q,r)    = mag_q sb(q,r) sqrt(pi/2) exp(exponent(q,r))
//   inv(q,r)   = 1 / (sqrt2 sb(q,r))
//   base(r)    = sum_q co(q,r) erf(-mb(q,r) inv(q,r))
//   acc_k(p,r) = sum_q co(q,r) erf((mb(p,r) + k sb(p,r) - mb(q,r)) inv(q,r)),  k = -4..0
//   T_k(p,r)   = w_k exp(base(r) - acc_k(p,r)),  w_k = exp(-k^2/2)
//   colors(:,r) = sum_p albedo_p sqrt(2/pi) co(p,r) sum_k T_k(p,r)
// Its store mode (Store) adds T (B,5,N,R) (the forward-with-T) or tw
// (B,N,R) (the split forward, which leaves the colors out); rows at or past
// the count hold T = 0 and tw = 0, as the TPU kernels' up-front clear
// leaves them (the saved-T backward relies on it).
//
// The backward is its VJP, in the reference's order
// (pallas_kernel.py:125-174, :1028-1070), with the forward's mb, co, inv
// and sb per (row, ray) (isotropic: sb = sigma) and for live p, q:
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
// then the chain through the prep to the raw inputs, isotropic:
//   dcoco = dco co;  dmb += dcoco 2/(2 sigma^2) mb;  ddirs(r) = sum_q oc_q dmb_q;
//   per row, summed over rays: s_row = sum dcoco, s_qmb = sum dcoco (|oc|^2 - mb^2),
//   dsig = sum dsb_p - sum dinv inv/sigma + s_row/sigma + s_qmb/sigma^3,
//   dmag = mag s_row / (mag == 0 ? 1 : mag^2),  doc = sum_r dmb d(r) - 2 oc s_row/(2 sigma^2);
// anisotropic, through A, Bt and C: pallas_aniso.py's _aniso_epilogue,
// Side<AnisoGeo> in chunked_common.cuh. Rows at or past the count get
// exactly zero gradient. Every cotangent that reaches the raw inputs is
// LINEAR in the per-(row, ray) sums (dco, dmb, dinv, dsb_p, the albedo
// weight), and the base path is linear in db (pallas_chunked.py:46-51). So
// the pair work is split in two and summed in any fixed order:
//   p side (bwd_p_kernel), per live p row of chunk a and ray, over every
//     live q: dmb_p += S0 inv_q, dsb_p += S1 inv_q; plus the direct terms
//     dco_p += sqrt(2/pi) tw_p A_p and dalb_p's weight sqrt(2/pi) co_p tw_p
//   q side (bwd_q_kernel), per live q row and ray, over the p rows of ONE
//     p-chunk a: dco_q -= sum_k G_k ee_k, dmb_q -= S0 inv_q,
//     dinv_q += S0 (mb_p - mb_q) + S1 sb_p; then the base path with
//     chunk a's partial db_a = sum_{p in a} g_p tw_p, as the Pallas kernel
//     chains it per (a, bq) (pallas_chunked.py:493-508).
// Each side chains its own sums through the geometry's prep and reduces
// them over the warp's rays into ten per-row sums; bwd_rows_kernel adds the
// p side's and the q side's and forms the per-row gradients. The chains are linear too, so they split by side
// exactly, as the reference splits them (pallas_chunked_aniso.py:333-348:
// dsb on the p side, dinv on the q side; Side<Geo> in chunked_common.cuh
// names the sums). ddirs sums the per-block partials of each row's chain.
// A row's dmb reaches ddirs through J = d mb / d d (isotropic: oc;
// anisotropic: sb^2 (M - 2 mb invd d), M = oc invd), and a pair adds
// S0 inv_q to dmb_p and takes it from dmb_q, so the pair's share is
// (J_p - J_q) S0 inv_q: the p side sums it as that difference and the q
// side leaves its pair terms out of ddirs, since the two sides' separate
// sums are large and cancel (summed apart they lost ~30x the plain
// version's accuracy at ~4000 isotropic rows). The host loops over
// p-chunks a in order (pass A with T, P, db_a, Q per chunk), so sums
// carried across chunks (the q side's) are read-modify-writes in stream
// order: deterministic, no atomics.
//
// What bounds them on this card: operations. Per live (p, q, ray) the
// forward evaluates five A&S erf taps, the backward's p side five
// exp(-x^2) and its q side five erf-and-gauss taps; the recompute backward
// adds the forward's pass A. Each A&S 5-term erf tap (gauss_common.cuh,
// erf_and_gauss<kErfAs5>) is 19 instructions of the FP32 and integer pipes
// (the argument, 1 + p|x|, the Horner chain, the accurate expf of -x^2 with
// x^2's rounding carried by an FMA, 1 - poly g, the sign by LOP3) and 2
// SFU operations (MUFU.RCP, the SFU's reciprocal, and expf's MUFU.EX2);
// the bound counts 17 FP32 and 2 SFU a tap (chip_smoke.py's TAP_FP32). The
// p side's exp(-x^2) alone is gauss. The built forward's pass-A loop issues
// ~23.9 instructions a tap with its operand reads and sums (kernel_resources'
// SASS count; with the IEEE division and sign(x) by compares it issued
// ~42.9). At 16 SFU results per clock per SM (compute capability 9.0) 2
// MUFU a tap allow 8 taps a clock, and the 4 schedulers' 128
// lane-instructions a clock 128 / 23.9 = 5.4: the forward is bound by
// issue. The tap's accuracy (gauss_common.cuh, test_as5_tap_accuracy): e
// within twice the IEEE form's error against the formula in float64, g
// within 2^-21 of itself where it is above 2^-100, e(0) = 0 and e = +-1 for
// |x| >= 4, exactly. The
// other erfs of the forward's taps (gauss_common.cuh) use no SFU: taylor
// ~23 FP32 (a clamp, x^2, a 10-term Horner), the two splines ~12-14 FP32
// (saturation tests, a clamp, the segment's index floor(x / width), a
// 3-step Horner) with 4 indexed constant-bank loads, which serialize when
// a warp's lanes fall in different segments; the spline exp the same, the
// fast exp 4 FP32. The backward's taps are the erf's pair (as5's for those
// three), so they cost what as5's cost. Each
// staged row also needs its per-ray terms
// (isotropic: mb = oc . d and co, one exp; anisotropic: A, Bt, two IEEE
// square roots, a division, an exp: ~40 FP32 and 3 MUFU) and, on the p
// side, J. Bytes stay far below: T is 20 bytes per (row, ray), written once
// by the forward-with-T and read once per 64 q rows by the backward.
// Tensor cores do not apply: no step is a matrix product (every term is an
// erf or exp of its own pair's argument), and TF32 would not hold mb's
// cancellation anyway.
//
// What the design does about it (the templates it replaces kept 8 rows a
// thread and both levels of every sum in registers: the forward ran at 128
// registers and 16 warps an SM, the anisotropic one spilled, the recompute
// p side ran at 255 registers and 8 warps an SM with pass A inside it, and
// each 8-row group of a block recomputed every staged row's terms for its
// ray):
//   * Warp-wide row groups. A block is 32 rays (one warp) by G groups of 4
//     rows: the forward G = 8 (32 p rows a block, 256 threads, 4 blocks and
//     32 warps an SM at <= 64 registers; under the piecewise cubics 3 or 2
//     blocks, fwd_blocks), the backward G = 16 (64 rows,
//     512 threads: the p side 16 warps an SM at <= 128 registers, the q
//     side 32 at <= 64). Sums over a group's rays are warp butterflies: no
//     barrier per row. Blocks of 64 rows spread a 5000-row tile over ~80
//     blocks of each side.
//   * Planes in shared memory. For each stage of qb rows of the other
//     side, the block computes every staged row's per-ray terms once,
//     spread over its G groups, into planes [field][row][ray] (rays minor:
//     no bank conflicts), and all groups sweep them: pass A's mb, inv, co
//     and base term co erf(-mb inv); the p side's mb, inv, -2/sqrt(pi) co
//     and J; the q side's mb, sb and g = sqrt(2/pi) co (albedo . dcol) of
//     the p rows, and the stage's T slab (5 qb rays floats, copied with
//     cp.async). The planes are double-buffered: stage s+1 is filled (and
//     its T copied) while stage s is summed, one barrier per stage.
//     Isotropic rows' inv, sb and J = oc are per row, not per ray; they
//     fill the planes all the same (one value across the 32 lanes): every
//     kernel's occupancy is bound by registers (64 x 1024 or 128 x 512
//     threads fill the 64K), not by shared memory, so planes of their own
//     per row would buy no block an SM and add a second read path.
//   * A register budget without spills: the second level of every
//     two-level sum (pass A's acc, the p side's dmb/dsb, the q side's dco/
//     dmb/dinv), the p side's J, A and tw and the q side's own rows' mb and
//     inv live in the thread's own slots of shared memory, touched once per
//     stage, row or pair; __launch_bounds__ names the blocks per SM, so
//     ptxas keeps each kernel within the registers that its occupancy
//     allows, with no local memory.
//   * The recompute backward is the saved-T one with T made per chunk: the
//     forward-with-T kernel, over chunk a's rows only, writes chunk a's T to
//     scratch before the p side reads it. So pass A runs at the forward's
//     occupancy (the p side's pair pass needs twice its registers), and the
//     recomputed T is the saved one bit for bit: both backwards give the
//     same gradients. T is rounded with __fmul_rn whether or not it is
//     stored, so the forward's colors equal the forward-with-T's.
//   * Float32 at thousands of rows: every sum over the other side's rows
//     is two-level (each stage's terms summed on their own, then the stages
//     in order), since dco and T are differences of such sums, and the q
//     side's second level of dco in double; the groups' partials (colors,
//     db, ddirs) in group order; ddirs' shares in double,
//     since the p side's and the q side's chain terms cancel ~25x (the
//     50k-Gaussian sphere); mb, |oc|^2 and |oc|^2 - mb^2 (isotropic) and
//     A, Bt, C (anisotropic) round as the plain version rounds them. No
//     atomics.
//   * Dead blocks (splits or row blocks past a tile's count) exit at once;
//     a group past the count fills planes but sums nothing.
// Shared memory per block at qb = 32: forward 52 KB (planes 32, pass A's
// acc 20), p side 104 KB (planes 48, slots 56), q side 112.4 KB (planes 64,
// slots 48 with dco's doubles, the rays' dcol 0.4: two blocks fill an SM's
// 228 KB).
//
// Peak scratch of the backward, B tiles, N = C ck rows, R rays in blocks of
// 32 (Rp = R rounded up to 32), nb(n) = n/64 rounded up, in brackets at the
// 50k-Gaussian sphere's dense bucket (B = 256, N = 5376, ck = 1792, R = 128)
// and at the one chunk of the anisotropic and the isotropic train steps
// (B = 512, N = ck = 736 and 480):
//   rows_p, rows_q  2 x B (Rp/32) N 10 floats (0.44 GB; 0.12, 0.08 GB)
//   dd_p, dd_q      2 x B nb(N) 3 Rp doubles   (0.13 GB; 0.04, 0.03 GB)
//   db_part, db     B (nb(ck) + 1) Rp          (~0 GB)
//   t_a (recompute) B 5 ck Rp                  (1.17 GB; 0.96, 0.63 GB)
// (the fused backwards' first form kept 32 bytes per (row, ray): 1.54 and
// 1.01 GB at the train steps)
//
// Layouts (float32 unless noted, contiguous): oc, albedo (B,N,3); sigma
// (B,N) or invd (B,N,3); mag (B,N); dirs, dcol (B,3,R) ray-minor; counts
// (B,) int32; the forward's partial (B, N/32, 3, R) scratch, colors (B,3,R)
// and, storing T, t (B,5,N,R), zero on rows at or past the count; the
// backward's t (B,5,N,R) (saved-T only), scratch as above
// (sgrt_chunked_bwd_scratch_floats), outputs doc, dalb (B,N,3), dsig (B,N)
// or dinvd (B,N,3), dmag (B,N), ddirs (B,3,R). Rows at or past the count
// get exactly zero gradient. Plane rows: mb, co, g, dmb, dco (B,N,R); sigma,
// inv, dsig, dinv (B,N); albedo, dalb (B,N,3); dcol (B,3,R); tw (B,N,R),
// zero on rows at or past the count; scratch of
// sgrt_split_bwd_scratch_floats (T of the one chunk, db and 5 per-row sums
// a (row, ray block); no ddirs shares).

#include <cuda_runtime.h>

#include "chunked_common.cuh"
#include "gauss_common.cuh"

namespace {

using namespace sgrt;

constexpr int kRays = 32;                 // rays per block: one warp per row group
constexpr int kFwdPB = 4;                 // forward: rows a thread keeps in registers
constexpr int kFwdRows = 32;              // p rows per forward block
constexpr int kFwdG = kFwdRows / kFwdPB;  // row groups per forward block (8)
constexpr int kBwdPB = 4;                 // backward: rows a thread keeps in registers
constexpr int kBwdG = kRows / kBwdPB;     // row groups per backward block (16)
constexpr int kAPlanes = 4;               // pass A: mb, inv, co, co erf(-mb inv)
constexpr int kPPlanes = 6;               // p side: mb, inv, -2/sqrt(pi) co, J xyz
constexpr int kQPlanes = 3 + kTaps;       // q side: mb, sb, g of the p rows, T_k
constexpr int kPSlots = 7 * kBwdPB;       // p side: dmb, dsb, J xyz, A, tw per row

// What the forward stores beside the split's colors: nothing, T (the
// forward-with-T: T_k in kTaps planes), or tw = sum_k T_k in one plane (the
// split forward sgrt_split_fwd, which computes no colors).
enum Store { kStoreNone = 0, kStoreT = 1, kStoreTw = 2 };

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// The warp's S per-row values summed over its 32 rays (a fixed butterfly);
// lane j < S writes sum j to out[j], or adds it.
template <int S>
__device__ __forceinline__ void warp_row_sums(const float (&v)[S], float* out, bool accumulate) {
  const int lane = threadIdx.x;
  float mine = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float s = warp_sum(v[j]);
    if (lane == j) mine = s;
  }
  if (lane < S) out[lane] = accumulate ? out[lane] + mine : mine;
}

// T's exponent base - acc_k (the head note) is the difference of the two
// sums, except under the spline exp, whose fit jumps by 3.5e-4 at 0 (its
// value 0.99965 there against exp(0+) = 1): the rows in front of every
// Gaussian of a ray have base - acc_k within rounding of 0, where two
// summation orders land on either side of the jump. Under it the exponent
// is summed term by term, sum_q co_q (erf(-mb_q inv_q) - erf(arg_qk)), as
// the plain version sums it: every term has the sign of its erf
// difference, so the sum has the exact sign (<= 0 in front of the camera).
template <int EXP>
constexpr bool kTermwise = EXP == kExpSpline;

// Pass A's planes of the staged rows [q0, q0 + nq) for the block's rays:
// mb, inv, co and the base term co erf(-mb inv) (termwise: erf(-mb inv)
// alone), [plane][row][ray]. Group g fills rows g, g + G, ... for its own
// ray.
template <class Geo, int ERF, int EXP>
__device__ __forceinline__ void fill_a(float* pl, int qb, const Geo& geo, int q0, int nq,
                                       float dx, float dy, float dz) {
  const int plane = qb * kRays;
  for (int j = threadIdx.y; j < nq; j += blockDim.y) {
    const RayTerms t = geo.template row<EXP>(q0 + j, dx, dy, dz);
    float* o = pl + j * kRays + threadIdx.x;
    const float eb = erf_fn<ERF>(-t.mb * t.inv);
    o[0] = t.mb;
    o[plane] = t.inv;
    o[2 * plane] = t.co;
    o[3 * plane] = kTermwise<EXP> ? eb : t.co * eb;
  }
}

// Pass A of this group's kFwdPB p rows (mb mbp, sb sgp) against the live q rows
// [0, cnt), staged qb rows a stage through double-buffered planes (pl: 2
// kAPlanes qb kRays floats):
//   acc[i][k] = sum_q co_q erf((mb_p + k sb_p - mb_q) inv_q),
//   base = sum_q co_q erf(-mb_q inv_q),
// each stage's terms summed on their own, then added to the running sums:
// base in a register, acc in the thread's slots acc2[(i kTaps + k) nt + tid]
// (nt the block's threads). base runs over the live rows, or for plane rows
// over all N (the split kernels' base, pallas_kernel.py:201): the rows past
// the count are staged after the live ones, for base alone. Every thread of
// the block calls it; a dead group (live false) fills planes and sums base
// only. Termwise (kTermwise), acc holds sum_q co_q (erf(-mb_q inv_q) -
// erf(...)) = base - acc over the live rows, and base only the plane rows'
// past the count: the exponent is base + acc then.
template <class Geo, int ERF, int EXP>
__device__ __forceinline__ void pass_a_planes(float* pl, float* acc2, int qb, const Geo& geo,
                                              int cnt, int N, float dx, float dy, float dz,
                                              const float (&mbp)[kFwdPB],
                                              const float (&sgp)[kFwdPB], bool live,
                                              float& base) {
  const int x = threadIdx.x, nt = kRays * blockDim.y, tid = threadIdx.y * kRays + x;
  const int plane = qb * kRays, buf = kAPlanes * plane;
#pragma unroll
  for (int e = 0; e < kFwdPB * kTaps; ++e) acc2[e * nt + tid] = 0.0f;
  base = 0.0f;
  const int ns = (cnt + qb - 1) / qb;
  if (ns > 0) fill_a<Geo, ERF, EXP>(pl, qb, geo, 0, min(qb, cnt), dx, dy, dz);
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    const int q0 = s * qb, nq = min(qb, cnt - q0);
    const float* cur = pl + (s & 1) * buf + x;
    if (s + 1 < ns)
      fill_a<Geo, ERF, EXP>(pl + ((s + 1) & 1) * buf, qb, geo, q0 + qb, min(qb, cnt - q0 - qb),
                            dx, dy, dz);
    float base_part = 0.0f;
    if (live) {
      float part[kFwdPB][kTaps];
#pragma unroll
      for (int i = 0; i < kFwdPB; ++i) {
#pragma unroll
        for (int k = 0; k < kTaps; ++k) part[i][k] = 0.0f;
      }
      for (int j = 0; j < nq; ++j) {
        const float* c = cur + j * kRays;
        const float mbq = c[0], invq = c[plane], co = c[2 * plane], cb = c[3 * plane];
        if constexpr (!kTermwise<EXP>) base_part += cb;
#pragma unroll
        for (int i = 0; i < kFwdPB; ++i) {
          const float darg = (mbp[i] - mbq) * invq;
          const float ks = sgp[i] * invq;
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            const float e = erf_fn<ERF>(darg + tap_k(k) * ks);
            part[i][k] += co * (kTermwise<EXP> ? cb - e : e);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kFwdPB; ++i) {
#pragma unroll
        for (int k = 0; k < kTaps; ++k) acc2[(i * kTaps + k) * nt + tid] += part[i][k];
      }
    } else if constexpr (!kTermwise<EXP>) {
      for (int j = 0; j < nq; ++j) base_part += cur[j * kRays + 3 * plane];
    }
    base += base_part;
    __syncthreads();
  }
  if constexpr (Geo::kPlanes) {
    // base's rows past the count, [cnt, N), qb a stage, two-level as above
    // (summed inside those stages, at 64 registers, they would spill)
    for (int q0 = cnt; q0 < N; q0 += qb) {
      const int nb = min(qb, N - q0);
      fill_a<Geo, ERF, EXP>(pl, qb, geo, q0, nb, dx, dy, dz);
      __syncthreads();
      float base_part = 0.0f;
      for (int j = 0; j < nb; ++j) {
        const float* c = pl + j * kRays + x;
        base_part += kTermwise<EXP> ? __fmul_rn(c[2 * plane], c[3 * plane]) : c[3 * plane];
      }
      base += base_part;
      __syncthreads();
    }
  }
}

// The ray and cotangent of lane r of tile b (lanes past R: a unit +z ray
// with a zero cotangent, whose every sum is zero). Plane rows have no
// directions: dirs is not read.
template <class Geo>
struct Ray {
  float dx = 0.0f, dy = 0.0f, dz = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  __device__ Ray(const float* dirs, const float* dcol, int b, int R, int r) {
    if (r >= R) return;
    const size_t o = static_cast<size_t>(b) * 3 * R;
    if constexpr (!Geo::kPlanes) {
      dx = dirs[o + r];
      dy = dirs[o + R + r];
      dz = dirs[o + 2 * R + r];
    }
    if (dcol != nullptr) {
      cr = dcol[o + r];
      cg = dcol[o + R + r];
      cb = dcol[o + 2 * R + r];
    }
  }
};

// Thread r's geometry of tile b: the scene's rows (oc, shape, mag), or the
// plane rows of `in`.
template <class Geo>
__device__ __forceinline__ Geo make_geo(const float* oc, const float* shape, const float* mag,
                                        const typename Geo::Args& in, int b, int N, int R,
                                        int r) {
  if constexpr (Geo::kPlanes) {
    return Geo(in, b, N, R, r);
  } else {
    return Geo(oc, shape, mag, b, N);
  }
}

// The cotangent g_p of tw for row p and the thread's ray, and A = albedo_p .
// dcol (the colors' direct terms' weight): g = sqrt(2/pi) co A, or, for
// plane rows given tw's cotangent, g from its plane and A = 0 (tw has no
// direct terms; its albedo and dcol are null).
template <class Geo>
__device__ __forceinline__ float row_weight(const Geo& geo, const float* alb_b, int p, float co,
                                            float cr, float cg, float cb, float& A) {
  if constexpr (Geo::kPlanes) {
    if (geo.g != nullptr) {
      A = 0.0f;
      return geo.g_at(p);
    }
  }
  A = alb_b[3 * p] * cr + alb_b[3 * p + 1] * cg + alb_b[3 * p + 2] * cb;
  return kSqrt2Pi * co * A;
}

// ---------------------------------------------------------------------------
// forward: one block per (32 rays, 32 p rows of a tile, tile)
// ---------------------------------------------------------------------------

// Blocks an SM of the forward of erf ERF and exp EXP: 4 (64 registers a
// thread) but for the piecewise cubics, whose segment lookups hold more
// registers live across the taps: with a spline erf or the spline exp 3
// (80 registers), with both 2 (128). At 64 registers they spilled 24-96
// bytes a thread (at 80 the anisotropic spline_mirror/spline forward 8).
constexpr int fwd_blocks(int erf, int exp) {
  const int splines = (erf == kErfSpline || erf == kErfSplineMirror) + (exp == kExpSpline);
  return 4 - splines;
}

// Blocks cover the p rows from p_row0 (gridDim.y blocks of 32). What STORE
// names goes to t + ((b P + k) t_rows + p - t_row0) t_ld + r, its P planes k
// (P = kTaps for T, 1 for tw), zero on rows at or past the count; the
// split's colors to partial, unless partial is null (the recompute
// backward's T of one chunk, and tw).
template <class Geo, int ERF, int EXP, int STORE>
__global__ void __launch_bounds__(kRays * kFwdG, fwd_blocks(ERF, EXP))
fwd_kernel(const float* __restrict__ oc, const float* __restrict__ shape,
           const float* __restrict__ mag, const float* __restrict__ alb,
           const float* __restrict__ dirs, const int* __restrict__ counts,
           float* __restrict__ partial, float* __restrict__ t, int N, int R, int qb,
           int n_split, int p_row0, int t_rows, int t_row0, int t_ld,
           const typename Geo::Args in) {
  extern __shared__ float smem[];
  const int x = threadIdx.x, g = threadIdx.y;
  const int nt = kRays * kFwdG, tid = g * kRays + x;
  const int b = blockIdx.z, split = blockIdx.y;
  const int r = blockIdx.x * kRays + x;
  const int cnt = max(0, min(counts[b], N));
  const int p_begin = p_row0 + split * kFwdRows;
  const int p0 = p_begin + g * kFwdPB;  // this group's rows p0 .. p0 + kFwdPB - 1
  const bool live_ray = r < R;
  constexpr int kOut = STORE == kStoreT ? kTaps : 1;  // planes stored

  // t_b[(k t_rows + i) t_ld] is plane k of row p0 + i (T_k, or tw); rows at
  // or past the count hold 0. The pointer is made where it is stored, so
  // that it is not live across pass A (at 64 registers a thread that costs
  // a spill).
  if (p_begin >= cnt) {  // block-uniform: this split has no live rows
    if (STORE != kStoreNone && live_ray) {
      float* t_b = t + (static_cast<size_t>(b) * kOut * t_rows + (p0 - t_row0)) * t_ld + r;
      for (int i = 0; i < min(kFwdPB, N - p0); ++i) {
#pragma unroll
        for (int k = 0; k < kOut; ++k) t_b[(static_cast<size_t>(k) * t_rows + i) * t_ld] = 0.0f;
      }
    }
    return;
  }
  const int p_end = min(p_begin + kFwdRows, cnt);
  const bool live = p0 < p_end;  // warp-uniform

  const Geo geo = make_geo<Geo>(oc, shape, mag, in, b, N, R, r);
  const Ray<Geo> ray(dirs, nullptr, b, R, r);
  float mbp[kFwdPB], sgp[kFwdPB];
#pragma unroll
  for (int i = 0; i < kFwdPB; ++i) {
    mbp[i] = 0.0f;
    sgp[i] = 1.0f;
    if (p0 + i < p_end) {
      const RayTerms tp = geo.template row<EXP>(p0 + i, ray.dx, ray.dy, ray.dz);
      mbp[i] = tp.mb;
      sgp[i] = tp.sb;
    }
  }
  float* pl = smem;
  float* acc2 = smem + 2 * kAPlanes * qb * kRays;
  float base;
  pass_a_planes<Geo, ERF, EXP>(pl, acc2, qb, geo, cnt, N, ray.dx, ray.dy, ray.dz, mbp, sgp,
                               live, base);

  float col[3] = {0.0f, 0.0f, 0.0f};
  const float* alb_b = alb + static_cast<size_t>(b) * N * 3;
  float* t_b = STORE != kStoreNone
                   ? t + (static_cast<size_t>(b) * kOut * t_rows + (p0 - t_row0)) * t_ld + r
                   : nullptr;
  // Storing, the rows go one at a time, and storing T the taps too:
  // unrolled, the 20 T stores' addresses spilled 8-48 bytes at 64 registers
  // (the isotropic instantiations, and the anisotropic ones with the fast
  // exp)
#pragma unroll(STORE == kStoreNone ? kFwdPB : 1)
  for (int i = 0; i < kFwdPB; ++i) {
    const int p = p0 + i;
    if (STORE != kStoreNone && live_ray && p >= p_end && p < N) {  // past the count
#pragma unroll
      for (int k = 0; k < kOut; ++k) t_b[(static_cast<size_t>(k) * t_rows + i) * t_ld] = 0.0f;
    }
    if (p < p_end) {  // warp-uniform
      float tw = 0.0f;
#pragma unroll(STORE == kStoreT ? 1 : kTaps)
      for (int k = 0; k < kTaps; ++k) {
        // rounded alike whatever is stored: the colors of the forward and
        // the forward-with-T are equal bit for bit, and tw is their sum
        const float a = acc2[(i * kTaps + k) * nt + tid];
        const float tk =
            __fmul_rn(tap_weight(k), exp_fn<EXP>(kTermwise<EXP> ? base + a : base - a));
        if (STORE == kStoreT && live_ray) t_b[(static_cast<size_t>(k) * t_rows + i) * t_ld] = tk;
        tw = __fadd_rn(tw, tk);
      }
      if (STORE == kStoreTw && live_ray) t_b[static_cast<size_t>(i) * t_ld] = tw;
      if (partial != nullptr) {
        const float wp = kSqrt2Pi * geo.template row<EXP>(p, ray.dx, ray.dy, ray.dz).co * tw;
#pragma unroll
        for (int c = 0; c < 3; ++c) col[c] += alb_b[3 * p + c] * wp;
      }
    }
  }
  if (partial == nullptr) return;  // kernel-uniform

  // the split's colors: the groups' partials in group order (the planes are
  // free after pass A's last barrier)
  float* red = pl;
#pragma unroll
  for (int c = 0; c < 3; ++c) red[(c * kFwdG + g) * kRays + x] = col[c];
  __syncthreads();
  if (g == 0 && live_ray) {
    float* out = partial + (static_cast<size_t>(b) * n_split + split) * 3 * R;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = 0.0f;
      for (int h = 0; h < kFwdG; ++h) s += red[(c * kFwdG + h) * kRays + x];
      out[c * R + r] = s;
    }
  }
}

size_t fwd_smem(int qb) { return sizeof(float) * (2 * kAPlanes * qb + kFwdRows * kTaps) * kRays; }

// ---------------------------------------------------------------------------
// backward, p side: one block per (32 rays, 64 rows of p-chunk a, tile)
// ---------------------------------------------------------------------------

// The p side's planes of the staged q rows [q0, q0 + nq): mb, inv,
// -2/sqrt(pi) co and J = d mb / d d (plane rows: no J).
template <class Geo, int EXP>
__device__ __forceinline__ void fill_p(float* pl, int qb, const Geo& geo, int q0, int nq,
                                       float dx, float dy, float dz) {
  const int plane = qb * kRays;
  for (int j = threadIdx.y; j < nq; j += blockDim.y) {
    float* o = pl + j * kRays + threadIdx.x;
    if constexpr (Geo::kPlanes) {
      const RayTerms t = geo.template row<EXP>(q0 + j, dx, dy, dz);
      o[0] = t.mb;
      o[plane] = t.inv;
      o[2 * plane] = -kDerf * t.co;
    } else {
      const typename Geo::Fields f = geo.fields(q0 + j);
      const RayTerms t = Geo::template terms<EXP>(f, dx, dy, dz);
      const Jac jq = Side<Geo>::jac(f, t, dx, dy, dz);
      o[0] = t.mb;
      o[plane] = t.inv;
      o[2 * plane] = -kDerf * t.co;
      o[3 * plane] = jq.x;
      o[4 * plane] = jq.y;
      o[5 * plane] = jq.z;
    }
  }
}

// T comes from tsrc (t_rows rows from t_row0, leading dimension t_ld): the
// forward-with-T's (B,5,N,R), or the recompute backward's T of chunk a. The
// p side takes no erf (only exp(-x^2) of each tap), so it is built per exp
// alone.
template <class Geo, int EXP>
__global__ void __launch_bounds__(kRays * kBwdG, 1)
bwd_p_kernel(const float* __restrict__ oc, const float* __restrict__ shape,
             const float* __restrict__ mag, const float* __restrict__ alb,
             const float* __restrict__ dirs, const int* __restrict__ counts,
             const float* __restrict__ dcol, const float* __restrict__ tsrc, int t_rows,
             int t_row0, int t_ld, float* __restrict__ rows_p, double* __restrict__ dd_p,
             float* __restrict__ db_part, int N, int R, int Rp, int ck, int a, int qb,
             const typename Geo::Args in) {
  using S = Side<Geo>;
  extern __shared__ float smem[];
  const int x = threadIdx.x, g = threadIdx.y;
  const int nt = kRays * kBwdG, tid = g * kRays + x;
  const int b = blockIdx.z, blk = blockIdx.y, rblk = blockIdx.x;
  const int r = rblk * kRays + x;  // < Rp always
  const int cnt = max(0, min(counts[b], N));
  const int p_begin = a * ck + blk * kRows;
  if (p_begin >= cnt) return;  // block-uniform; the sums after skip dead blocks
  const int p_end = min(p_begin + kRows, cnt);
  const int p0 = p_begin + g * kBwdPB;
  const bool live = p0 < p_end;  // warp-uniform
  const Ray<Geo> ray(dirs, dcol, b, R, r);
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const Geo geo = make_geo<Geo>(oc, shape, mag, in, b, N, R, r);
  const float* alb_b = alb + static_cast<size_t>(b) * N * 3;
  const int n_rb = gridDim.x;
  const int plane = qb * kRays, buf = kPPlanes * plane;
  float* pl = smem;
  float* slot = smem + 2 * buf;  // the thread's slots: slot[e * nt + tid]
  auto at = [&](int e) -> float& { return slot[e * nt + tid]; };

  // G_k = g T_k, db, and the direct terms' inputs tw and A (to the slots,
  // with J of each row: the pass reads them per pair)
  float mbp[kBwdPB], sgp[kBwdPB], G[kBwdPB][kTaps];
  float db = 0.0f;
  const float* t_b = tsrc + static_cast<size_t>(b) * kTaps * t_rows * t_ld + r;
#pragma unroll
  for (int i = 0; i < kBwdPB; ++i) {
    const int p = p0 + i;
    float A = 0.0f, tw = 0.0f;
    mbp[i] = 0.0f;
    sgp[i] = 1.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) G[i][k] = 0.0f;  // a dead row's or lane's G stays 0
    if (p < p_end) {
      const RayTerms tp = geo.template row<EXP>(p, dx, dy, dz);
      mbp[i] = tp.mb;
      sgp[i] = tp.sb;
      if (r < R) {
#pragma unroll
        for (int k = 0; k < kTaps; ++k)
          G[i][k] = t_b[(static_cast<size_t>(k) * t_rows + (p - t_row0)) * t_ld];
      }
      const float gp = row_weight(geo, alb_b, p, tp.co, ray.cr, ray.cg, ray.cb, A);
#pragma unroll
      for (int k = 0; k < kTaps; ++k) tw += G[i][k];
      db += gp * tw;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) G[i][k] *= gp;
    }
    if constexpr (!Geo::kPlanes) {
      const Jac jp = S::template jac_row<EXP>(geo, min(p, p_end - 1), dx, dy, dz);
      at(2 * kBwdPB + 3 * i) = jp.x;
      at(2 * kBwdPB + 3 * i + 1) = jp.y;
      at(2 * kBwdPB + 3 * i + 2) = jp.z;
    }
    at(5 * kBwdPB + i) = A;
    at(6 * kBwdPB + i) = tw;
    at(i) = at(kBwdPB + i) = 0.0f;  // dmb_p, dsb_p
  }

  // the pair pass, p side: only exp(-x^2) of each tap is needed here; a
  // pair's share of ddirs is (J_p - J_q) S0 inv_q, summed as that
  // difference (the head note; plane rows have no ddirs)
  double gx = 0.0, gy = 0.0, gz = 0.0;
  const int ns = (cnt + qb - 1) / qb;
  fill_p<Geo, EXP>(pl, qb, geo, 0, min(qb, cnt), dx, dy, dz);
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    const int q0 = s * qb, nq = min(qb, cnt - q0);
    const float* cur = pl + (s & 1) * buf + x;
    if (s + 1 < ns)
      fill_p<Geo, EXP>(pl + ((s + 1) & 1) * buf, qb, geo, q0 + qb, min(qb, cnt - q0 - qb), dx, dy,
                       dz);
    if (live) {
      float sx = 0.0f, sy = 0.0f, sz = 0.0f, pdmb[kBwdPB], pdsb[kBwdPB];
#pragma unroll
      for (int i = 0; i < kBwdPB; ++i) pdmb[i] = pdsb[i] = 0.0f;
      for (int j = 0; j < nq; ++j) {
        const float* c = cur + j * kRays;
        const float mbq = c[0], invq = c[plane], nco = c[2 * plane];
        // J of the q row (dead code for plane rows)
        [[maybe_unused]] const float jqx = c[3 * plane], jqy = c[4 * plane], jqz = c[5 * plane];
#pragma unroll
        for (int i = 0; i < kBwdPB; ++i) {
          const float dd = mbp[i] - mbq;
          float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            const float xk = (dd + tap_k(k) * sgp[i]) * invq;
            const float gg = G[i][k] * gauss(xk);  // as5 tap's gauss, for every erf
            t0 += gg;
            t1 += tap_k(k) * gg;
          }
          const float s0 = nco * t0, s1 = nco * t1;
          const float di = s0 * invq;  // zero for a dead row (its G is 0)
          pdmb[i] += di;
          pdsb[i] += s1 * invq;
          if constexpr (!Geo::kPlanes) {
            sx += (at(2 * kBwdPB + 3 * i) - jqx) * di;
            sy += (at(2 * kBwdPB + 3 * i + 1) - jqy) * di;
            sz += (at(2 * kBwdPB + 3 * i + 2) - jqz) * di;
          }
        }
      }
      gx += sx;
      gy += sy;
      gz += sz;
#pragma unroll
      for (int i = 0; i < kBwdPB; ++i) {
        at(i) += pdmb[i];
        at(kBwdPB + i) += pdsb[i];
      }
    }
    __syncthreads();
  }

  // the prep chain of each row, reduced over the warp's rays
#pragma unroll
  for (int i = 0; i < kBwdPB; ++i) {
    const int p = p0 + i;
    if (p < p_end) {  // warp-uniform
      float v[S::kN];
      S::template p_chain<EXP>(geo, p, dx, dy, dz, ray.cr, ray.cg, ray.cb, mbp[i],
                               at(6 * kBwdPB + i), at(5 * kBwdPB + i), at(i), at(kBwdPB + i), v,
                               gx, gy, gz);
      warp_row_sums(v, rows_p + ((static_cast<size_t>(b) * n_rb + rblk) * N + p) * S::kN, false);
    }
  }

  // the block's db and ddirs share: the groups' partials in group order,
  // through the slots once every group is past its chain
  __syncthreads();
  double* dds = reinterpret_cast<double*>(slot);
  float* dbs = slot + 6 * nt;
  dbs[tid] = db;
  if constexpr (!Geo::kPlanes) {
    dds[tid] = gx;
    dds[nt + tid] = gy;
    dds[2 * nt + tid] = gz;
  }
  __syncthreads();
  if (g == 0) {
    float sdb = 0.0f;
    double s3[3] = {0.0, 0.0, 0.0};
    for (int h = 0; h < kBwdG; ++h) {
      sdb += dbs[h * kRays + x];
      if constexpr (!Geo::kPlanes) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s3[c] += dds[c * nt + h * kRays + x];
      }
    }
    db_part[(static_cast<size_t>(b) * row_blocks(ck) + blk) * Rp + r] = sdb;
    if constexpr (!Geo::kPlanes) {
      double* dd =
          dd_p + (static_cast<size_t>(b) * row_blocks(N) + p_begin / kRows) * 3 * Rp + r;
#pragma unroll
      for (int c = 0; c < 3; ++c) dd[c * static_cast<size_t>(Rp)] = s3[c];
    }
  }
}

size_t bwd_p_smem(int qb) {
  return sizeof(float) * (2 * kPPlanes * qb * kRays + kPSlots * kRays * kBwdG);
}

// ---------------------------------------------------------------------------
// backward, q side: one block per (32 rays, 64 q rows, tile), against the
// p rows of chunk a
// ---------------------------------------------------------------------------

// The q side's planes of the staged p rows [pp, pp + np): mb, sb and the
// cotangent g (row_weight), and the rows' T_k copied from tsrc
// (t_rows rows from t_row0, leading dimension t_ld) with cp.async; lanes
// past R copy nothing (the pass reads zero for them). cot holds the block's
// rays' dcol, [channel][ray].
template <class Geo, int EXP>
__device__ __forceinline__ void fill_q(float* pl, int qb, const Geo& geo, const float* alb_b,
                                       const float* t_b, int t_rows, int t_row0, int t_ld,
                                       int pp, int np, const Ray<Geo>& ray, const float* cot,
                                       int r, bool live_ray) {
  const int plane = qb * kRays;
  for (int j = threadIdx.y; j < np; j += blockDim.y) {
    const int p = pp + j;
    float* o = pl + j * kRays + threadIdx.x;
    if (live_ray) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        cp_async4(o + (3 + k) * plane,
                  t_b + (static_cast<size_t>(k) * t_rows + (p - t_row0)) * t_ld + r);
    }
    const RayTerms t = geo.template row<EXP>(p, ray.dx, ray.dy, ray.dz);
    o[0] = t.mb;
    o[plane] = t.sb;
    const float* c = cot + threadIdx.x;
    float A;
    o[2 * plane] = row_weight(geo, alb_b, p, t.co, c[0], c[kRays], c[2 * kRays], A);
  }
  cp_async_commit();
}

template <class Geo, int ERF, int EXP>
__global__ void __launch_bounds__(kRays * kBwdG, 2)
bwd_q_kernel(const float* __restrict__ oc, const float* __restrict__ shape,
             const float* __restrict__ mag, const float* __restrict__ alb,
             const float* __restrict__ dirs, const int* __restrict__ counts,
             const float* __restrict__ dcol, const float* __restrict__ tsrc, int t_rows,
             int t_row0, int t_ld, const float* __restrict__ db, float* __restrict__ rows_q,
             double* __restrict__ dd_q, int N, int R, int Rp, int ck, int a, int qb,
             const typename Geo::Args in) {
  using S = Side<Geo>;
  extern __shared__ float smem[];
  const int x = threadIdx.x, g = threadIdx.y;
  const int nt = kRays * kBwdG, tid = g * kRays + x;
  const int b = blockIdx.z, blk = blockIdx.y, rblk = blockIdx.x;
  const int r = rblk * kRays + x;
  const int cnt = max(0, min(counts[b], N));
  const int q_begin = blk * kRows;
  const int p_lo = a * ck, p_hi = min(p_lo + ck, cnt);
  const bool pairs = q_begin < cnt && p_lo < p_hi;  // block-uniform
  // a block without pairs exits, but over plane rows it keeps the base path
  // of its rows (every row, past the count too)
  if (!pairs && !Geo::kPlanes) return;
  const int q_end = min(q_begin + kRows, cnt);
  const int q_last = Geo::kPlanes ? min(q_begin + kRows, N) : q_end;  // rows chained
  const int q0 = q_begin + g * kBwdPB;
  const bool live = q0 < q_end;  // warp-uniform
  const bool live_ray = r < R;
  const Ray<Geo> ray(dirs, nullptr, b, R, r);
  const Geo geo = make_geo<Geo>(oc, shape, mag, in, b, N, R, r);
  const float* alb_b = alb + static_cast<size_t>(b) * N * 3;
  const float* t_b = tsrc + static_cast<size_t>(b) * kTaps * t_rows * t_ld;
  const int n_rb = gridDim.x;
  const bool accumulate = a > 0;
  const int plane = qb * kRays, buf = kQPlanes * plane;
  float* pl = smem;
  // the thread's slots: per row dmb and dinv (without the row's co, see
  // below), mb, inv, then dco in double
  float* slot = smem + 2 * buf;
  auto at = [&](int e) -> float& { return slot[e * nt + tid]; };
  double* dco = reinterpret_cast<double*>(slot + 4 * kBwdPB * nt);  // dco[i * nt + tid]
  // the rays' dcol, read by each stage's fill (in registers it would cost
  // the second block an SM, as the rows' terms below)
  float* cot = slot + 6 * kBwdPB * nt;
  if (g == 0) {
    const Ray<Geo> c(dirs, dcol, b, R, r);
    cot[x] = c.cr;
    cot[kRays + x] = c.cg;
    cot[2 * kRays + x] = c.cb;
  }

  // the rows' mb and inv, read per pair, in the slots too: in registers
  // they would cost the second block an SM (64 registers a thread)
  // (plane rows: also those past the count, for the base path)
  auto mbq = [&](int i) -> float& { return at(2 * kBwdPB + i); };
  auto invq = [&](int i) -> float& { return at(3 * kBwdPB + i); };
#pragma unroll
  for (int i = 0; i < kBwdPB; ++i) {
    mbq(i) = 0.0f;  // a dead row's sums are made but never chained
    invq(i) = kInvSqrt2;
    if (q0 + i < q_last) {
      const RayTerms t = geo.template row<EXP>(q0 + i, ray.dx, ray.dy, ray.dz);
      mbq(i) = t.mb;
      invq(i) = t.inv;
    }
    at(i) = at(kBwdPB + i) = 0.0f;
    dco[i * nt + tid] = 0.0;
  }

  const int ns = pairs ? (p_hi - p_lo + qb - 1) / qb : 0;
  __syncthreads();  // cot
  if (!Geo::kPlanes || ns > 0)
    fill_q<Geo, EXP>(pl, qb, geo, alb_b, t_b, t_rows, t_row0, t_ld, p_lo, min(qb, p_hi - p_lo),
                     ray, cot, r, live_ray);
  cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    const int pp = p_lo + s * qb, np = min(qb, p_hi - pp);
    const float* cur = pl + (s & 1) * buf + x;
    if (s + 1 < ns)
      fill_q<Geo, EXP>(pl + ((s + 1) & 1) * buf, qb, geo, alb_b, t_b, t_rows, t_row0, t_ld,
                       pp + qb, min(qb, p_hi - pp - qb), ray, cot, r, live_ray);
    if (live) {
      // this stage's sums, added to the running ones after it. dco_q is the
      // difference of the base path's term and its running sum, so that sum
      // is kept in double (in float it made ddirs up to 2.2x as far from a
      // float64 run as the plain version, at the dense cell). dmb and dinv
      // leave out the row's own factor -2/sqrt(pi) co_q: the chain applies
      // it once (no slot for co, fewer products per pair)
      float pdco[kBwdPB], pdmb[kBwdPB], pdinv[kBwdPB];
#pragma unroll
      for (int i = 0; i < kBwdPB; ++i) pdco[i] = pdmb[i] = pdinv[i] = 0.0f;
      for (int j = 0; j < np; ++j) {
        const float* c = cur + j * kRays;
        const float mbp = c[0], sgp = c[plane], gp = c[2 * plane];
        float Gk[kTaps];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) Gk[k] = live_ray ? gp * c[(3 + k) * plane] : 0.0f;
#pragma unroll
        for (int i = 0; i < kBwdPB; ++i) {
          const float dd = mbp - mbq(i), iq = invq(i);
          float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            float ee, gau;
            erf_and_gauss<ERF>((dd + tap_k(k) * sgp) * iq, ee, gau);
            pdco[i] -= Gk[k] * ee;
            const float gg = Gk[k] * gau;
            t0 += gg;
            t1 += tap_k(k) * gg;
          }
          pdmb[i] -= t0 * iq;
          pdinv[i] += t0 * dd + t1 * sgp;
        }
      }
#pragma unroll
      for (int i = 0; i < kBwdPB; ++i) {
        dco[i * nt + tid] += pdco[i];
        at(i) += pdmb[i];
        at(kBwdPB + i) += pdinv[i];
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // the base path with chunk a's db, then the prep chain, reduced over the
  // warp's rays
  const float dbr = db[static_cast<size_t>(b) * Rp + r];  // zero on dead lanes
  double gx = 0.0, gy = 0.0, gz = 0.0;
#pragma unroll
  for (int i = 0; i < kBwdPB; ++i) {
    const int q = q0 + i;
    if (q < q_last) {  // warp-uniform
      float v[S::kN];
      if constexpr (Geo::kPlanes) {
        S::template q_chain<ERF>(geo, q, q < q_end, mbq(i), invq(i), dbr,
                                 static_cast<float>(dco[i * nt + tid]), at(i), at(kBwdPB + i),
                                 v);
      } else {
        const float co = geo.template row<EXP>(q, ray.dx, ray.dy, ray.dz).co;
        const float nco = -kDerf * co;
        S::template q_chain<ERF, EXP>(geo, q, ray.dx, ray.dy, ray.dz, mbq(i), co, invq(i), dbr,
                                      static_cast<float>(dco[i * nt + tid]), nco * at(i),
                                      nco * at(kBwdPB + i), v, gx, gy, gz);
      }
      warp_row_sums(v, rows_q + ((static_cast<size_t>(b) * n_rb + rblk) * N + q) * S::kN,
                    accumulate);
    }
  }

  // the block's ddirs share: the groups' partials in group order, through
  // the slots once every group is past its chain (plane rows: no ddirs)
  if constexpr (!Geo::kPlanes) {
    __syncthreads();
    double* dds = reinterpret_cast<double*>(slot);
    dds[tid] = gx;
    dds[nt + tid] = gy;
    dds[2 * nt + tid] = gz;
    __syncthreads();
    if (g == 0) {
      double* dd = dd_q + (static_cast<size_t>(b) * row_blocks(N) + blk) * 3 * Rp + r;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        double s = 0.0;
        for (int h = 0; h < kBwdG; ++h) s += dds[c * nt + h * kRays + x];
        dd[c * static_cast<size_t>(Rp)] = accumulate ? dd[c * static_cast<size_t>(Rp)] + s : s;
      }
    }
  }
}

size_t bwd_q_smem(int qb) {
  return sizeof(float) * (2 * kQPlanes * qb * kRays + 6 * kBwdPB * kRays * kBwdG + 3 * kRays);
}

// ---------------------------------------------------------------------------
// the as5 tap alone, for its accuracy check (sgrt_as5_tap_probe; no path of
// the renderer launches it)
// ---------------------------------------------------------------------------

// as5's tap in its IEEE form (an IEEE division, the accurate expf, sign(x)
// by compares), the yardstick of erf_and_gauss<kErfAs5>'s accuracy.
__device__ __forceinline__ void as5_tap_ieee(float x, float& e, float& g) {
  const float t = 1.0f / (1.0f + 0.3275911f * fabsf(x));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  g = expf(-x * x);
  e = sign_of(x) * (1.0f - poly * g);
}

// out (4, n): the tap's e and g at x, then the IEEE form's.
__global__ void as5_tap_probe(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  erf_and_gauss<kErfAs5>(x[i], out[i], out[n + i]);
  as5_tap_ieee(x[i], out[2 * n + i], out[3 * n + i]);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Device times of the kernels of one multi-kernel launch, for measurement:
// mark() after each kernel; finish() waits for the last and writes the ms
// between consecutive marks to out. Records nothing when out is null.
class PartTimer {
 public:
  PartTimer(float* out, cudaStream_t s) : out_(out), s_(s) { mark(); }
  ~PartTimer() {
    for (int i = 0; i < n_; ++i) cudaEventDestroy(ev_[i]);
  }
  void mark() {
    if (out_ == nullptr || n_ == kMax) return;
    cudaEventCreate(&ev_[n_]);
    cudaEventRecord(ev_[n_], s_);
    ++n_;
  }
  cudaError_t finish() {
    if (out_ == nullptr) return cudaSuccess;
    cudaError_t e = cudaEventSynchronize(ev_[n_ - 1]);
    for (int i = 1; i < n_ && e == cudaSuccess; ++i)
      e = cudaEventElapsedTime(&out_[i - 1], ev_[i - 1], ev_[i]);
    return e;
  }

 private:
  static constexpr int kMax = 4 * 512 + 2;  // 4 marks per chunk, at most 512 chunks
  cudaEvent_t ev_[kMax];
  int n_ = 0;
  float* out_;
  cudaStream_t s_;
};

template <class Geo>
using FwdKernel = void (*)(const float*, const float*, const float*, const float*,
                           const float*, const int*, float*, float*, int, int, int, int, int,
                           int, int, int, typename Geo::Args);
template <class Geo>
using PKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const int*, const float*, const float*, int, int, int, float*, double*,
                         float*, int, int, int, int, int, int, typename Geo::Args);
template <class Geo>
using QKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                         const int*, const float*, const float*, int, int, int, const float*,
                         float*, double*, int, int, int, int, int, int, typename Geo::Args);

// The kernels of erf erf_id and exp exp_id (null for an id out of range):
// the forward of every erf and exp, the p side of every exp, and the q side
// of the erf's pair (pair_erf: its own, or as5's) and every exp, whose
// erf_and_gauss is the only erf it evaluates.
template <class Geo, int STORE, int ERF = 0, int EXP = 0>
FwdKernel<Geo> pick_fwd(int erf_id, int exp_id) {
  if (erf_id == ERF && exp_id == EXP) return fwd_kernel<Geo, ERF, EXP, STORE>;
  if constexpr (EXP + 1 < kExps) {
    return pick_fwd<Geo, STORE, ERF, EXP + 1>(erf_id, exp_id);
  } else if constexpr (ERF + 1 < kErfs) {
    return pick_fwd<Geo, STORE, ERF + 1, 0>(erf_id, exp_id);
  } else {
    return nullptr;
  }
}

template <class Geo, int EXP = 0>
PKernel<Geo> pick_p(int exp_id) {
  if (exp_id == EXP) return bwd_p_kernel<Geo, EXP>;
  if constexpr (EXP + 1 < kExps) {
    return pick_p<Geo, EXP + 1>(exp_id);
  } else {
    return nullptr;
  }
}

template <class Geo, int EXP = 0>
QKernel<Geo> pick_q(int erf_id, int exp_id) {
  if (erf_id < 0 || erf_id >= kErfs) return nullptr;
  if (exp_id == EXP) {
    if (pair_erf(erf_id) == kErfAs3) return bwd_q_kernel<Geo, kErfAs3, EXP>;
    return bwd_q_kernel<Geo, kErfAs5, EXP>;
  }
  if constexpr (EXP + 1 < kExps) {
    return pick_q<Geo, EXP + 1>(erf_id, exp_id);
  } else {
    return nullptr;
  }
}

// A block's shared memory on sm_90 (227 KB); qb >= 8 leaves the forward's
// planes room for the groups' colors after the last stage.
constexpr size_t kMaxSmem = 232448;

bool bad_qb(int qb) {
  return qb < 8 || qb > 1024 || fwd_smem(qb) > kMaxSmem || bwd_p_smem(qb) > kMaxSmem ||
         bwd_q_smem(qb) > kMaxSmem;
}

// shape is sigma (B,N) for IsoGeo, invd (B,N,3) for AnisoGeo; dshape the
// matching gradient. Plane rows (in: their inputs; oc, shape, mag and dirs
// null) keep their plane offsets in 32 bits, so B N R must stay below 2^31.
// Storing tw there is no colors: partial and colors are null.
template <class Geo, int STORE>
int launch_fwd(const float* oc, const float* shape, const float* mag, const float* alb,
               const float* dirs, const int* counts, float* partial, float* colors, float* t,
               int B, int N, int R, int threads, int pb, int qb, int erf_id, int exp_id,
               void* stream, const typename Geo::Args& in = {}) {
  FwdKernel<Geo> fn = pick_fwd<Geo, STORE>(erf_id, exp_id);
  const int n_split = (N + kFwdRows - 1) / kFwdRows;
  if (fn == nullptr || B < 1 || B > 65535 || N < 1 || R < 1 || threads != kRays ||
      (pb != 8 && pb != 16) || bad_qb(qb) || n_split > 65535 ||
      (Geo::kPlanes && static_cast<size_t>(B) * N * R > 0x7fffffff) ||
      (STORE != kStoreNone && t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fn, fwd_smem(qb));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kRays - 1) / kRays, n_split, B);
  fn<<<grid, dim3(kRays, kFwdG), fwd_smem(qb), s>>>(oc, shape, mag, alb, dirs, counts, partial,
                                                    t, N, R, qb, n_split, 0, N, 0, R, in);
  if ((err = cudaGetLastError()) != cudaSuccess || STORE == kStoreTw)
    return static_cast<int>(err);
  // colors = the live splits' partials summed in split order
  return static_cast<int>(
      launch_block_sums(partial, counts, colors, B, N, 3 * R, n_split, kFwdRows, 0, s));
}

// The backward's host loop on `stream`: per p-chunk a in order, (recompute:
// the forward-with-T over chunk a's rows, T into scratch), the p side,
// chunk a's db (the live 64-row blocks summed in block order) and the q
// side, so that the q side's sums carried across chunks are read-modify-
// writes in stream order; then the per-row gradients and ddirs. ck is a
// multiple of 64 dividing N, or N itself (one chunk, whose last 64-row block
// may be partial). part_ms (host, 4 C + 1 floats, or null): each chunk's
// pass A (0 with saved T), p side, db sum and q side, then the row and
// ddirs kernels, in device ms (the call then waits for them). Plane rows
// (in: their inputs and outputs; oc, shape, mag, dirs and the outputs doc,
// dshape, dmag, ddirs null) take one chunk only, ck = N, whose q side
// writes their dmb and dco planes once, and have no ddirs kernel.
template <class Geo, bool SAVED_T>
int launch_bwd(const float* oc, const float* shape, const float* mag, const float* alb,
               const float* dirs, const int* counts, const float* dcol, const float* t,
               float* scratch, float* doc, float* dshape, float* dmag, float* dalb, float* ddirs,
               float* part_ms, int B, int N, int R, int ck, int threads, int qb, int erf_id,
               int exp_id, void* stream, const typename Geo::Args& in = {}) {
  FwdKernel<Geo> tfn = pick_fwd<Geo, kStoreT>(erf_id, exp_id);
  PKernel<Geo> pfn = pick_p<Geo>(exp_id);
  QKernel<Geo> qfn = pick_q<Geo>(erf_id, exp_id);
  if (tfn == nullptr || pfn == nullptr || qfn == nullptr || B < 1 || B > 65535 || N < 1 ||
      R < 1 || ck < 1 || N % ck != 0 || (ck != N && ck % kRows != 0) ||
      (Geo::kPlanes && (ck != N || static_cast<size_t>(B) * N * R > 0x7fffffff)) ||
      row_blocks(N) > 65535 || threads != kRays || bad_qb(qb) ||
      (SAVED_T && t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = allow_smem(tfn, fwd_smem(qb))) != cudaSuccess ||
      (err = allow_smem(pfn, bwd_p_smem(qb))) != cudaSuccess ||
      (err = allow_smem(qfn, bwd_q_smem(qb))) != cudaSuccess)
    return static_cast<int>(err);
  Scratch s;
  scratch_layout(B, N, R, ck, threads, !SAVED_T, Side<Geo>::kN, !Geo::kPlanes, scratch, &s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rb = (R + kRays - 1) / kRays;
  const int Rp = n_rb * kRays;
  const dim3 block(kRays, kBwdG);
  // T of the rows of chunk a: the saved T, or chunk a's scratch
  const float* tsrc = SAVED_T ? t : s.t_a;
  const int t_rows = SAVED_T ? N : ck, t_ld = SAVED_T ? R : Rp;
  const dim3 t_grid(n_rb, (ck + kFwdRows - 1) / kFwdRows, B);
  PartTimer timer(part_ms, st);
  for (int a = 0; a < N / ck; ++a) {
    const int t_row0 = SAVED_T ? 0 : a * ck;
    if (!SAVED_T) {
      tfn<<<t_grid, dim3(kRays, kFwdG), fwd_smem(qb), st>>>(
          oc, shape, mag, alb, dirs, counts, nullptr, s.t_a, N, R, qb, 0, a * ck, ck, a * ck, Rp,
          in);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    timer.mark();
    pfn<<<dim3(n_rb, row_blocks(ck), B), block, bwd_p_smem(qb), st>>>(
        oc, shape, mag, alb, dirs, counts, dcol, tsrc, t_rows, t_row0, t_ld, s.rows_p, s.dd_p,
        s.db_part, N, R, Rp, ck, a, qb, in);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    timer.mark();
    if ((err = launch_block_sums(s.db_part, counts, s.db, B, N, Rp, row_blocks(ck), kRows,
                                 a * ck, st)) != cudaSuccess)
      return static_cast<int>(err);
    timer.mark();
    qfn<<<dim3(n_rb, row_blocks(N), B), block, bwd_q_smem(qb), st>>>(
        oc, shape, mag, alb, dirs, counts, dcol, tsrc, t_rows, t_row0, t_ld, s.db, s.rows_q,
        s.dd_q, N, R, Rp, ck, a, qb, in);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    timer.mark();
  }
  const unsigned row_grid = blocks_for(static_cast<size_t>(B) * N, 256);
  if constexpr (Geo::kPlanes) {
    plane_rows_kernel<<<row_grid, 256, 0, st>>>(counts, s.rows_p, s.rows_q, in.dsig, in.dinv,
                                                dalb, B, N, n_rb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  } else {
    bwd_rows_kernel<Geo><<<row_grid, 256, 0, st>>>(oc, shape, mag, counts, s.rows_p, s.rows_q,
                                                   doc, dshape, dmag, dalb, B, N, n_rb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    bwd_ddirs_kernel<<<blocks_for(static_cast<size_t>(B) * 3 * R, 256), 256, 0, st>>>(
        counts, s.dd_p, s.dd_q, ddirs, B, N, R, Rp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  timer.mark();
  return static_cast<int>(timer.finish());
}

}  // namespace

extern "C" {

int sgrt_chunked_fwd_rows_per_block() { return kFwdRows; }

int sgrt_chunked_max_threads() { return kRays; }

const char* sgrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The chunked forward and the split reduction on `stream`: colors (B,3,R)
// from oc (B,N,3), sigma (B,N), mag (B,N), albedo (B,N,3), dirs (B,3,R),
// counts (B,); partial (B, N/32, 3, R) scratch. threads = 32 rays a block;
// pb (8 or 16, the route's p block) does not change the kernel, which
// keeps 4 rows a thread. Returns a cudaError_t (cudaErrorInvalidValue for a
// configuration the kernel does not take).
int sgrt_chunked_fwd(const float* oc, const float* sig, const float* mag, const float* alb,
                     const float* dirs, const int* counts, float* partial, float* colors, int B,
                     int N, int R, int threads, int pb, int qb, int erf_id, int exp_id,
                     void* stream) {
  return launch_fwd<IsoGeo, kStoreNone>(oc, sig, mag, alb, dirs, counts, partial, colors, nullptr,
                                        B, N, R, threads, pb, qb, erf_id, exp_id, stream);
}

// The same forward, also writing T (B,5,N,R), zero on rows at or past the
// count: the saved-T backward's input.
int sgrt_chunked_fwd_t(const float* oc, const float* sig, const float* mag, const float* alb,
                       const float* dirs, const int* counts, float* partial, float* colors,
                       float* t, int B, int N, int R, int threads, int pb, int qb, int erf_id,
                       int exp_id, void* stream) {
  return launch_fwd<IsoGeo, kStoreT>(oc, sig, mag, alb, dirs, counts, partial, colors, t, B, N, R,
                                     threads, pb, qb, erf_id, exp_id, stream);
}

// The recompute chunked backward: outputs doc, dalb (B,N,3), dsig, dmag
// (B,N), ddirs (B,3,R); scratch of sgrt_chunked_bwd_scratch_floats(B, N, R,
// ck, 32, 1) floats; part_ms as launch_bwd's.
int sgrt_chunked_bwd(const float* oc, const float* sig, const float* mag, const float* alb,
                     const float* dirs, const int* counts, const float* dcol, float* scratch,
                     float* doc, float* dsig, float* dmag, float* dalb, float* ddirs,
                     float* part_ms, int B, int N, int R, int ck, int threads, int qb,
                     int erf_id, int exp_id, void* stream) {
  return launch_bwd<IsoGeo, false>(oc, sig, mag, alb, dirs, counts, dcol, nullptr, scratch, doc,
                                   dsig, dmag, dalb, ddirs, part_ms, B, N, R, ck, threads, qb,
                                   erf_id, exp_id, stream);
}

// The saved-T chunked backward: reads T (B,5,N,R) written by
// sgrt_chunked_fwd_t with the same qb.
int sgrt_chunked_bwd_t(const float* oc, const float* sig, const float* mag, const float* alb,
                       const float* dirs, const int* counts, const float* dcol, const float* t,
                       float* scratch, float* doc, float* dsig, float* dmag, float* dalb,
                       float* ddirs, float* part_ms, int B, int N, int R, int ck, int threads,
                       int qb, int erf_id, int exp_id, void* stream) {
  return launch_bwd<IsoGeo, true>(oc, sig, mag, alb, dirs, counts, dcol, t, scratch, doc, dsig,
                                  dmag, dalb, ddirs, part_ms, B, N, R, ck, threads, qb, erf_id,
                                  exp_id, stream);
}

// The anisotropic twins of the four: invd (B,N,3) = scale^-2 in place of
// sigma, dinvd (B,N,3) in place of dsig.
int sgrt_chunked_fwd_aniso(const float* oc, const float* invd, const float* mag,
                           const float* alb, const float* dirs, const int* counts,
                           float* partial, float* colors, int B, int N, int R, int threads,
                           int pb, int qb, int erf_id, int exp_id, void* stream) {
  return launch_fwd<AnisoGeo, kStoreNone>(oc, invd, mag, alb, dirs, counts, partial, colors,
                                          nullptr, B, N, R, threads, pb, qb, erf_id, exp_id,
                                          stream);
}

int sgrt_chunked_fwd_t_aniso(const float* oc, const float* invd, const float* mag,
                             const float* alb, const float* dirs, const int* counts,
                             float* partial, float* colors, float* t, int B, int N, int R,
                             int threads, int pb, int qb, int erf_id, int exp_id, void* stream) {
  return launch_fwd<AnisoGeo, kStoreT>(oc, invd, mag, alb, dirs, counts, partial, colors, t, B, N,
                                       R, threads, pb, qb, erf_id, exp_id, stream);
}

int sgrt_chunked_bwd_aniso(const float* oc, const float* invd, const float* mag,
                           const float* alb, const float* dirs, const int* counts,
                           const float* dcol, float* scratch, float* doc, float* dinvd,
                           float* dmag, float* dalb, float* ddirs, float* part_ms, int B, int N,
                           int R, int ck, int threads, int qb, int erf_id, int exp_id,
                           void* stream) {
  return launch_bwd<AnisoGeo, false>(oc, invd, mag, alb, dirs, counts, dcol, nullptr, scratch,
                                     doc, dinvd, dmag, dalb, ddirs, part_ms, B, N, R, ck, threads,
                                     qb, erf_id, exp_id, stream);
}

int sgrt_chunked_bwd_t_aniso(const float* oc, const float* invd, const float* mag,
                             const float* alb, const float* dirs, const int* counts,
                             const float* dcol, const float* t, float* scratch, float* doc,
                             float* dinvd, float* dmag, float* dalb, float* ddirs, float* part_ms,
                             int B, int N, int R, int ck, int threads, int qb, int erf_id,
                             int exp_id, void* stream) {
  return launch_bwd<AnisoGeo, true>(oc, invd, mag, alb, dirs, counts, dcol, t, scratch, doc,
                                    dinvd, dmag, dalb, ddirs, part_ms, B, N, R, ck, threads, qb,
                                    erf_id, exp_id, stream);
}

// The fused forwards: the chunked forwards under the fused kernels' own
// symbols (the forward takes no chunk size: one chunk of N rows, any
// N >= 1), over isotropic rows and, the _aniso twins, anisotropic ones.
int sgrt_fused_fwd(const float* oc, const float* sig, const float* mag, const float* alb,
                   const float* dirs, const int* counts, float* partial, float* colors, int B,
                   int N, int R, int threads, int pb, int qb, int erf_id, int exp_id,
                   void* stream) {
  return launch_fwd<IsoGeo, kStoreNone>(oc, sig, mag, alb, dirs, counts, partial, colors, nullptr,
                                        B, N, R, threads, pb, qb, erf_id, exp_id, stream);
}

int sgrt_fused_fwd_t(const float* oc, const float* sig, const float* mag, const float* alb,
                     const float* dirs, const int* counts, float* partial, float* colors,
                     float* t, int B, int N, int R, int threads, int pb, int qb, int erf_id,
                     int exp_id, void* stream) {
  return launch_fwd<IsoGeo, kStoreT>(oc, sig, mag, alb, dirs, counts, partial, colors, t, B, N, R,
                                     threads, pb, qb, erf_id, exp_id, stream);
}

int sgrt_fused_fwd_aniso(const float* oc, const float* invd, const float* mag,
                         const float* alb, const float* dirs, const int* counts,
                         float* partial, float* colors, int B, int N, int R, int threads,
                         int pb, int qb, int erf_id, int exp_id, void* stream) {
  return launch_fwd<AnisoGeo, kStoreNone>(oc, invd, mag, alb, dirs, counts, partial, colors,
                                          nullptr, B, N, R, threads, pb, qb, erf_id, exp_id,
                                          stream);
}

int sgrt_fused_fwd_t_aniso(const float* oc, const float* invd, const float* mag,
                           const float* alb, const float* dirs, const int* counts,
                           float* partial, float* colors, float* t, int B, int N, int R,
                           int threads, int pb, int qb, int erf_id, int exp_id, void* stream) {
  return launch_fwd<AnisoGeo, kStoreT>(oc, invd, mag, alb, dirs, counts, partial, colors, t, B, N,
                                       R, threads, pb, qb, erf_id, exp_id, stream);
}

// The fused backwards: the chunked ones at one chunk, ck = N (any N >= 1).
// sgrt_fused_bwd_t reads T (B,5,N,R) from sgrt_fused_fwd_t with the same
// qb; sgrt_fused_bwd recomputes it with that forward, bit for bit; the
// _aniso twins the same over anisotropic rows (T from
// sgrt_fused_fwd_t_aniso).
// Scratch and part_ms as the chunked ones' at C = 1.
int sgrt_fused_bwd_t(const float* oc, const float* sig, const float* mag, const float* alb,
                     const float* dirs, const int* counts, const float* dcol, const float* t,
                     float* scratch, float* doc, float* dsig, float* dmag, float* dalb,
                     float* ddirs, float* part_ms, int B, int N, int R, int ck, int threads,
                     int qb, int erf_id, int exp_id, void* stream) {
  if (ck != N) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<IsoGeo, true>(oc, sig, mag, alb, dirs, counts, dcol, t, scratch, doc, dsig,
                                  dmag, dalb, ddirs, part_ms, B, N, R, ck, threads, qb, erf_id,
                                  exp_id, stream);
}

int sgrt_fused_bwd(const float* oc, const float* sig, const float* mag, const float* alb,
                   const float* dirs, const int* counts, const float* dcol, float* scratch,
                   float* doc, float* dsig, float* dmag, float* dalb, float* ddirs,
                   float* part_ms, int B, int N, int R, int ck, int threads, int qb, int erf_id,
                   int exp_id, void* stream) {
  if (ck != N) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<IsoGeo, false>(oc, sig, mag, alb, dirs, counts, dcol, nullptr, scratch, doc,
                                   dsig, dmag, dalb, ddirs, part_ms, B, N, R, ck, threads, qb,
                                   erf_id, exp_id, stream);
}

int sgrt_fused_bwd_t_aniso(const float* oc, const float* invd, const float* mag,
                           const float* alb, const float* dirs, const int* counts,
                           const float* dcol, const float* t, float* scratch, float* doc,
                           float* dinvd, float* dmag, float* dalb, float* ddirs, float* part_ms,
                           int B, int N, int R, int ck, int threads, int qb, int erf_id,
                           int exp_id, void* stream) {
  if (ck != N) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<AnisoGeo, true>(oc, invd, mag, alb, dirs, counts, dcol, t, scratch, doc,
                                    dinvd, dmag, dalb, ddirs, part_ms, B, N, R, ck, threads, qb,
                                    erf_id, exp_id, stream);
}

int sgrt_fused_bwd_aniso(const float* oc, const float* invd, const float* mag, const float* alb,
                         const float* dirs, const int* counts, const float* dcol, float* scratch,
                         float* doc, float* dinvd, float* dmag, float* dalb, float* ddirs,
                         float* part_ms, int B, int N, int R, int ck, int threads, int qb,
                         int erf_id, int exp_id, void* stream) {
  if (ck != N) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<AnisoGeo, false>(oc, invd, mag, alb, dirs, counts, dcol, nullptr, scratch,
                                     doc, dinvd, dmag, dalb, ddirs, part_ms, B, N, R, ck, threads,
                                     qb, erf_id, exp_id, stream);
}

// Floats of scratch that one backward launch needs (recompute: without
// saved T; the same for both geometries).
long long sgrt_chunked_bwd_scratch_floats(int B, int N, int R, int ck, int threads,
                                          int recompute) {
  return static_cast<long long>(
      scratch_layout(B, N, R, ck, threads, recompute != 0, kSums, true));
}

// The split forwards: the forward at one chunk (ck = N, any N >= 1) over
// plane rows (PlaneGeo), mb, co (B,N,R), sigma, inv (B,N), counts (B,).
// sgrt_split_fwd writes tw (B,N,R), zero on rows at or past the count, and
// no colors; sgrt_split_fwd_color the colors (B,3,R) from albedo (B,N,3),
// partial (B, N/32, 3, R) scratch. threads = 32 rays a block; pb (8 or 16,
// the route's p block) does not change the kernel. Returns a cudaError_t
// (cudaErrorInvalidValue for a configuration the kernel does not take).
int sgrt_split_fwd(const float* mb, const float* co, const float* sig, const float* inv,
                   const int* counts, float* tw, int B, int N, int R, int threads, int pb,
                   int qb, int erf_id, int exp_id, void* stream) {
  const PlaneGeo::Args in{mb, co, sig, inv, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_fwd<PlaneGeo, kStoreTw>(nullptr, nullptr, nullptr, nullptr, nullptr, counts,
                                        nullptr, nullptr, tw, B, N, R, threads, pb, qb, erf_id,
                                        exp_id, stream, in);
}

int sgrt_split_fwd_color(const float* mb, const float* co, const float* sig, const float* inv,
                         const float* alb, const int* counts, float* partial, float* colors,
                         int B, int N, int R, int threads, int pb, int qb, int erf_id,
                         int exp_id, void* stream) {
  const PlaneGeo::Args in{mb, co, sig, inv, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_fwd<PlaneGeo, kStoreNone>(nullptr, nullptr, nullptr, alb, nullptr, counts,
                                          partial, colors, nullptr, B, N, R, threads, pb, qb,
                                          erf_id, exp_id, stream, in);
}

// The split backwards: the recompute backward at one chunk (ck = N) over
// plane rows (PlaneGeo). sgrt_split_bwd is the VJP of sgrt_split_fwd for
// the cotangent g (B,N,R) of tw: dmb, dco (B,N,R), dsig,
// dinv (B,N); sgrt_split_bwd_color that of sgrt_split_fwd_color for dcol
// (B,3,R), plus dalb (B,N,3). threads = 32 rays a block; scratch of
// sgrt_split_bwd_scratch_floats(B, N, R, 32) floats; part_ms (4 + 1 floats,
// or null) as launch_bwd's: T, p side, db sum, q side, the rows kernel.
int sgrt_split_bwd(const float* mb, const float* co, const float* sig, const float* inv,
                   const int* counts, const float* g, float* scratch, float* dmb, float* dco,
                   float* dsig, float* dinv, float* part_ms, int B, int N, int R, int threads,
                   int qb, int erf_id, int exp_id, void* stream) {
  const PlaneGeo::Args in{mb, co, sig, inv, g, dmb, dco, dsig, dinv};
  return launch_bwd<PlaneGeo, false>(nullptr, nullptr, nullptr, nullptr, nullptr, counts, nullptr,
                                     nullptr, scratch, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     part_ms, B, N, R, N, threads, qb, erf_id, exp_id, stream, in);
}

int sgrt_split_bwd_color(const float* mb, const float* co, const float* sig, const float* inv,
                         const float* alb, const int* counts, const float* dcol, float* scratch,
                         float* dmb, float* dco, float* dsig, float* dinv, float* dalb,
                         float* part_ms, int B, int N, int R, int threads, int qb, int erf_id,
                         int exp_id, void* stream) {
  const PlaneGeo::Args in{mb, co, sig, inv, nullptr, dmb, dco, dsig, dinv};
  return launch_bwd<PlaneGeo, false>(nullptr, nullptr, nullptr, alb, nullptr, counts, dcol,
                                     nullptr, scratch, nullptr, nullptr, nullptr, dalb, nullptr,
                                     part_ms, B, N, R, N, threads, qb, erf_id, exp_id, stream, in);
}

// Floats of scratch that one split backward launch needs (either one).
long long sgrt_split_bwd_scratch_floats(int B, int N, int R, int threads) {
  return static_cast<long long>(
      scratch_layout(B, N, R, N, threads, true, Side<PlaneGeo>::kN, false));
}

// The as5 tap of every kernel (erf_and_gauss<kErfAs5>) at n float32 points
// x, and its IEEE form beside it: out (4, n) = e, g, e_ieee, g_ieee.
int sgrt_as5_tap_probe(const float* x, float* out, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  as5_tap_probe<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the approximations' table (gauss_common.cuh, kApproxTab).
int sgrt_approx_table_floats() { return kTabFloats; }

// Fills the approximations' table of the current device from n host floats
// (approx.kernel_tables(): the taylor erf's terms, then the erf, full-range
// erf and exp cubics). The kernels of every erf and exp read it; the host
// calls this once per device before its first launch there.
int sgrt_set_approx_tables(const float* tab, int n) {
  if (n != kTabFloats) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyToSymbol(kApproxTab, tab, sizeof(float) * kTabFloats));
}

// Resources of kernel i of this library at the launches' own block sizes
// and qb staged rows (threads is ignored: a block is always 32 rays):
// kernel_resources's seven ints into out, its name into name. Returns -1
// past the last kernel. Kernels 0-12 are the as5/exact instantiations the
// main paths run, 13-18 some of the other erfs' and exps' (the build log's
// ptxas report lists every instantiation).
int sgrt_kernel_resources(int i, int, int qb, int* out, const char** name) {
  const int fwd = kRays * kFwdG, bwd = kRays * kBwdG;
  switch (i) {
    case 0:
      *name = "chunked fwd_kernel<IsoGeo>";
      return kernel_resources(fwd_kernel<IsoGeo, kErfAs5, kExpExact, kStoreNone>, fwd,
                              fwd_smem(qb), out);
    case 1:
      *name = "chunked fwd_kernel<IsoGeo, STORE_T>";
      return kernel_resources(fwd_kernel<IsoGeo, kErfAs5, kExpExact, kStoreT>, fwd,
                              fwd_smem(qb), out);
    case 2:
      *name = "chunked bwd_p_kernel<IsoGeo>";
      return kernel_resources(bwd_p_kernel<IsoGeo, kExpExact>, bwd, bwd_p_smem(qb), out);
    case 3:
      *name = "chunked bwd_q_kernel<IsoGeo>";
      return kernel_resources(bwd_q_kernel<IsoGeo, kErfAs5, kExpExact>, bwd, bwd_q_smem(qb), out);
    case 4:
      *name = "chunked fwd_kernel<AnisoGeo>";
      return kernel_resources(fwd_kernel<AnisoGeo, kErfAs5, kExpExact, kStoreNone>, fwd,
                              fwd_smem(qb), out);
    case 5:
      *name = "chunked fwd_kernel<AnisoGeo, STORE_T>";
      return kernel_resources(fwd_kernel<AnisoGeo, kErfAs5, kExpExact, kStoreT>, fwd,
                              fwd_smem(qb), out);
    case 6:
      *name = "chunked bwd_p_kernel<AnisoGeo>";
      return kernel_resources(bwd_p_kernel<AnisoGeo, kExpExact>, bwd, bwd_p_smem(qb),
                              out);
    case 7:
      *name = "chunked bwd_q_kernel<AnisoGeo>";
      return kernel_resources(bwd_q_kernel<AnisoGeo, kErfAs5, kExpExact>, bwd, bwd_q_smem(qb),
                              out);
    case 8:
      *name = "chunked fwd_kernel<PlaneGeo, STORE_T>";
      return kernel_resources(fwd_kernel<PlaneGeo, kErfAs5, kExpExact, kStoreT>, fwd, fwd_smem(qb),
                              out);
    case 9:
      *name = "chunked bwd_p_kernel<PlaneGeo>";
      return kernel_resources(bwd_p_kernel<PlaneGeo, kExpExact>, bwd, bwd_p_smem(qb),
                              out);
    case 10:
      *name = "chunked bwd_q_kernel<PlaneGeo>";
      return kernel_resources(bwd_q_kernel<PlaneGeo, kErfAs5, kExpExact>, bwd, bwd_q_smem(qb),
                              out);
    case 11:
      *name = "chunked fwd_kernel<PlaneGeo>";
      return kernel_resources(fwd_kernel<PlaneGeo, kErfAs5, kExpExact, kStoreNone>, fwd,
                              fwd_smem(qb), out);
    case 12:
      *name = "chunked fwd_kernel<PlaneGeo, STORE_TW>";
      return kernel_resources(fwd_kernel<PlaneGeo, kErfAs5, kExpExact, kStoreTw>, fwd,
                              fwd_smem(qb), out);
    case 13:
      *name = "chunked fwd_kernel<IsoGeo, taylor, exact>";
      return kernel_resources(fwd_kernel<IsoGeo, kErfTaylor, kExpExact, kStoreNone>, fwd,
                              fwd_smem(qb), out);
    case 14:
      *name = "chunked fwd_kernel<IsoGeo, spline, spline, STORE_T>";
      return kernel_resources(fwd_kernel<IsoGeo, kErfSpline, kExpSpline, kStoreT>, fwd,
                              fwd_smem(qb), out);
    case 15:
      *name = "chunked fwd_kernel<AnisoGeo, spline_mirror, exact, STORE_T>";
      return kernel_resources(fwd_kernel<AnisoGeo, kErfSplineMirror, kExpExact, kStoreT>, fwd,
                              fwd_smem(qb), out);
    case 16:
      *name = "chunked bwd_p_kernel<IsoGeo, spline>";
      return kernel_resources(bwd_p_kernel<IsoGeo, kExpSpline>, bwd, bwd_p_smem(qb), out);
    case 17:
      *name = "chunked bwd_q_kernel<AnisoGeo, as5, spline>";
      return kernel_resources(bwd_q_kernel<AnisoGeo, kErfAs5, kExpSpline>, bwd, bwd_q_smem(qb),
                              out);
    case 18:
      *name = "chunked fwd_kernel<PlaneGeo, spline_mirror, spline, STORE_TW>";
      return kernel_resources(fwd_kernel<PlaneGeo, kErfSplineMirror, kExpSpline, kStoreTw>, fwd,
                              fwd_smem(qb), out);
    default:
      return -1;
  }
}

}  // extern "C"
