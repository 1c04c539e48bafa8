// Device math of the chunked kernels (chunked.cu, also every fused kernel
// and every split kernel): the erf/exp variants the kernels are compiled
// for, the rounding-controlled Gaussian exponent, a row's per-row
// constants, the three row geometries (isotropic, anisotropic, and plane
// rows read from precomputed planes), the five quadrature taps, a warp sum,
// the ordered sum of per-block partials, and on the host a kernel's
// resources per SM.
//
// No fast-math flag: every exp and division is the accurate one but the A&S
// reciprocal of the as5 tap (erf_and_gauss<kErfAs5>), which every pair loop
// of every kernel runs: there it is the SFU's rcp.approx, exp(-x^2) is the
// accurate expf with x^2's rounding carried by an FMA, and the sign is put
// back with a bit operation (the note above erf_and_gauss<kErfAs5> gives
// the sequence and its accuracy). The kernels agree with their plain
// PyTorch versions (sgrt_tpu_torch/ops/cuda_kernel.py, cuda_aniso.py) to
// summation order and the taps' rounding.

#pragma once

#include <cuda_runtime.h>

namespace sgrt {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 1.2533141373155001f;  // sqrt(pi/2)
constexpr float kSqrt2Pi = 0.7978845608028654f;     // sqrt(2/pi)
constexpr float kDerf = 1.1283791670955126f;        // 2/sqrt(pi) = erf'(0)
constexpr int kTaps = 5;

// The erf and exp names the kernels are built for (template arguments; the
// ids of ops/cuda_kernel.py's KERNEL_ERFS and KERNEL_EXPS): every name of
// sgrt_tpu_torch/ops/approx.py's ERF_IMPLS and EXP_IMPLS, "exact" erf
// being as5.
enum { kErfAs5 = 0, kErfAs3 = 1, kErfTaylor = 2, kErfSpline = 3, kErfSplineMirror = 4 };
enum { kExpExact = 0, kExpFast = 1, kExpSpline = 2 };
constexpr int kErfs = 5, kExps = 3;

// The erf whose (erf, gauss) pair the backward takes for erf ERF: its own
// where it has one (as5, as3), else as5's (approx.py's
// ERF_AND_GAUSS_IMPLS.get(name, as5), as the JAX package's backwards).
constexpr int pair_erf(int erf) { return erf == kErfAs3 ? kErfAs3 : kErfAs5; }

// The coefficients of the taylor erf and of the three piecewise cubics
// (approx.py's _TAYLOR_COEF, _ERF_COEF, _ERF_FULL_COEF, _EXP_COEF, fitted
// there at import), rounded to float32 as the plain versions round them:
// the host fills this table once per device after the library loads
// (sgrt_set_approx_tables, from approx.kernel_tables()). A cubic's four
// coefficients run from the highest power down, a segment after another.
constexpr int kTaylorTerms = 10, kErfSegs = 8, kErfFullSegs = 16, kExpSegs = 16;
constexpr int kTabTaylor = 0;
constexpr int kTabErf = kTabTaylor + kTaylorTerms;
constexpr int kTabErfFull = kTabErf + 4 * kErfSegs;
constexpr int kTabExp = kTabErfFull + 4 * kErfFullSegs;
constexpr int kTabFloats = kTabExp + 4 * kExpSegs;
__constant__ float kApproxTab[kTabFloats];

// approx.py's _eval_segments: the cubic of the segment that holds x
// clamped to [lo, lo + NSEG width], evaluated in its order with every
// product and sum rounded to nearest. The plain version picks the segment
// by a where-chain over the float32 edges lo + i width, the later segment
// winning on a shared edge; the fitted pieces are not continuous there, so
// the index must be that chain's, not one ulp off. The widths are powers of
// two (0.5, 1) and lo a multiple of them, so x / width is exact and its
// floor is the chain's index.
template <int NSEG>
__device__ __forceinline__ float eval_segments(float x, int tab, float lo, float width) {
  const float xc = fminf(fmaxf(x, lo), lo + NSEG * width);
  const float inv_w = 1.0f / width;  // a literal after inlining: 2 or 1
  const int i = min(__float2int_rd(xc * inv_w) - static_cast<int>(lo * inv_w), NSEG - 1);
  const int c = tab + 4 * i;
  float v = __fadd_rn(__fmul_rn(kApproxTab[c], xc), kApproxTab[c + 1]);
  v = __fadd_rn(__fmul_rn(v, xc), kApproxTab[c + 2]);
  return __fadd_rn(__fmul_rn(v, xc), kApproxTab[c + 3]);
}

template <int EXP>
__device__ __forceinline__ float exp_fn(float x);

template <>
__device__ __forceinline__ float exp_fn<kExpExact>(float x) {
  return expf(x);
}

// Schraudolph's bit-trick exp (sgrt_tpu/ops/approx.py::exp_fast): the
// rounded-to-nearest multiply and add keep nvcc from contracting them into
// one FMA, so the bits match the float32 reference.
template <>
__device__ __forceinline__ float exp_fn<kExpFast>(float x) {
  x = fminf(fmaxf(x, -87.0f), 88.0f);
  const float y = __fadd_rn(__fmul_rn(12102203.0f, x), 1064866805.0f);
  return __int_as_float(__float2int_rz(y));
}

// The piecewise-cubic exp on [-16, 0] (approx.py::exp_spline): 0 below,
// the accurate expf above 0 (outside the renderer's domain).
template <>
__device__ __forceinline__ float exp_fn<kExpSpline>(float x) {
  if (x < -16.0f) return 0.0f;
  if (x > 0.0f) return expf(x);
  return eval_segments<kExpSegs>(x, kTabExp, -16.0f, 1.0f);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// The SFU's reciprocal, one MUFU.RCP (ftz: a denormal input or result is
// 0), for 1 + p|x| >= 1 within ~1 ulp of the IEEE division.
__device__ __forceinline__ float rcp_approx(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

// exp(-x^2) of as5's tap and of the backward's p side (which needs only
// this half, whatever the erf): x^2 = h + l exactly (FMA) and exp(-x^2) =
// expf(-h) (1 - l) to float32 accuracy (|l| <= 2^-24 h): the accurate expf
// (about 7 instructions beside its MUFU.EX2) and 3 FP32 more. Through
// expf(-x x) alone, x x's rounding costs g up to 2^-18.9 of itself at
// |x| ~ 7. MUFU.EX2 of a float32 -log2(e) x^2 is cheaper but reads 2^-17.3
// there, and with that exponent's rounding carried by FMAs (2^-22.3) it
// still leaves g ~4e-8 low on average over [0, 4]: the dense cell's float64
// gate of ddirs, whose sums cancel, failed with it (PERF.md).
__device__ __forceinline__ float gauss(float x) {
  const float h = x * x;
  const float l = fmaf(x, x, -h);
  const float g = expf(-h);
  return fmaf(g, -l, g);
}

// erf(x) and exp(-x^2) sharing the one exp (Abramowitz & Stegun 7.1.26
// for as5, 7.1.25 for as3); the backward needs both, since
// erf'(x) = 2/sqrt(pi) exp(-x^2). The polynomial's own exp is always
// gauss (as5) or the accurate expf (as3), whatever EXP the kernel is built
// with. An erf without a pair of its own (taylor, spline, spline_mirror)
// takes as5's: the forward evaluates the named erf (erf_fn), the
// backward's erf values and erf' come from the pair.
template <int ERF>
__device__ __forceinline__ void erf_and_gauss(float x, float& e, float& g);

// as5's tap, the kernels' erf: 1 + p|x| (FFMA, |x| an operand modifier),
// t = 1/(1 + p|x|) (MUFU.RCP), the Horner chain in A&S's order (4 FFMA, 1
// FMUL), g = gauss(x), 1 - poly g (FFMA) and x's sign (LOP3): 18 FP32 and
// integer instructions and 2 MUFU (19 with the caller's argument), the
// same coefficients and sums as the IEEE form (1/(1 + p|x|), expf(-x x),
// sign(x) (1 - poly g)). Against the formula in float64, over 2^20 + 1
// points of [-8, 8] on an H100, e is off by at most 4.54e-7 (the IEEE
// form: 3.95e-7) and g by 2^-22.4 of itself (2^-18.9) where exp(-x^2) >=
// 2^-100 (test_as5_tap_accuracy holds them to twice the IEEE form's e error
// and to 2^-21); e(0) = 0 exactly (rcp(1) = 1, exp(0) = 1 and the float32
// Horner chain at t = 1 is 1), and e = +-1 exactly for |x| >= 4 (poly g <
// 2^-25 there).
template <>
__device__ __forceinline__ void erf_and_gauss<kErfAs5>(float x, float& e, float& g) {
  const float t = rcp_approx(fmaf(fabsf(x), 0.3275911f, 1.0f));
  float poly = fmaf(t, 1.061405429f, -1.453152027f);
  poly = fmaf(t, poly, 1.421413741f);
  poly = fmaf(t, poly, -0.284496736f);
  poly = fmaf(t, poly, 0.254829592f);
  poly = t * poly;
  g = gauss(x);
  e = copysignf(fmaf(-poly, g, 1.0f), x);
}

template <>
__device__ __forceinline__ void erf_and_gauss<kErfAs3>(float x, float& e, float& g) {
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.47047f * a);
  const float poly = t * (0.3480242f + t * (-0.0958798f + t * 0.7478556f));
  g = expf(-x * x);
  e = sign_of(x) * (1.0f - poly * g);
}

// The named erf of the forward: as5 and as3 are their pairs' erf.
template <int ERF>
__device__ __forceinline__ float erf_fn(float x) {
  float e, g;
  erf_and_gauss<ERF>(x, e, g);
  return e;
}

// The 10-term Maclaurin series on x clamped to [-2, 2] (approx.py::
// erf_taylor): Horner in x^2 from the highest term, then (2/sqrt(pi) x) acc.
template <>
__device__ __forceinline__ float erf_fn<kErfTaylor>(float x) {
  x = fminf(fmaxf(x, -2.0f), 2.0f);
  const float x2 = __fmul_rn(x, x);
  float acc = kApproxTab[kTabTaylor + kTaylorTerms - 1];
#pragma unroll
  for (int n = kTaylorTerms - 2; n >= 0; --n)
    acc = __fadd_rn(__fmul_rn(acc, x2), kApproxTab[kTabTaylor + n]);
  return __fmul_rn(__fmul_rn(kDerf, x), acc);
}

// The piecewise cubic over [-4, 4], saturating to -1 and 1 outside
// (approx.py::erf_spline).
template <>
__device__ __forceinline__ float erf_fn<kErfSpline>(float x) {
  if (x <= -4.0f) return -1.0f;
  if (x >= 4.0f) return 1.0f;
  return eval_segments<kErfFullSegs>(x, kTabErfFull, -4.0f, 0.5f);
}

// The piecewise cubic over [0, 4] mirrored by odd symmetry, 1 beyond 4
// (approx.py::erf_spline_mirror).
template <>
__device__ __forceinline__ float erf_fn<kErfSplineMirror>(float x) {
  const float a = fabsf(x);
  const float v = a >= 4.0f ? 1.0f : eval_segments<kErfSegs>(a, kTabErf, 0.0f, 0.5f);
  return sign_of(x) * v;
}

// erf_and_gauss of an erf without a pair: as5's.
template <int ERF>
__device__ __forceinline__ void erf_and_gauss(float x, float& e, float& g) {
  static_assert(pair_erf(ERF) != ERF, "as5 and as3 have their own pairs");
  erf_and_gauss<pair_erf(ERF)>(x, e, g);
}

// The Gaussian's exponent -(|oc|^2 - mb^2) / (2 sigma^2) subtracts two
// nearly equal numbers (|oc|^2 ~ mb^2 when the ray passes near the center),
// so one rounding step of mb or |oc|^2 moves co by up to ulp(|oc|^2) /
// (2 sigma^2) relative. These helpers round every product and sum to
// nearest, in the plain version's order, so nvcc cannot contract them into
// FMAs and the kernels' co matches the plain version's bit for bit.
__device__ __forceinline__ float dot3_rn(float ax, float ay, float az, float bx,
                                         float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// |oc|^2 - mb^2, rounded as the plain version rounds it.
__device__ __forceinline__ float ocsq_minus_mb2_rn(float ocsq, float mb) {
  return __fsub_rn(ocsq, __fmul_rn(mb, mb));
}

__device__ __forceinline__ float gauss_exponent_rn(float ocsq, float mb, float i2s2) {
  return __fmul_rn(-ocsq_minus_mb2_rn(ocsq, mb), i2s2);
}

// Per-row constants of Gaussian q: oc, |oc|^2, 1/(2 s^2), 1/(sqrt2 s),
// mag s sqrt(pi/2).
struct Row {
  float x, y, z, ocsq, i2s2, inv, cs;
};

__device__ __forceinline__ Row load_row(const float* oc, const float* sig, const float* mag,
                                        int q) {
  Row w;
  w.x = oc[3 * q];
  w.y = oc[3 * q + 1];
  w.z = oc[3 * q + 2];
  const float s = sig[q];
  w.ocsq = dot3_rn(w.x, w.y, w.z, w.x, w.y, w.z);
  w.i2s2 = 1.0f / (2.0f * s * s);
  w.inv = kInvSqrt2 / s;
  w.cs = mag[q] * s * kInvSqrt2Pi;
  return w;
}

// co(q, r) = mag sigma sqrt(pi/2) exp(-(|oc|^2 - mb^2) / (2 sigma^2)).
template <int EXP>
__device__ __forceinline__ float coeff(float cs, float ocsq, float mb, float i2s2) {
  return cs * exp_fn<EXP>(gauss_exponent_rn(ocsq, mb, i2s2));
}

// ---------------------------------------------------------------------------
// Row geometries. A Gaussian row seen along a ray is a 1-D Gaussian with
// per-(row, ray) parameters; the kernels are templates over how those are
// made, so that one forward and one backward serve every geometry:
//   mb  = the ray parameter of the peak (mu_bar)
//   sb  = the standard deviation along the ray (sigma_bar)
//   co  = mag sb sqrt(pi/2) exp(exponent)
//   inv = 1 / (sqrt2 sb)
// A scene geometry reads a row's constants from device memory (fields) and
// makes its terms for one ray from them (terms; row is terms(fields(row)));
// plane rows read their terms as they are (PlaneGeo).
// ---------------------------------------------------------------------------

struct RayTerms {
  float mb, sb, co, inv;
};

// What a geometry takes beyond the chunked kernels' (oc, shape, mag, dirs)
// arguments: nothing for the two that make their terms from the scene.
struct NoArgs {};

// Isotropic rows: sigma (B,N) is one number per row, so sb = sigma and inv
// are per row; mb = oc . d and the exponent -(|oc|^2 - mb^2) / (2 sigma^2).
struct IsoGeo {
  using Args = NoArgs;
  static constexpr bool kPlanes = false;

  const float* oc;
  const float* sig;
  const float* mag;

  // the rows of tile b: oc (B,N,3), sigma (B,N), mag (B,N)
  __device__ IsoGeo(const float* oc_, const float* sig_, const float* mag_, int b, int N)
      : oc(oc_ + static_cast<size_t>(b) * N * 3),
        sig(sig_ + static_cast<size_t>(b) * N),
        mag(mag_ + static_cast<size_t>(b) * N) {}

  // A row's own constants (load_row's, and sigma); terms() makes its
  // per-ray terms from them, as row() does
  struct Fields {
    Row w;
    float sb;
  };

  __device__ Fields fields(int q) const { return {load_row(oc, sig, mag, q), sig[q]}; }

  template <int EXP>
  static __device__ RayTerms terms(const Fields& f, float dx, float dy, float dz) {
    RayTerms t;
    t.mb = dot3_rn(f.w.x, f.w.y, f.w.z, dx, dy, dz);
    t.sb = f.sb;
    t.co = coeff<EXP>(f.w.cs, f.w.ocsq, t.mb, f.w.i2s2);
    t.inv = f.w.inv;
    return t;
  }

  template <int EXP>
  __device__ RayTerms row(int p, float dx, float dy, float dz) const {
    return terms<EXP>(fields(p), dx, dy, dz);
  }
};

// Anisotropic rows (diagonal covariance, sgrt_tpu/ops/anisotropic.py's
// math): invd = scale^-2 (B,N,3) per axis, M = oc * invd, and per ray
//   A  = sum_i invd_i d_i^2,  Bt = sum_i M_i d_i,  C = sum_i oc_i^2 invd_i
//   sb = 1/sqrt(A),  mb = Bt sb sb,  inv = sqrt(A/2),
//   co = mag sqrt(pi/2) sb exp(-(C - Bt mb)/2).
// C - Bt mb cancels two numbers of size |oc|^2/scale^2 (~6400 on the
// stretched teapot cloud), so A, Bt, C and every product after them are
// rounded to nearest in a fixed order, as the plain version
// (ops/cuda_aniso.py) computes them; sb is an IEEE square root and
// division, not rsqrtf. A row's fields: invd (3), M (3), C, mag sqrt(pi/2);
// the ray's terms are made from them per (row, ray), about 25 FP32
// instructions and 2 SFU operations.
struct AnisoGeo {
  using Args = NoArgs;
  static constexpr bool kPlanes = false;

  const float* oc;
  const float* invd;
  const float* mag;

  // the rows of tile b: oc (B,N,3), invd (B,N,3), mag (B,N)
  __device__ AnisoGeo(const float* oc_, const float* invd_, const float* mag_, int b, int N)
      : oc(oc_ + static_cast<size_t>(b) * N * 3),
        invd(invd_ + static_cast<size_t>(b) * N * 3),
        mag(mag_ + static_cast<size_t>(b) * N) {}

  struct Fields {
    float ix, iy, iz, mx, my, mz, c, cs;
  };

  __device__ Fields fields(int q) const {
    const float ox = oc[3 * q], oy = oc[3 * q + 1], oz = oc[3 * q + 2];
    Fields f;
    f.ix = invd[3 * q];
    f.iy = invd[3 * q + 1];
    f.iz = invd[3 * q + 2];
    f.mx = __fmul_rn(ox, f.ix);
    f.my = __fmul_rn(oy, f.iy);
    f.mz = __fmul_rn(oz, f.iz);
    f.c = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ox, ox), f.ix), __fmul_rn(__fmul_rn(oy, oy), f.iy)),
                    __fmul_rn(__fmul_rn(oz, oz), f.iz));
    f.cs = __fmul_rn(mag[q], kInvSqrt2Pi);
    return f;
  }

  template <int EXP>
  static __device__ RayTerms terms(const Fields& f, float dx, float dy, float dz) {
    const float a = dot3_rn(f.ix, f.iy, f.iz, __fmul_rn(dx, dx), __fmul_rn(dy, dy),
                            __fmul_rn(dz, dz));
    const float bt = dot3_rn(f.mx, f.my, f.mz, dx, dy, dz);
    RayTerms t;
    t.sb = __fdiv_rn(1.0f, __fsqrt_rn(a));
    t.mb = __fmul_rn(__fmul_rn(bt, t.sb), t.sb);
    const float e = exp_fn<EXP>(__fmul_rn(-0.5f, __fsub_rn(f.c, __fmul_rn(bt, t.mb))));
    t.co = __fmul_rn(__fmul_rn(f.cs, t.sb), e);
    t.inv = __fsqrt_rn(__fmul_rn(0.5f, a));
    return t;
  }

  template <int EXP>
  __device__ RayTerms row(int p, float dx, float dy, float dz) const {
    return terms<EXP>(fields(p), dx, dy, dz);
  }
};

// Plane rows (the split kernels, pallas_kernel.py's tw and colors kernels):
// a row's terms are made outside the kernels (ops/cuda_split.py,
// prep_terms_t) and read here: mb and co per (row, ray) from Gaussian-major
// (B,N,R) planes, sb = sigma and inv per row, inv an input of its own (not
// made from sigma). There is nothing to compute, so a geometry object is one
// thread's, bound to its ray r of tile b: a lane past R reads mb = co = 0,
// and every sum it makes is zero. No directions and no J: the planes' own
// gradients are the backward's outputs. Beside the inputs, Args carries the
// backward's (null in the forwards): g (B,N,R), the cotangent of tw (null in
// the colors backward, whose g is sqrt(2/pi) co albedo . dcol), and the
// outputs dmb, dco (B,N,R) and dsig, dinv (B,N).
struct PlaneGeo {
  struct Args {
    const float* mb;
    const float* co;
    const float* sig;
    const float* inv;
    const float* g;
    float* dmb;
    float* dco;
    float* dsig;
    float* dinv;
  };
  static constexpr bool kPlanes = true;

  // the inputs' and outputs' own pointers (kernel arguments, which the
  // kernels read from the constant bank rather than hold in registers) and
  // the thread's offsets into them
  const float* mb;
  const float* co;
  const float* sig;
  const float* inv;
  const float* g;   // or null
  float* dmb;
  float* dco;
  int at0;          // (b, 0, r) of a (B,N,R) plane (the host keeps B N R < 2^31)
  int row0;         // tile b's first row, b N
  int R;
  bool live;        // r < R

  __device__ PlaneGeo(const Args& a, int b, int N, int R_, int r)
      : mb(a.mb), co(a.co), sig(a.sig), inv(a.inv), g(a.g), dmb(a.dmb), dco(a.dco),
        at0(b * N * R_ + r), row0(b * N), R(R_), live(r < R_) {}

  // row q's element of a (B,N,R) plane for the thread's ray
  __device__ int at(int q) const { return at0 + q * R; }

  __device__ float mb_at(int q) const { return live ? mb[at(q)] : 0.0f; }
  __device__ float co_at(int q) const { return live ? co[at(q)] : 0.0f; }
  __device__ float g_at(int q) const { return live ? g[at(q)] : 0.0f; }
  __device__ float sig_at(int q) const { return sig[row0 + q]; }
  __device__ float inv_at(int q) const { return inv[row0 + q]; }

  template <int EXP>
  __device__ RayTerms row(int q, float, float, float) const {
    RayTerms t;
    t.mb = mb_at(q);
    t.sb = sig_at(q);
    t.co = co_at(q);
    t.inv = inv_at(q);
    return t;
  }
};

// Tap i in 0..4 is k = i - 4; its weight is w_k = exp(-k^2/2). Called with
// unrolled constant indices, both fold to literals.
__device__ __forceinline__ float tap_k(int i) { return static_cast<float>(i - 4); }

__device__ __forceinline__ float tap_weight(int i) {
  return i == 0 ? 3.354626279025119e-04f
       : i == 1 ? 1.110899653824231e-02f
       : i == 2 ? 1.353352832366127e-01f
       : i == 3 ? 6.065306597126334e-01f
                : 1.0f;
}

// Sum over the 32 lanes of a warp in a fixed butterfly (deterministic).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The second level of a sum split over row blocks: out[b, e] = sum of
// part[b, z, e] over the blocks z of tile b that hold live rows, in block
// order (no atomics, deterministic), for e < per_tile. Block z covers rows
// row0 + z rows ..; at most n_blocks are stored per tile. It sums the
// forwards' per-split colors and the backwards' per-block db.
__global__ void ordered_block_sums(const float* __restrict__ part,
                                   const int* __restrict__ counts, float* __restrict__ out,
                                   int B, int N, int per_tile, int n_blocks, int rows,
                                   int row0) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * per_tile) return;
  const int b = static_cast<int>(i / per_tile);
  const int cnt = max(0, min(counts[b], N));
  const int live = min(max((cnt - row0 + rows - 1) / rows, 0), n_blocks);
  const float* src = part + static_cast<size_t>(b) * n_blocks * per_tile + i % per_tile;
  float s = 0.0f;
  for (int z = 0; z < live; ++z) s += src[static_cast<size_t>(z) * per_tile];
  out[i] = s;
}

inline cudaError_t launch_block_sums(const float* part, const int* counts, float* out, int B,
                                     int N, int per_tile, int n_blocks, int rows, int row0,
                                     cudaStream_t s) {
  const size_t n = static_cast<size_t>(B) * per_tile;
  ordered_block_sums<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      part, counts, out, B, N, per_tile, n_blocks, rows, row0);
  return cudaGetLastError();
}

// Allows a kernel more than 48 KB of dynamic shared memory (a no-op below).
template <class F>
inline cudaError_t allow_smem(F fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// What one kernel takes of an SM at a launch's block size and dynamic
// shared memory: out = {registers per thread, local (spill) bytes per
// thread, max threads per block, static shared bytes, dynamic shared bytes,
// threads per block, resident blocks per SM}.
template <class F>
inline int kernel_resources(F fn, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e == cudaSuccess) e = allow_smem(fn, smem);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[7] = {a.numRegs, static_cast<int>(a.localSizeBytes), a.maxThreadsPerBlock,
                    static_cast<int>(a.sharedSizeBytes), static_cast<int>(smem), threads, blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

}  // namespace sgrt
