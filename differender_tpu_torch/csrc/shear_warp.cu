// K8 shear_warp_fwd and K9 shear_warp_bwd: the shear-warp slab march of the
// fast path (fastpath.py), forward and backward, one thread per pixel of the
// intermediate image, in 16x8 tiles over (rows, O).
//
// Replaces the JAX package's slab scan, XLA code with no Pallas in it:
// differender_tpu/fastpath.py::_core, its z-lerp of each plane from two
// voxel layers (:216-229), its remat'd scan step slab_fn (:255) with
// shade_slab (:171) under slab_step's alive test (:291), and JAX's AD of
// that scan.  On the TPU the resample is two hat-matrix products on the
// matrix unit and the scan takes slab_batch slabs a step.  The port's plain
// version, ops/shear_warp.py::shear_warp_march_plain, runs the same
// arithmetic as chunks of torch operations.
//
// What it computes.  The input is the volume's voxel layers (Z, X, Y, 4)
// along the principal axis, channels last (intensity and gradient), in the
// frame where the camera lf sits on the negative side of the last axis.
// Plane s lies at z = zws[s] and is the lerp of layers zlo[s] and zhi[s]
// with weight fz[s]: lo (1 - fz) + hi fz per channel, rounded as the torch
// expression that built the slab stack before this lerp moved into the
// kernels, so each slab texel is bitwise the same and no (S, X, Y, 4)
// stack (537 MB at 256^3 and 512 planes) is built, nor its cotangent.
// Pixel (r, o) is the ray through (ga[r], gb[o], 0).  Per plane, front to
// back, the thread takes the ray's crossing and the 2x2 taps of the
// separable lerp (the rows of the JAX package's _interp_matrix: weights 0
// outside [0, size - 1]), z-lerps the 4 texels of those taps from the two
// layers (slab_texel, one 16-byte load a layer), resamples the 4 channels
// along x and then along y as _resample does, classifies through the TF
// (tf_lerp, the TF staged in shared memory), shades with the headlight and
// corrects the opacity with the pixel's exponent, weighs by the footprint
// coverage and composites under the gate T > thr.
//
// The footprint interval. A sample whose crossing lies outside [0, X - 1] or
// [0, Y - 1] has coverage 0, so alpha 0 and colour 0: it adds exactly nothing
// to the image, leaves T, and in K9 adds nothing to d_tf or the volume (every
// cotangent passes through alpha, the coverage or pow_vjp's zero test) and
// leaves the segment sums (U, P, Tloc) as they were. Each source coordinate
// is a chain of correctly rounded operations that are monotone in zws[s],
// which is non-decreasing in s: sz = (zw - lz) / (0 - lz), l + sz (g - l), +
// 1, * sc. So the planes where one coordinate lies inside form one interval,
// found by binary search with the same rounded formula (footprint_interval,
// per row and per column in the block's prologue, kept in shared memory), and
// a pixel's planes are the intersection of its row's and its column's. Both
// kernels march only [first, min(last, the gate)] of each pixel: at the bench
// view on ct_phantom that is 44.8M of the 160.1M samples before the pixels'
// stop planes. `steps` keeps its meaning (the plane where the plain march's
// gate first fails, or S) and `taken` counts the samples a pixel took.
//
// Rounding.  The coverage jumps from 0 to 1 at the footprint's edge, a
// tap's index moves at an integer source position, and the backward's dot
// mask (frac > 0) depends on the exact intensity.  So positions, taps, the
// z-lerp, the x and y lerps, shading sums and the composite are computed
// unfused, each operation rounded once in the plain version's order
// (__fmul_rn / __fadd_rn are never contracted into an FMA), and 1/sqrt is a
// correctly rounded square root and division, as torch.rsqrt rounds on the
// CPU.  powf is CUDA's, as torch.pow's on the card.
//
// K9 recomputes and keeps no tape: K2's scheme (march_bwd.cu).  It reads
// K8's output (rgb_F, 1 - T_F) and walks front to back again through K8's
// own device functions, so it takes bitwise K8's samples and gate
// decisions.  Per sample dL/dc_s = T_s g.rgb and dL/da_s = -(T_b/f_s)(U -
// P_s) within a segment that starts at transmittance T_b with U its whole
// sum behind; a sample with f_s < kRestartBelow marches the rest of its
// footprint once more from a local transmittance of 1 and starts a new
// segment (counted in `restarts`), and the last composited sample takes
// the exact U = -g.a, so a TF alpha of exactly 1 gives no 0/0.  It pulls
// the cotangents through the coverage, the opacity correction's power (its
// VJP 0 wherever its cotangent is 0, as fastpath's _Pow), min(1, light) and
// max(n.l, 0) (half at a tie, as torch and JAX take it), the specular
// power, the clamped unit-normal VJP and the TF lerp with the dot mask
// (tf_lerp_bwd, frac > 0: the VJP of JAX's apply_tf_dot).  Each sample's 4
// channel cotangents go to its up to 4 distinct taps, and each tap's to
// layer zlo with weight 1 - fz and to zhi with weight fz (the z-lerp's
// transpose), one 16-byte vector atomic (red.global.add.v4.f32) a layer,
// straight into d_layers.  d_tf is summed per block in shared memory and
// flushed once per block (flush_tf_grad); a pixel's terms on its samples'
// low texel are first summed in registers while that texel stays the same
// (TfRun: in empty space every sample adds to texel 0, and the lanes of a
// warp adding to one shared address serialise).  K9 keeps each sample's
// shading terms from the recompute for the sample's backward.
//
// Bound on the H100. Operations: ~182 f32 operations a sample in K8, ~435 in
// K9, over the in-footprint samples before each pixel's stop plane, and 12 a
// needed slab texel for the z-lerp; bytes: the layer texels those samples
// need, each once (and, for K9, d_layers written once on them). chip_smoke.py
// counts both from the geometry and the stop plane; both kernels are bound by
// operations. In practice the time goes to each sample's dependent chain (two
// powf, three square roots and divisions, the TF lerp) and its 8 loads of
// layer texels from L1 and L2, and, in K9, to the recompute and the atomics.
// Tried and dropped, on the card's numbers (PERF.md;
// tools/shear_warp_variants.py times variants side by side): blocks that
// march their planes in lockstep from a shared-memory tile of each plane,
// loaded with cp.async and z-lerped once a texel, with the plane's taps
// computed once a block, were 1.2-1.8x slower in K8 (per-plane barriers, a
// block waiting for its slowest warp); summing K9's cotangents per plane in
// shared memory before adding them to d_layers, in that lockstep, was slower
// than its global vector atomics.
#include <cuda_runtime.h>

#include "tf_lerp.cuh"

// Mirrored field for field by differender_tpu_torch/ops/shear_warp.py::
// _ShearWarpArgs.
struct ShearWarpArgs {
  const float* layers;    // (Z, X, Y, 4): the voxel layers, channels last
  const float* tf;        // (R, 4)
  const float* ga;        // (rows,): the grid's x of each row computed
  const float* gb;        // (O,): the grid's y of each column
  const float* zws;       // (S,): each plane's z
  const int* zlo;         // (S,): each plane's lower voxel layer
  const int* zhi;         // (S,): its upper layer
  const float* fz;        // (S,): the upper layer's lerp weight
  const float* exponent;  // (rows, O): the opacity correction's exponent
  const float* lf;        // (3,): the camera, in the slab frame
  const float* light;     // (3,): the headlight, in the slab frame
  float* inter;           // (rows, O, 4): K8 writes it, K9 reads it
  int* steps;             // (rows, O) or null: where K8's gate fails, or S
  int* taken;             // (rows, O) or null: the samples K8 computed
  int* restarts;          // (rows, O) or null: K9's restarts a pixel
  const float* grad;      // (rows, O, 4): K9's cotangent of inter
  float* d_layers;        // (Z, X, Y, 4), zeroed by the caller (K9)
  float* d_tf;            // (R, 4), zeroed by the caller (K9)
  int S, X, Y, rows, O, R;
  float xsc, ysc;         // f32(0.5 (X - 1)), f32(0.5 (Y - 1))
  float thr;              // f32(1 - ert_threshold): the gate T > thr
  float ambient, diffuse, specular, shininess;
};

// A block: 16 columns (threadIdx.x, the slab's y) by 8 rows (threadIdx.y,
// its x); a warp's 16 columns step along y together and share cache lines.
constexpr int kCols = 16;
constexpr int kRows = 8;
constexpr int kThreads = kCols * kRows;

// A sample whose f = 1 - a is below this starts a new segment in K9 (as
// in K2): the division's error is at most ~1/kRestartBelow ulps of the
// pixel's sum.  Below the default gate's 0.01, so with the default
// ert_threshold only a pixel's last sample can have such an f.
constexpr float kRestartBelow = 1.0f / 128.0f;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.rsqrt on the CPU: 1 / sqrt(x), each correctly rounded.
__device__ __forceinline__ float inv_sqrt(float x) {
  return __fdiv_rn(1.0f, __fsqrt_rn(x));
}

// a.b summed left to right, unfused.
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return add_rn(add_rn(mul_rn(ax, bx), mul_rn(ay, by)), mul_rn(az, bz));
}

// x * wx + y * wy per channel, unfused.
__device__ __forceinline__ float4 lerp4(float4 x, float wx, float4 y,
                                        float wy) {
  return make_float4(add_rn(mul_rn(x.x, wx), mul_rn(y.x, wy)),
                     add_rn(mul_rn(x.y, wx), mul_rn(y.y, wy)),
                     add_rn(mul_rn(x.z, wx), mul_rn(y.z, wy)),
                     add_rn(mul_rn(x.w, wx), mul_rn(y.w, wy)));
}

// d max(x, 0)/dx, and d min(x, 1)/dx, with torch's and JAX's convention:
// half at the tie.
__device__ __forceinline__ float max0_slope(float x) {
  return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
}
__device__ __forceinline__ float min1_slope(float x) {
  return x < 1.0f ? 1.0f : (x == 1.0f ? 0.5f : 0.0f);
}

// The VJP of x^e for the cotangent g, 0 wherever g is 0 (fastpath's _Pow):
// g * (e * x^(e - 1)), the slope 0 at e = 0.
__device__ __forceinline__ float pow_vjp(float g, float x, float e) {
  if (g == 0.0f) return 0.0f;
  return g * (e == 0.0f ? 0.0f : e * powf(x, e - 1.0f));
}

// Plane zw's scale about the camera at depth lz: the ray through grid
// coordinate g crosses it at l + sz (g - l).
__device__ __forceinline__ float plane_scale(float zw, float lz) {
  return __fdiv_rn(sub_rn(zw, lz), sub_rn(0.0f, lz));
}
__device__ __forceinline__ float crossing(float l, float sz, float d) {
  return add_rn(l, mul_rn(sz, d));
}
// A crossing's voxel coordinate along an axis of sc = f32(0.5 (size - 1)).
__device__ __forceinline__ float voxel_coord(float c, float sc) {
  return mul_rn(add_rn(c, 1.0f), sc);
}

// The two taps of a 1-D linear resample at voxel coordinate src along an
// axis of `size` voxels (ops/shear_warp.py::_lerp_taps): lo, hi = min(lo +
// 1, size - 1) and the weights 1 - frac, frac, both 0 outside [0, size - 1].
struct Taps {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Taps lerp_taps(float src, int size) {
  const float lo_f = floorf(src);
  const float frac = sub_rn(src, lo_f);
  const bool inside = src >= 0.0f && src <= (float)(size - 1);
  Taps t;
  t.lo = (int)fminf(fmaxf(lo_f, 0.0f), (float)(size - 1));
  t.hi = min(t.lo + 1, size - 1);
  t.w_lo = inside ? sub_rn(1.0f, frac) : 0.0f;
  t.w_hi = inside ? frac : 0.0f;
  return t;
}

// The run of s in [0, S) where q holds, for q monotone in s: {first, last},
// or {S, -1} where it never holds.
template <class Pred>
__device__ __forceinline__ int2 monotone_run(int S, Pred q) {
  const bool q0 = q(0);
  if (q0 == q(S - 1)) return q0 ? make_int2(0, S - 1) : make_int2(S, -1);
  int lo = 0, hi = S - 1;   // q(lo) == q0 != q(hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (q(mid) == q0) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return q0 ? make_int2(0, lo) : make_int2(hi, S - 1);
}

// The planes where the ray through grid coordinate l + d crosses inside [0,
// size - 1] along one axis, with lerp_taps' rounding: {first, last}, first
// > last where there is none.  The coordinate is monotone in s (see the
// note at the top), so each bound is one monotone run.
__device__ int2 footprint_interval(const ShearWarpArgs& a, float l, float lz,
                                   float d, float sc, int size) {
  const float top = (float)(size - 1);
  auto src = [&](int s) {
    return voxel_coord(crossing(l, plane_scale(__ldg(a.zws + s), lz), d), sc);
  };
  const int2 lo = monotone_run(a.S, [&](int s) { return src(s) >= 0.0f; });
  const int2 hi = monotone_run(a.S, [&](int s) { return src(s) <= top; });
  return make_int2(max(lo.x, hi.x), min(lo.y, hi.y));
}

// Warp 0 (lanes 0-23): the footprint intervals of the block's 8 rows and
// 16 columns, into shared memory (the block's prologue).
__device__ void block_intervals(const ShearWarpArgs& a, int2* iv_x,
                                int2* iv_y) {
  const int lane = threadIdx.x + kCols * threadIdx.y;
  const float lx = __ldg(a.lf), ly = __ldg(a.lf + 1), lz = __ldg(a.lf + 2);
  if (lane < kRows) {
    const int r = blockIdx.y * kRows + lane;
    iv_x[lane] = r < a.rows
                     ? footprint_interval(a, lx, lz,
                                          sub_rn(__ldg(a.ga + r), lx),
                                          a.xsc, a.X)
                     : make_int2(a.S, -1);
  } else if (lane < kRows + kCols) {
    const int o = blockIdx.x * kCols + lane - kRows;
    iv_y[lane - kRows] = o < a.O
                             ? footprint_interval(a, ly, lz,
                                                  sub_rn(__ldg(a.gb + o), ly),
                                                  a.ysc, a.Y)
                             : make_int2(a.S, -1);
  }
}

// The pixel's planes: its row's interval and its column's, intersected.
__device__ __forceinline__ int2 pixel_interval(const int2* iv_x,
                                               const int2* iv_y) {
  const int2 x = iv_x[threadIdx.y], y = iv_y[threadIdx.x];
  return make_int2(max(x.x, y.x), min(x.y, y.y));
}

// Slab texel (x, y) of the plane between layers zlo and zhi, from global
// memory: lo (1 - fz) + hi fz.
__device__ __forceinline__ float4 slab_texel(const ShearWarpArgs& a, int zlo,
                                             int zhi, float omf, float fz,
                                             int x, int y) {
  const long long plane = (long long)a.X * a.Y;
  const long long t = (long long)x * a.Y + y;
  const float4* L = reinterpret_cast<const float4*>(a.layers);
  return lerp4(__ldg(L + zlo * plane + t), omf, __ldg(L + zhi * plane + t),
               fz);
}

// The separable resample at the taps: along x, then along y.
template <class Fetch>
__device__ __forceinline__ float4 resample(const Taps& tx, const Taps& ty,
                                          Fetch f) {
  const float4 lo = lerp4(f(tx.lo, ty.lo), tx.w_lo, f(tx.hi, ty.lo), tx.w_hi);
  const float4 hi = lerp4(f(tx.lo, ty.hi), tx.w_lo, f(tx.hi, ty.hi), tx.w_hi);
  return lerp4(lo, ty.w_lo, hi, ty.w_hi);
}

// What a pixel keeps across its march.
struct Pixel {
  float lx, ly, lz;   // the camera
  float hx, hy, hz;   // the headlight
  float dxr, dyr;     // ga - lx, gb - ly
  float e;            // the opacity correction's exponent
};

__device__ __forceinline__ Pixel load_pixel(const ShearWarpArgs& a, int r,
                                            int o) {
  Pixel p;
  p.lx = __ldg(a.lf);
  p.ly = __ldg(a.lf + 1);
  p.lz = __ldg(a.lf + 2);
  p.hx = __ldg(a.light);
  p.hy = __ldg(a.light + 1);
  p.hz = __ldg(a.light + 2);
  p.dxr = sub_rn(__ldg(a.ga + r), p.lx);
  p.dyr = sub_rn(__ldg(a.gb + o), p.ly);
  p.e = __ldg(a.exponent + (long long)r * a.O + o);
  return p;
}

// The headlight terms of a sample at (px, py, pz) with gradient g
// (fastpath.py::_shade), kept for the backward.
struct Shading {
  bool has_n;
  float nx, ny, nz;    // the unit normal (0 without a gradient)
  float ux, uy, uz;    // the unit light direction
  float vx, vy, vz;    // the unit view direction
  float dot;           // n.l
  float q;             // -(r.v)
  float light_raw;     // diffuse + specular + ambient
};

__device__ __forceinline__ Shading shade_terms(const ShearWarpArgs& a,
                                               const Pixel& p, float px,
                                               float py, float pz, float gx,
                                               float gy, float gz) {
  Shading h;
  const float g2 = dot3(gx, gy, gz, gx, gy, gz);
  h.has_n = g2 > 0.0f;
  const float m = h.has_n ? inv_sqrt(g2) : 0.0f;
  h.nx = mul_rn(gx, m);
  h.ny = mul_rn(gy, m);
  h.nz = mul_rn(gz, m);
  const float lx = sub_rn(px, p.hx), ly = sub_rn(py, p.hy),
              lz = sub_rn(pz, p.hz);
  const float lm = inv_sqrt(fmaxf(dot3(lx, ly, lz, lx, ly, lz), 1e-30f));
  h.ux = mul_rn(lx, lm);
  h.uy = mul_rn(ly, lm);
  h.uz = mul_rn(lz, lm);
  h.dot = dot3(h.nx, h.ny, h.nz, h.ux, h.uy, h.uz);
  const float diffuse =
      mul_rn(a.diffuse, h.has_n ? fmaxf(h.dot, 0.0f) : 0.0f);
  const float d2 = mul_rn(2.0f, h.dot);
  const float rx = sub_rn(h.ux, mul_rn(d2, h.nx)),
              ry = sub_rn(h.uy, mul_rn(d2, h.ny)),
              rz = sub_rn(h.uz, mul_rn(d2, h.nz));
  const float vx = sub_rn(px, p.lx), vy = sub_rn(py, p.ly),
              vz = sub_rn(pz, p.lz);
  const float vm = inv_sqrt(fmaxf(dot3(vx, vy, vz, vx, vy, vz), 1e-30f));
  h.vx = mul_rn(vx, vm);
  h.vy = mul_rn(vy, vm);
  h.vz = mul_rn(vz, vm);
  h.q = -dot3(rx, ry, rz, h.vx, h.vy, h.vz);
  const float specular = mul_rn(
      a.specular, h.has_n ? powf(fmaxf(h.q, 0.0f), a.shininess) : 0.0f);
  h.light_raw = add_rn(add_rn(diffuse, specular), a.ambient);
  return h;
}

// One slab sample of a pixel, as the plain version's chunk computes it.
struct SlabSample {
  Taps tx, ty;
  float4 v;            // resampled intensity and gradient
  float px, py, pz;    // the position on the plane
  float cov;           // the footprint coverage
  float4 c;            // the TF colour
  float alpha;         // opacity-corrected alpha times the coverage
  float3 rgb;          // premultiplied shaded colour
  Shading h;           // the headlight terms, for K9's backward
};

// The sample at crossing (px, py, zw) with taps tx, ty and resampled
// channels v: coverage, classification, shading and opacity.
template <bool kGlobalTf>
__device__ __forceinline__ SlabSample shade_sample(
    const ShearWarpArgs& a, const float4* tf, const Pixel& p, float zw,
    float px, float py, const Taps& tx, const Taps& ty, float4 v) {
  SlabSample q;
  q.tx = tx;
  q.ty = ty;
  q.v = v;
  q.px = px;
  q.py = py;
  q.pz = zw;
  q.cov = mul_rn(add_rn(tx.w_lo, tx.w_hi), add_rn(ty.w_lo, ty.w_hi));
  q.c = tf_lerp<kGlobalTf, true>(tf, a.R, q.v.x);
  q.h = shade_terms(a, p, q.px, q.py, q.pz, q.v.y, q.v.z, q.v.w);
  const float lightf = fminf(q.h.light_raw, 1.0f);
  const float mm = fmaxf(sub_rn(1.0f, q.c.w), 0.0f);
  q.alpha = mul_rn(sub_rn(1.0f, powf(mm, p.e)), q.cov);
  q.rgb = make_float3(mul_rn(mul_rn(lightf, q.c.x), q.alpha),
                      mul_rn(mul_rn(lightf, q.c.y), q.alpha),
                      mul_rn(mul_rn(lightf, q.c.z), q.alpha));
  return q;
}

// Plane s's sample of a pixel: the crossing, the taps, the z-lerp of the
// taps' texels from the layers, the resample and shade_sample.
template <bool kGlobalTf>
__device__ __forceinline__ SlabSample sample_at(const ShearWarpArgs& a,
                                                const float4* tf,
                                                const Pixel& p, int s) {
  const float zw = __ldg(a.zws + s);
  const float sz = plane_scale(zw, p.lz);
  const float px = crossing(p.lx, sz, p.dxr);
  const float py = crossing(p.ly, sz, p.dyr);
  const Taps tx = lerp_taps(voxel_coord(px, a.xsc), a.X);
  const Taps ty = lerp_taps(voxel_coord(py, a.ysc), a.Y);
  const int zlo = __ldg(a.zlo + s), zhi = __ldg(a.zhi + s);
  const float fz = __ldg(a.fz + s), omf = sub_rn(1.0f, fz);
  const float4 v = resample(tx, ty, [&](int x, int y) {
    return slab_texel(a, zlo, zhi, omf, fz, x, y);
  });
  return shade_sample<kGlobalTf>(a, tf, p, zw, px, py, tx, ty, v);
}

template <bool kGlobalTf>
__global__ void __launch_bounds__(kThreads) shear_warp_fwd_kernel(
    ShearWarpArgs a) {
  extern __shared__ float4 s_tf[];
  __shared__ int2 iv_x[kRows], iv_y[kCols];
  if (threadIdx.x + kCols * threadIdx.y < 32) block_intervals(a, iv_x, iv_y);
  const float4* tf =
      stage_tf<kGlobalTf>(reinterpret_cast<const float4*>(a.tf), a.R, s_tf);
  __syncthreads();
  const int o = blockIdx.x * kCols + threadIdx.x;
  const int r = blockIdx.y * kRows + threadIdx.y;
  if (o >= a.O || r >= a.rows) return;
  const Pixel p = load_pixel(a, r, o);
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  float T = 1.0f;
  int stop = 1.0f > a.thr ? a.S : 0, taken = 0;
  if (stop > 0) {
    const int2 iv = pixel_interval(iv_x, iv_y);
    for (int s = iv.x; s <= iv.y; ++s) {
      const SlabSample q = sample_at<kGlobalTf>(a, tf, p, s);
      acc.x = add_rn(acc.x, mul_rn(T, q.rgb.x));
      acc.y = add_rn(acc.y, mul_rn(T, q.rgb.y));
      acc.z = add_rn(acc.z, mul_rn(T, q.rgb.z));
      T = mul_rn(T, sub_rn(1.0f, q.alpha));
      ++taken;
      if (!(T > a.thr)) {
        stop = s + 1;
        break;
      }
    }
  }
  const long long px = (long long)r * a.O + o;
  reinterpret_cast<float4*>(a.inter)[px] =
      make_float4(acc.x, acc.y, acc.z, sub_rn(1.0f, T));
  if (a.steps) a.steps[px] = stop;
  if (a.taken) a.taken[px] = taken;
}

// U, the whole sum behind sample s, for a sample whose f is below
// kRestartBelow: the rest of the pixel's footprint (planes s + 1 to last)
// once more with a local transmittance from 1, under the gate on the real
// one (which starts at Tn).  Planes beyond the footprint add nothing.
template <bool kGlobalTf>
__device__ __forceinline__ float rest_of_march(const ShearWarpArgs& a,
                                               const float4* tf,
                                               const Pixel& p, int s,
                                               int last, float Tn, float4 g) {
  float Ur = 0.0f, Tl = 1.0f, Tr = Tn;
  for (int s2 = s + 1; s2 <= last; ++s2) {
    if (!(Tr > a.thr)) break;
    const SlabSample q = sample_at<kGlobalTf>(a, tf, p, s2);
    Ur += Tl * (g.x * q.rgb.x + g.y * q.rgb.y + g.z * q.rgb.z);
    const float f = sub_rn(1.0f, q.alpha);
    Tl *= f;
    Tr = mul_rn(Tr, f);
    if (Tl == 0.0f) break;
  }
  return Ur - g.w * Tl;
}

// Backward of one sample's shading, opacity and coverage for the
// cotangents d_rgb of its premultiplied colour and d_alpha of its alpha:
// returns the cotangent of the TF colour and writes that of the gradient.
__device__ __forceinline__ float4 sample_bwd(const ShearWarpArgs& a,
                                             const Pixel& p,
                                             const SlabSample& q,
                                             float3 d_rgb, float d_alpha,
                                             float3& d_g) {
  const Shading& h = q.h;
  const float lightf = fminf(h.light_raw, 1.0f);
  // rgb_k = (light c_k) alpha
  d_alpha += d_rgb.x * (lightf * q.c.x) + d_rgb.y * (lightf * q.c.y) +
             d_rgb.z * (lightf * q.c.z);
  const float dlx = d_rgb.x * q.alpha, dly = d_rgb.y * q.alpha,
              dlz = d_rgb.z * q.alpha;
  float4 d_c;
  d_c.x = dlx * lightf;
  d_c.y = dly * lightf;
  d_c.z = dlz * lightf;
  const float d_light = dlx * q.c.x + dly * q.c.y + dlz * q.c.z;
  // alpha = (1 - mm^e) cov, mm = max(1 - c.a, 0)
  const float m1 = sub_rn(1.0f, q.c.w);
  const float d_mm = pow_vjp(-(d_alpha * q.cov), fmaxf(m1, 0.0f), p.e);
  d_c.w = -(d_mm * max0_slope(m1));
  d_g = make_float3(0.0f, 0.0f, 0.0f);
  if (!h.has_n) return d_c;     // no normal: only the ambient light
  const float d_raw = d_light * min1_slope(h.light_raw);
  // specular = ks max(q, 0)^shininess, q = -(r.v)
  const float rdv = fmaxf(h.q, 0.0f);
  const float d_q =
      pow_vjp(a.specular * d_raw, rdv, a.shininess) * max0_slope(h.q);
  const float drx = -d_q * h.vx, dry = -d_q * h.vy, drz = -d_q * h.vz;
  // diffuse = kd max(n.l, 0) and r = l - 2 (n.l) n
  const float d_dot = a.diffuse * d_raw * max0_slope(h.dot) -
                      2.0f * (drx * h.nx + dry * h.ny + drz * h.nz);
  const float d2 = 2.0f * h.dot;
  const float dnx = d_dot * h.ux - d2 * drx, dny = d_dot * h.uy - d2 * dry,
              dnz = d_dot * h.uz - d2 * drz;
  // The unit normal's VJP, clamped at |g| = 1e-6 (shading.py::_UnitNormal).
  const float gx = q.v.y, gy = q.v.z, gz = q.v.w;
  const float inv = 1.0f / fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-6f);
  const float vn = dnx * h.nx + dny * h.ny + dnz * h.nz;
  d_g = make_float3((dnx - vn * h.nx) * inv, (dny - vn * h.ny) * inv,
                    (dnz - vn * h.nz) * inv);
  return d_c;
}

__device__ __forceinline__ float4 scale4(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

__device__ __forceinline__ float4 sum4(float4 u, float4 v) {
  return make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
}

__device__ __forceinline__ bool nonzero4(float4 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

// A sample's channel cotangents dv at its taps: the y lerp's weights, then
// the x lerp's, as the resample's VJP; taps on one voxel (hi == lo at the
// clamped edge) merged into one.  Calls add(x, y, t) per distinct tap.
template <class Add>
__device__ __forceinline__ void scatter_taps(const SlabSample& q, float4 dv,
                                             Add add) {
  float4 y_lo = scale4(dv, q.ty.w_lo), y_hi = scale4(dv, q.ty.w_hi);
  const bool one_y = q.ty.hi == q.ty.lo, one_x = q.tx.hi == q.tx.lo;
  if (one_y) y_lo = sum4(y_lo, y_hi);
  float4 t00 = scale4(y_lo, q.tx.w_lo), t10 = scale4(y_lo, q.tx.w_hi);
  float4 t01 = scale4(y_hi, q.tx.w_lo), t11 = scale4(y_hi, q.tx.w_hi);
  if (one_x) {
    t00 = sum4(t00, t10);
    t01 = sum4(t01, t11);
  }
  add(q.tx.lo, q.ty.lo, t00);
  if (!one_x) add(q.tx.hi, q.ty.lo, t10);
  if (!one_y) {
    add(q.tx.lo, q.ty.hi, t01);
    if (!one_x) add(q.tx.hi, q.ty.hi, t11);
  }
}

// A slab cotangent t at texel (x, y) of the plane between layers zlo and
// zhi, into d_layers: the z-lerp's transpose, one vector atomic a layer
// (NaN counts as non-zero, so 0 * inf still reaches d_layers as in
// autograd).
__device__ __forceinline__ void add_to_layers(const ShearWarpArgs& a, int zlo,
                                              int zhi, float omf, float fz,
                                              int x, int y, float4 t) {
  const long long plane = (long long)a.X * a.Y;
  const long long i = (long long)x * a.Y + y;
  float4* D = reinterpret_cast<float4*>(a.d_layers);
  const float4 lo = scale4(t, omf), hi = scale4(t, fz);
  if (nonzero4(lo)) atomicAdd(D + zlo * plane + i, lo);
  if (nonzero4(hi)) atomicAdd(D + zhi * plane + i, hi);
}

// A run of a pixel's d_tf terms on one texel, summed in registers and added
// to the block's d_tf when the texel changes: in empty space every sample
// adds its alpha cotangent to texel 0, and as shared atomics the lanes of
// a warp on one address serialise.
struct TfRun {
  int texel;      // -1: empty
  float4 sum;
};

__device__ __forceinline__ void add_tf_terms(float* d, float4 v) {
  if (v.x != 0.0f) atomicAdd(d, v.x);
  if (v.y != 0.0f) atomicAdd(d + 1, v.y);
  if (v.z != 0.0f) atomicAdd(d + 2, v.z);
  if (v.w != 0.0f) atomicAdd(d + 3, v.w);
}

__device__ __forceinline__ void flush_run(float* acc, const TfRun& run) {
  if (run.texel >= 0) add_tf_terms(acc + 4 * run.texel, run.sum);
}

// tf_lerp_bwd with the dot mask (kTfGradFracPositive), the low texel's
// terms summed in the pixel's run.
template <bool kGlobalTf>
__device__ __forceinline__ float tf_lerp_bwd_run(const float4* tf, int R,
                                                 float intensity, float4 g,
                                                 float* acc, TfRun& run) {
  const float t = fmaxf(intensity * (float)(R - 1), 0.0f);
  const float low_f = floorf(t);
  const float frac = t - low_f;
  const int low = (int)fminf(low_f, (float)(R - 1));
  const int high = min(low + 1, R - 1);
  const float w = 1.0f - frac;
  if (w != 0.0f) {
    const float4 v = scale4(g, w);
    if (low == run.texel) {
      run.sum = sum4(run.sum, v);
    } else {
      flush_run(acc, run);
      run.texel = low;
      run.sum = v;
    }
  }
  if (frac == 0.0f) return 0.0f;
  add_tf_terms(acc + 4 * high, scale4(g, frac));
  // Rounded step by step, unfused, as tf_lerp_bwd (tf_lerp.cuh).
  const float4 a = tf_texel<kGlobalTf>(tf, low);
  const float4 b = tf_texel<kGlobalTf>(tf, high);
  float slope = __fmul_rn(b.x - a.x, g.x);
  slope = __fadd_rn(slope, __fmul_rn(b.y - a.y, g.y));
  slope = __fadd_rn(slope, __fmul_rn(b.z - a.z, g.z));
  slope = __fadd_rn(slope, __fmul_rn(b.w - a.w, g.w));
  return __fmul_rn(slope, (float)(R - 1));
}

// Held to 128 registers, 4 blocks of 128 threads per SM, as K2.
template <bool kGlobalTf>
__global__ void __launch_bounds__(kThreads, 4)
    shear_warp_bwd_kernel(ShearWarpArgs a) {
  extern __shared__ float4 s_tf[];
  __shared__ int2 iv_x[kRows], iv_y[kCols];
  if (threadIdx.x + kCols * threadIdx.y < 32) block_intervals(a, iv_x, iv_y);
  const float4* tf =
      stage_tf<kGlobalTf>(reinterpret_cast<const float4*>(a.tf), a.R, s_tf);
  float* acc = kGlobalTf ? a.d_tf : reinterpret_cast<float*>(s_tf + a.R);
  if (!kGlobalTf) zero_tf_grad(acc, a.R);
  __syncthreads();

  const int o = blockIdx.x * kCols + threadIdx.x;
  const int r = blockIdx.y * kRows + threadIdx.y;
  const bool valid = o < a.O && r < a.rows;
  const long long px = valid ? (long long)r * a.O + o : 0;
  const float4 g = valid ? reinterpret_cast<const float4*>(a.grad)[px]
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int restarts = 0;
  // A pixel whose cotangent is 0 adds nothing anywhere (every power's VJP
  // meets a zero cotangent).
  if (nonzero4(g) && 1.0f > a.thr) {
    const Pixel p = load_pixel(a, r, o);
    const int2 iv = pixel_interval(iv_x, iv_y);
    const float4 img = reinterpret_cast<const float4*>(a.inter)[px];
    // Segment state: base transmittance, the whole sum behind the
    // segment's start, local transmittance and the prefix of that sum.
    float U = g.x * img.x + g.y * img.y + g.z * img.z - g.w * (1.0f - img.w);
    float Tb = 1.0f, Tloc = 1.0f, P = 0.0f, T = 1.0f;
    TfRun run = {-1, make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    for (int s = iv.x; s <= iv.y; ++s) {
      if (!(T > a.thr) || T == 0.0f) break;
      const SlabSample q = sample_at<kGlobalTf>(a, tf, p, s);
      const float f = sub_rn(1.0f, q.alpha);
      const float Tn = mul_rn(T, f);
      const bool last = s + 1 == a.S || !(Tn > a.thr);
      float d_a;
      if (last) {
        d_a = T * g.w;
      } else if (f < kRestartBelow) {
        const float Ur = rest_of_march<kGlobalTf>(a, tf, p, s, iv.y, Tn, g);
        ++restarts;
        d_a = -T * Ur;
        Tb = Tn;
        U = Ur;
        P = 0.0f;
        Tloc = 1.0f;
      } else {
        P += Tloc * (g.x * q.rgb.x + g.y * q.rgb.y + g.z * q.rgb.z);
        d_a = -(Tb / f) * (U - P);
        Tloc *= f;
      }
      float3 d_g;
      const float4 d_c = sample_bwd(
          a, p, q, make_float3(T * g.x, T * g.y, T * g.z), d_a, d_g);
      const float d_int =
          tf_lerp_bwd_run<kGlobalTf>(tf, a.R, q.v.x, d_c, acc, run);
      const int zlo = __ldg(a.zlo + s), zhi = __ldg(a.zhi + s);
      const float fz = __ldg(a.fz + s), omf = sub_rn(1.0f, fz);
      scatter_taps(q, make_float4(d_int, d_g.x, d_g.y, d_g.z),
                   [&](int x, int y, float4 t) {
                     add_to_layers(a, zlo, zhi, omf, fz, x, y, t);
                   });
      T = Tn;
    }
    flush_run(acc, run);
  }
  if (valid && a.restarts) a.restarts[px] = restarts;
  if (!kGlobalTf) flush_tf_grad(acc, a.R, a.d_tf);
}

static dim3 tiles(const ShearWarpArgs& a) {
  return dim3((a.O + kCols - 1) / kCols, (a.rows + kRows - 1) / kRows);
}

extern "C" int dr_shear_warp_fwd(const ShearWarpArgs* a, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->rows <= 0 || a->O <= 0) return 0;
  const dim3 block(kCols, kRows);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->R <= kMaxSharedTexels) {
    shear_warp_fwd_kernel<false>
        <<<tiles(*a), block, a->R * sizeof(float4), s>>>(*a);
  } else {
    shear_warp_fwd_kernel<true><<<tiles(*a), block, 0, s>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" int dr_shear_warp_bwd(const ShearWarpArgs* a, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->rows <= 0 || a->O <= 0) return 0;
  const dim3 block(kCols, kRows);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->R <= kMaxSharedTexels) {
    shear_warp_bwd_kernel<false>
        <<<tiles(*a), block, 2 * a->R * sizeof(float4), s>>>(*a);
  } else {
    shear_warp_bwd_kernel<true><<<tiles(*a), block, 0, s>>>(*a);
  }
  return (int)cudaGetLastError();
}
