// K8 shear_warp_fwd and K9 shear_warp_bwd: the shear-warp slab march of the
// fast path (fastpath.py), forward and backward, one thread per pixel of the
// intermediate image, in 16x8 tiles over (rows, O).
//
// Replaces the JAX package's slab scan, XLA code with no Pallas in it:
// differender_tpu/fastpath.py::_core, its remat'd scan step slab_fn (:255)
// with shade_slab (:171) under slab_step's alive test (:291), and JAX's AD
// of that scan.  On the TPU the resample is two hat-matrix products on the
// matrix unit and the scan takes slab_batch slabs a step.  The port's plain
// version, ops/shear_warp.py::shear_warp_march_plain, runs the same
// arithmetic as chunks of torch operations, about a hundred launches and a
// host sync per chunk of 32 slabs.
//
// What it computes.  The caller z-lerps the slab stack (S, X, Y, 4): plane
// s's intensity and gradient at z = zws[s], in the frame where the camera
// lf sits on the negative side of the last axis.  Pixel (r, o) is the ray
// through (ga[r], gb[o], 0).  Per plane, front to back, the thread forms
// the ray's crossing, takes the 2x2 taps of the separable lerp (the rows of
// the JAX package's _interp_matrix: weights 0 outside [0, size - 1]),
// resamples the 4 channels along x and then along y as _resample does, one
// 16-byte load per tap, classifies through the TF (tf_lerp, the TF staged
// in shared memory), shades with the headlight and corrects the opacity
// with the pixel's exponent, weighs by the footprint coverage and
// composites under the gate T > thr.  A thread stops at its first plane
// with T <= thr: every later plane is an exact no-op in the plain version,
// which tests the gate sample by sample (so slab_batch, the plain version's
// chunk length, does not exist here).
//
// Rounding.  The coverage jumps from 0 to 1 at the footprint's edge, a
// tap's index moves at an integer source position, and the backward's dot
// mask (frac > 0) depends on the exact intensity.  So positions, taps,
// lerps, shading sums and the composite are computed unfused, each
// operation rounded once in the plain version's order (__fmul_rn /
// __fadd_rn are never contracted into an FMA), and 1/sqrt is a correctly
// rounded square root and division, as torch.rsqrt rounds on the CPU.
// powf is CUDA's, as torch.pow's on the card.
//
// K9 recomputes and keeps no tape: K2's scheme (march_bwd.cu).  It reads
// K8's output (rgb_F, 1 - T_F) and walks front to back again through K8's
// own device functions, so it takes bitwise K8's samples and gate
// decisions.  Per sample dL/dc_s = T_s g.rgb and dL/da_s = -(T_b/f_s)(U -
// P_s) within a segment that starts at transmittance T_b with U its whole
// sum behind; a sample with f_s < kRestartBelow marches the rest of its ray
// once more from a local transmittance of 1 and starts a new segment, and
// the last composited sample takes the exact U = -g.a, so a TF alpha of
// exactly 1 gives no 0/0.  It pulls the cotangents through the coverage,
// the opacity correction's power (its VJP 0 wherever its cotangent is 0, as
// fastpath's _Pow), min(1, light) and max(n.l, 0) (half at a tie, as torch
// and JAX take it), the specular power, the clamped unit-normal VJP and the
// TF lerp with the dot mask (tf_lerp_bwd, frac > 0: the VJP of JAX's
// apply_tf_dot).  Each sample's 4 channel cotangents go to its up to 4 taps
// in d_slabs with one atomicAdd per non-zero channel of each distinct tap
// (taps on one voxel at the clamped edge merged); d_tf is summed per block
// in shared memory and flushed once per block (flush_tf_grad).
//
// Bound on the H100.  Bytes: the slab texels the marched samples need,
// each read once (at most the whole stack, S X Y 16 B: 537 MB at 512
// planes of 256^2, 0.16 ms at 3.35 TB/s) and, for K9, d_slabs written once
// on them.  Operations: ~180 f32 operations a marched sample in K8, ~2.4x
// that in K9, over the samples the gate lets through; chip_smoke.py counts
// both, and at the bench view the operations bound.  In practice the time
// goes to the dependent chain of each sample (two powf, three square roots
// and divisions) and, in K9, to the atomics, ~16 per sample on taps that
// neighbouring pixels share.  What
// the design does about it: the slab stack is channels-last, so a tap is
// one float4 load; a warp's 16 columns step along y together and share
// cache lines; the march stops at the gate; no tape is written, so the
// backward holds only the slab stack, the TF and the (rows, O, 4) image.
// A first, simple kernel: no shared-memory slab tiles, TMA or warp
// specialisation yet.
#include <cuda_runtime.h>

#include "tf_lerp.cuh"

// Mirrored field for field by differender_tpu_torch/ops/shear_warp.py::
// _ShearWarpArgs.
struct ShearWarpArgs {
  const float* slabs;     // (S, X, Y, 4): each plane's intensity, gradient
  const float* tf;        // (R, 4)
  const float* ga;        // (rows,): the grid's x of each row computed
  const float* gb;        // (O,): the grid's y of each column
  const float* zws;       // (S,): each plane's z
  const float* exponent;  // (rows, O): the opacity correction's exponent
  const float* lf;        // (3,): the camera, in the slab frame
  const float* light;     // (3,): the headlight, in the slab frame
  float* inter;           // (rows, O, 4): K8 writes it, K9 reads it
  int* steps;             // (rows, O) or null: K8's marched samples a pixel
  const float* grad;      // (rows, O, 4): K9's cotangent of inter
  float* d_slabs;         // (S, X, Y, 4), zeroed by the caller (K9)
  float* d_tf;            // (R, 4), zeroed by the caller (K9)
  int S, X, Y, rows, O, R;
  float xsc, ysc;         // f32(0.5 (X - 1)), f32(0.5 (Y - 1))
  float thr;              // f32(1 - ert_threshold): the gate T > thr
  float ambient, diffuse, specular, shininess;
};

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

// The two taps of a 1-D linear resample at voxel coordinate src along an
// axis of `size` voxels (fastpath.py::_lerp_taps): lo, hi = min(lo + 1,
// size - 1) and the weights 1 - frac, frac, both 0 outside [0, size - 1].
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
};

template <bool kGlobalTf>
__device__ __forceinline__ SlabSample slab_sample(const ShearWarpArgs& a,
                                                  const float4* tf,
                                                  const Pixel& p, int s) {
  SlabSample q;
  const float zw = __ldg(a.zws + s);
  const float sz = __fdiv_rn(sub_rn(zw, p.lz), sub_rn(0.0f, p.lz));
  q.px = add_rn(p.lx, mul_rn(sz, p.dxr));
  q.py = add_rn(p.ly, mul_rn(sz, p.dyr));
  q.pz = zw;
  q.tx = lerp_taps(mul_rn(add_rn(q.px, 1.0f), a.xsc), a.X);
  q.ty = lerp_taps(mul_rn(add_rn(q.py, 1.0f), a.ysc), a.Y);
  const float4* sl =
      reinterpret_cast<const float4*>(a.slabs) + (long long)s * a.X * a.Y;
  const long long row_lo = (long long)q.tx.lo * a.Y,
                  row_hi = (long long)q.tx.hi * a.Y;
  const float4 lo = lerp4(__ldg(sl + row_lo + q.ty.lo), q.tx.w_lo,
                          __ldg(sl + row_hi + q.ty.lo), q.tx.w_hi);
  const float4 hi = lerp4(__ldg(sl + row_lo + q.ty.hi), q.tx.w_lo,
                          __ldg(sl + row_hi + q.ty.hi), q.tx.w_hi);
  q.v = lerp4(lo, q.ty.w_lo, hi, q.ty.w_hi);
  q.cov = mul_rn(add_rn(q.tx.w_lo, q.tx.w_hi), add_rn(q.ty.w_lo, q.ty.w_hi));
  q.c = tf_lerp<kGlobalTf, true>(tf, a.R, q.v.x);
  const Shading h = shade_terms(a, p, q.px, q.py, q.pz, q.v.y, q.v.z, q.v.w);
  const float lightf = fminf(h.light_raw, 1.0f);
  const float mm = fmaxf(sub_rn(1.0f, q.c.w), 0.0f);
  q.alpha = mul_rn(sub_rn(1.0f, powf(mm, p.e)), q.cov);
  q.rgb = make_float3(mul_rn(mul_rn(lightf, q.c.x), q.alpha),
                      mul_rn(mul_rn(lightf, q.c.y), q.alpha),
                      mul_rn(mul_rn(lightf, q.c.z), q.alpha));
  return q;
}

template <bool kGlobalTf>
__global__ void __launch_bounds__(128) shear_warp_fwd_kernel(ShearWarpArgs a) {
  extern __shared__ float4 s_tf[];
  const float4* tf =
      stage_tf<kGlobalTf>(reinterpret_cast<const float4*>(a.tf), a.R, s_tf);
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (o >= a.O || r >= a.rows) return;
  const Pixel p = load_pixel(a, r, o);
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  float T = 1.0f;
  int s = 0;
  for (; s < a.S; ++s) {
    if (!(T > a.thr)) break;
    const SlabSample q = slab_sample<kGlobalTf>(a, tf, p, s);
    acc.x = add_rn(acc.x, mul_rn(T, q.rgb.x));
    acc.y = add_rn(acc.y, mul_rn(T, q.rgb.y));
    acc.z = add_rn(acc.z, mul_rn(T, q.rgb.z));
    T = mul_rn(T, sub_rn(1.0f, q.alpha));
  }
  const long long px = (long long)r * a.O + o;
  reinterpret_cast<float4*>(a.inter)[px] =
      make_float4(acc.x, acc.y, acc.z, sub_rn(1.0f, T));
  if (a.steps) a.steps[px] = s;
}

// U, the whole sum behind sample s, for a sample whose f is below
// kRestartBelow: the rest of the pixel's march once more with a local
// transmittance from 1, under the gate on the real one (which starts at
// Tn).
template <bool kGlobalTf>
__device__ __forceinline__ float rest_of_march(const ShearWarpArgs& a,
                                               const float4* tf,
                                               const Pixel& p, int s,
                                               float Tn, float4 g) {
  float Ur = 0.0f, Tl = 1.0f, Tr = Tn;
  for (int s2 = s + 1; s2 < a.S; ++s2) {
    if (!(Tr > a.thr)) break;
    const SlabSample q = slab_sample<kGlobalTf>(a, tf, p, s2);
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
  const Shading h =
      shade_terms(a, p, q.px, q.py, q.pz, q.v.y, q.v.z, q.v.w);
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

__device__ __forceinline__ void add_tap(float* d, float4 v) {
  if (v.x != 0.0f) atomicAdd(d, v.x);
  if (v.y != 0.0f) atomicAdd(d + 1, v.y);
  if (v.z != 0.0f) atomicAdd(d + 2, v.z);
  if (v.w != 0.0f) atomicAdd(d + 3, v.w);
}

__device__ __forceinline__ float4 scale4(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

__device__ __forceinline__ float4 sum4(float4 u, float4 v) {
  return make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
}

// Adds a sample's channel cotangents dv to its taps in d_slabs: the y
// lerp's weights, then the x lerp's, as the resample's VJP; taps on one
// voxel (hi == lo at the clamped edge) merged into one.
__device__ __forceinline__ void scatter_taps(const ShearWarpArgs& a, int s,
                                             const SlabSample& q, float4 dv) {
  float4 y_lo = scale4(dv, q.ty.w_lo), y_hi = scale4(dv, q.ty.w_hi);
  const bool one_y = q.ty.hi == q.ty.lo, one_x = q.tx.hi == q.tx.lo;
  if (one_y) y_lo = sum4(y_lo, y_hi);
  float4 t00 = scale4(y_lo, q.tx.w_lo), t10 = scale4(y_lo, q.tx.w_hi);
  float4 t01 = scale4(y_hi, q.tx.w_lo), t11 = scale4(y_hi, q.tx.w_hi);
  if (one_x) {
    t00 = sum4(t00, t10);
    t01 = sum4(t01, t11);
  }
  float* base = a.d_slabs + (long long)s * a.X * a.Y * 4;
  const long long row_lo = (long long)q.tx.lo * a.Y,
                  row_hi = (long long)q.tx.hi * a.Y;
  add_tap(base + 4 * (row_lo + q.ty.lo), t00);
  if (!one_x) add_tap(base + 4 * (row_hi + q.ty.lo), t10);
  if (!one_y) {
    add_tap(base + 4 * (row_lo + q.ty.hi), t01);
    if (!one_x) add_tap(base + 4 * (row_hi + q.ty.hi), t11);
  }
}

// Held to 128 registers, 4 blocks of 128 threads per SM, as K2.
template <bool kGlobalTf>
__global__ void __launch_bounds__(128, 4)
    shear_warp_bwd_kernel(ShearWarpArgs a) {
  extern __shared__ float4 s_tf[];
  const float4* tf =
      stage_tf<kGlobalTf>(reinterpret_cast<const float4*>(a.tf), a.R, s_tf);
  float* acc = kGlobalTf ? a.d_tf : reinterpret_cast<float*>(s_tf + a.R);
  if (!kGlobalTf) zero_tf_grad(acc, a.R);

  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const long long px = (long long)r * a.O + o;
  const float4 g = o < a.O && r < a.rows
                       ? reinterpret_cast<const float4*>(a.grad)[px]
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // A pixel whose cotangent is 0 adds nothing anywhere (every power's VJP
  // meets a zero cotangent).
  if (g.x != 0.0f || g.y != 0.0f || g.z != 0.0f || g.w != 0.0f) {
    const Pixel p = load_pixel(a, r, o);
    const float4 img = reinterpret_cast<const float4*>(a.inter)[px];
    // Segment state: base transmittance, the whole sum behind the
    // segment's start, local transmittance and the prefix of that sum.
    float U = g.x * img.x + g.y * img.y + g.z * img.z - g.w * (1.0f - img.w);
    float Tb = 1.0f, Tloc = 1.0f, P = 0.0f, T = 1.0f;
    for (int s = 0; s < a.S; ++s) {
      if (!(T > a.thr) || T == 0.0f) break;
      const SlabSample q = slab_sample<kGlobalTf>(a, tf, p, s);
      const float f = sub_rn(1.0f, q.alpha);
      const float Tn = mul_rn(T, f);
      const bool last = s + 1 == a.S || !(Tn > a.thr);
      float d_a;
      if (last) {
        d_a = T * g.w;
      } else if (f < kRestartBelow) {
        const float Ur = rest_of_march<kGlobalTf>(a, tf, p, s, Tn, g);
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
          tf_lerp_bwd<kTfGradFracPositive, kGlobalTf>(tf, a.R, q.v.x, d_c,
                                                      acc);
      scatter_taps(a, s, q, make_float4(d_int, d_g.x, d_g.y, d_g.z));
      T = Tn;
    }
  }
  if (!kGlobalTf) flush_tf_grad(acc, a.R, a.d_tf);
}

static dim3 tiles(const ShearWarpArgs& a, dim3 block) {
  return dim3((a.O + block.x - 1) / block.x,
              (a.rows + block.y - 1) / block.y);
}

extern "C" int dr_shear_warp_fwd(const ShearWarpArgs* a, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->rows <= 0 || a->O <= 0) return 0;
  const dim3 block(16, 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->R <= kMaxSharedTexels) {
    shear_warp_fwd_kernel<false>
        <<<tiles(*a, block), block, a->R * sizeof(float4), s>>>(*a);
  } else {
    shear_warp_fwd_kernel<true><<<tiles(*a, block), block, 0, s>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" int dr_shear_warp_bwd(const ShearWarpArgs* a, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->rows <= 0 || a->O <= 0) return 0;
  const dim3 block(16, 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->R <= kMaxSharedTexels) {
    shear_warp_bwd_kernel<false>
        <<<tiles(*a, block), block, 2 * a->R * sizeof(float4), s>>>(*a);
  } else {
    shear_warp_bwd_kernel<true><<<tiles(*a, block), block, 0, s>>>(*a);
  }
  return (int)cudaGetLastError();
}
