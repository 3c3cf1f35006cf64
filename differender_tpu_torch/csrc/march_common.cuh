// Shared device code of the march kernels: K1 march_diff_fwd and K3
// march_nondiff (march.cu) and K2 march_diff_bwd (march_bwd.cu).
//
// K2 recomputes K1's march through these same functions (march_sample), so
// it takes bitwise the same samples, opacities and early-ray-termination
// decisions.
#pragma once

#include <cuda_runtime.h>

#include "tf_lerp.cuh"

// Mirrored field for field by differender_tpu_torch/render.py::_MarchArgs.
struct MarchArgs {
  const float* dx;
  const float* dy;
  const float* dz;
  const float* t0;
  const float* dt;
  const int* n;
  const float* volume;
  const float* tf;
  const float* origin;
  float* image;    // (H*W, 4): written by K1/K3; K1's image, read by K2
  int* steps;      // K1, K2: valid_steps; K3: samples visited
  int* shaded;     // K3: samples composited; K2 (if set): samples that add
                   // to d_volume; unused by K1
  int H, W, X, Y, Z, R, max_steps, ert;
  float scale_x, scale_y, scale_z, delta, inv_sr, thr;
  float ambient, diffuse, specular, shininess;
  float lc_r, lc_g, lc_b, alpha_skip;
};

// Positions and voxel coordinates are rounded after every multiply and add
// (__fmul_rn/__fadd_rn are never contracted into an FMA), as the plain
// version rounds them: the TF's steep alpha ramps turn a one-ulp shift of
// the position into a visible change of the sample's opacity.
__device__ __forceinline__ float voxel_axis(float p, float scale, int size,
                                            int& lo, int& hi) {
  const float c = __fmul_rn(
      fminf(fmaxf(__fadd_rn(__fmul_rn(0.5f, p), 0.5f), 0.0f), 1.0f), scale);
  const float lo_f = floorf(c);
  lo = (int)lo_f;
  hi = min(lo + 1, size - 1);
  return c - lo_f;
}

__device__ __forceinline__ float ray_coord(float o, float t, float d) {
  return __fadd_rn(o, __fmul_rn(t, d));
}

// s + x*w: with kExact rounded after the product and the sum; otherwise an
// FMA, as nvcc contracts it.
template <bool kExact>
__device__ __forceinline__ float add_product(float s, float x, float w) {
  if (kExact) return __fadd_rn(s, __fmul_rn(x, w));
  return s + x * w;
}

// kExact: the weighted sum is rounded corner by corner as the plain version
// sums it (no FMA): the TF's slope jumps at texel edges, so an ulp of
// intensity between the kernels and the plain march can move a sample's TF
// gradient by a whole texel's slope.  K1 and K2 (march_sample) take it; K3
// keeps the fused sum, which is faster and was held to the plain march
// within the image limits as it is.
template <bool kExact>
__device__ __forceinline__ float trilinear(const MarchArgs& a, float px,
                                           float py, float pz) {
  int x0, x1, y0, y1, z0, z1;
  const float fx = voxel_axis(px, a.scale_x, a.X, x0, x1);
  const float fy = voxel_axis(py, a.scale_y, a.Y, y0, y1);
  const float fz = voxel_axis(pz, a.scale_z, a.Z, z0, z1);
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  // 64-bit flat offsets (x*Y + y)*Z + z.
  const long long r00 = ((long long)x0 * a.Y + y0) * a.Z;
  const long long r10 = ((long long)x1 * a.Y + y0) * a.Z;
  const long long r01 = ((long long)x0 * a.Y + y1) * a.Z;
  const long long r11 = ((long long)x1 * a.Y + y1) * a.Z;
  const float* v = a.volume;
  // Corner order and weight products of sampling.py::_corner_weights.
  const float v000 = __ldg(v + r00 + z0), w000 = (gx * gy) * gz;
  float s = kExact ? __fmul_rn(v000, w000) : v000 * w000;
  s = add_product<kExact>(s, __ldg(v + r10 + z0), (fx * gy) * gz);
  s = add_product<kExact>(s, __ldg(v + r01 + z0), (gx * fy) * gz);
  s = add_product<kExact>(s, __ldg(v + r11 + z0), (fx * fy) * gz);
  s = add_product<kExact>(s, __ldg(v + r00 + z1), (gx * gy) * fz);
  s = add_product<kExact>(s, __ldg(v + r10 + z1), (fx * gy) * fz);
  s = add_product<kExact>(s, __ldg(v + r01 + z1), (gx * fy) * fz);
  s = add_product<kExact>(s, __ldg(v + r11 + z1), (fx * fy) * fz);
  return s;
}

// Premultiplied (rgb * light * alpha, alpha) of one sample: opacity
// correction and headlight shading (shading.py::shade_soa).
template <bool kClampLight>
__device__ __forceinline__ float4 shade(const MarchArgs& a, float4 c,
                                        float px, float py, float pz,
                                        float gx, float gy, float gz,
                                        float vdx, float vdy, float vdz,
                                        float ox, float oy, float oz) {
  const float alpha = 1.0f - powf(fmaxf(1.0f - c.w, 0.0f), a.inv_sr);

  const float g2 = gx * gx + gy * gy + gz * gz;
  const bool has_n = g2 > 0.0f;
  const float m = has_n ? rsqrtf(g2) : 0.0f;
  const float nx = gx * m, ny = gy * m, nz = gz * m;

  float ldx = px - ox, ldy = py - (oy + 1.0f), ldz = pz - oz;
  const float lmag = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
  const float inv = 1.0f / (lmag > 0.0f ? lmag : 1.0f);
  ldx *= inv;
  ldy *= inv;
  ldz *= inv;

  const float dot = nx * ldx + ny * ldy + nz * ldz;
  const float diffuse = a.diffuse * (has_n ? fmaxf(dot, 0.0f) : 0.0f);
  const float rx = ldx - 2.0f * dot * nx;
  const float ry = ldy - 2.0f * dot * ny;
  const float rz = ldz - 2.0f * dot * nz;
  const float r_dot_v = fmaxf(-(rx * vdx + ry * vdy + rz * vdz), 0.0f);
  const float specular =
      a.specular * (has_n ? powf(r_dot_v, a.shininess) : 0.0f);

  float light = diffuse + specular + a.ambient;
  if (kClampLight) light = fminf(1.0f, light);
  const float la = light * alpha;
  return make_float4(c.x * la * a.lc_r, c.y * la * a.lc_g, c.z * la * a.lc_b,
                     alpha);
}

// One sample of the differentiable march at step s: position, value and
// central-difference gradient, TF colour and shaded colour.  K1 and K2 both
// take their samples from here.
struct Sample {
  float px, py, pz, v, gx, gy, gz;
  float4 c, sh;
};

template <bool kGlobalTf>
__device__ __forceinline__ Sample march_sample(const MarchArgs& a,
                                               const float4* tf, int s,
                                               float t0, float dt, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz) {
  const float d = a.delta;
  Sample q;
  const float t = __fadd_rn(t0, __fmul_rn((float)s, dt));
  q.px = ray_coord(ox, t, dx);
  q.py = ray_coord(oy, t, dy);
  q.pz = ray_coord(oz, t, dz);
  q.v = trilinear<true>(a, q.px, q.py, q.pz);
  q.gx = trilinear<true>(a, q.px + d, q.py, q.pz) -
         trilinear<true>(a, q.px - d, q.py, q.pz);
  q.gy = trilinear<true>(a, q.px, q.py + d, q.pz) -
         trilinear<true>(a, q.px, q.py - d, q.pz);
  q.gz = trilinear<true>(a, q.px, q.py, q.pz + d) -
         trilinear<true>(a, q.px, q.py, q.pz - d);
  q.c = tf_lerp<kGlobalTf, true>(tf, a.R, q.v);
  q.sh = shade<true>(a, q.c, q.px, q.py, q.pz, q.gx, q.gy, q.gz, dx, dy, dz,
                     ox, oy, oz);
  return q;
}
