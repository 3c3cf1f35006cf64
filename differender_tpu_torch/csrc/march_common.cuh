// Shared device code of the march kernels: K1 march_diff_fwd and K3
// march_nondiff (march.cu) and K2 march_diff_bwd (march_bwd.cu).
//
// K2 recomputes K1's march through these same functions (sample_centre,
// sample_gradient, shade_sample), so it takes bitwise the same samples,
// opacities and early-ray-termination decisions.  Their 7-point stencil
// loads each distinct voxel once (see "The 7-point stencil" below).
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
  int* shaded;     // K3: samples composited; K1 (if set): 2 counts per ray,
                   // the samples that took the zero-opacity skip and those
                   // of the stencil's general branch; K2 (if set): 4 counts
                   // per ray (march_bwd.cu)
  const int* occ;  // K3: the occupancy grid's (nx*ny*nz) distance field, or
                   // null for no empty-space skip; unused by K1/K2
  const int* occ_far;  // K3 with a grid: its largest distance (one int);
                       // below 2 no ray can jump, and K3 looks up nothing
  int H, W, X, Y, Z, R, max_steps, ert;
  int nx, ny, nz, cell, jump_every;  // the grid's shape, its cell edge in
                                     // voxels; look up every Nth iteration
  float scale_x, scale_y, scale_z, delta, inv_sr, thr;
  float ambient, diffuse, specular, shininess;
  float lc_r, lc_g, lc_b, alpha_skip;
  float cell_world;  // world L-inf size of one macrocell step
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

// Macrocell index of a position on one axis, as occupancy.py::jump_steps
// computes it: the voxel coordinate of voxel_axis, divided by the cell edge,
// truncated and clamped to the grid (scale is f32(size - 1 - 1e-4) there
// too).
__device__ __forceinline__ int occ_axis(float p, float scale, int cell,
                                        int n) {
  const float c = __fmul_rn(
      fminf(fmaxf(__fadd_rn(__fmul_rn(0.5f, p), 0.5f), 0.0f), 1.0f), scale);
  return min((int)__fdiv_rn(c, (float)cell), n - 1);
}

// Samples K3 may skip from the head sample s without evaluating them, at
// most `left` (occupancy.py::jump_steps): the head's cell lies at L-inf
// distance d (in macrocells) from any cell whose TF alpha can exceed
// alpha_skip, so every point within (d - 1) * cell_world of the head
// classifies at or below alpha_skip.
__device__ __forceinline__ int occupancy_jump(const MarchArgs& a, int s,
                                              int left, float t0, float dt,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz) {
  const float t = __fadd_rn(t0, __fmul_rn((float)s, dt));
  const int cx = occ_axis(ray_coord(ox, t, dx), a.scale_x, a.cell, a.nx);
  const int cy = occ_axis(ray_coord(oy, t, dy), a.scale_y, a.cell, a.ny);
  const int cz = occ_axis(ray_coord(oz, t, dz), a.scale_z, a.cell, a.nz);
  const int d = __ldg(a.occ + ((long long)cx * a.ny + cy) * a.nz + cz);
  if (d <= 1 || !(dt > 0.0f)) return 0;
  const float q =
      __fdiv_rn(__fmul_rn((float)(d - 1), a.cell_world), fmaxf(dt, 1e-30f));
  return (int)fminf(q, (float)left);
}

// s + x*w: with kExact rounded after the product and the sum; otherwise an
// FMA, as nvcc contracts it.
template <bool kExact>
__device__ __forceinline__ float add_product(float s, float x, float w) {
  if (kExact) return __fadd_rn(s, __fmul_rn(x, w));
  return s + x * w;
}

// One trilinear point, 8 corner loads.  kExact: the weighted sum is rounded
// corner by corner as the plain version sums it (no FMA): the TF's slope
// jumps at texel edges, so an ulp of intensity between the kernels and the
// plain march can move a sample's TF gradient by a whole texel's slope.  K1
// and K2 take it, through point_sum in the stencil's compact branch and
// through this function, point by point, in its general branch; K3 keeps
// the fused sum, which is faster and was held to the plain march within the
// image limits as it is.
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

// Opacity correction of a TF alpha: 1 - max(1 - a, 0)^(1 / sampling rate).
__device__ __forceinline__ float opacity(const MarchArgs& a, float tf_alpha) {
  return 1.0f - powf(fmaxf(1.0f - tf_alpha, 0.0f), a.inv_sr);
}

// Premultiplied (rgb * light * alpha, alpha) of one sample of opacity
// alpha (opacity of its TF alpha): headlight shading
// (shading.py::shade_soa).
template <bool kClampLight>
__device__ __forceinline__ float4 shade(const MarchArgs& a, float4 c,
                                        float alpha, float px, float py,
                                        float pz, float gx, float gy,
                                        float gz, float vdx, float vdy,
                                        float vdz, float ox, float oy,
                                        float oz) {
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

// ---------------------------------------------------------------------------
// The 7-point stencil of K1 and K2: the centre and the +-delta points on
// each axis (the value and the central-difference gradient).
//
// A +-delta point moves on one axis only, so it shares the centre's voxel
// indices and fractions on the other two.  Where delta is below half a
// voxel (1e-3 is 0.1275 voxel at 256^3), a point leaves the centre's cell
// only for the neighbouring layer on its axis, and only when the centre lies
// within delta of that side's edge.  The 56 corners of the 7 points then
// fall on the centre's 2x2x2 cell plus at most one extra 2x2 layer per axis:
// 8 to 20 distinct voxels, about 11 on average at 256^3.  That is the
// compact branch.  Each distinct voxel is loaded once, with a scalar __ldg
// (float4 loads of aligned z runs were slower: a warp's lanes sit at mixed
// alignments), the centre's cell first and the extra layers only for a
// sample that needs its gradient.  The seven sums are formed from registers
// in trilinear<true>'s corner order and rounding (point_sum), so the samples
// are bitwise those of the point-by-point form, and K2 adds each voxel's
// merged weight with one atomic (scatter_sample).  A sample that needs both
// extra layers of an axis (delta above half a voxel), a layer further out
// (delta of a voxel or more) or a high index clamped onto its low one (4096
// voxels or more on an axis) takes the general branch: 7 points of 8 loads,
// and in K2 7 scatters of 8 atomics.  The kernel decides per sample.
// ---------------------------------------------------------------------------

// One axis of a sample's stencil: voxel_axis at p, p - delta and p + delta,
// exactly as trilinear<true> computes them for the 7 points.
struct StencilAxis {
  int lo;           // the centre's low voxel index; its high one is lo + 1
  float f, fm, fp;  // the fractions at p, p - delta and p + delta
  bool m, pl;       // the -delta point's low index is lo - 1; the +delta
                    // point's is lo + 1 (each then reaches the extra layer,
                    // lo - 1 or lo + 2)
  bool ok;          // the compact footprint holds on this axis
};

__device__ __forceinline__ StencilAxis stencil_axis(float p, float d,
                                                   float scale, int size) {
  StencilAxis s;
  int hi, lom, him, lop, hip;
  s.f = voxel_axis(p, scale, size, s.lo, hi);
  s.fm = voxel_axis(p - d, scale, size, lom, him);
  s.fp = voxel_axis(p + d, scale, size, lop, hip);
  s.m = lom != s.lo;
  s.pl = lop != s.lo;
  s.ok = hi == s.lo + 1 && him == lom + 1 && hip == lop + 1 &&
         (!s.m || lom == s.lo - 1) && (!s.pl || lop == s.lo + 1) &&
         !(s.m && s.pl);
  return s;
}

__device__ __forceinline__ int extra_layer(const StencilAxis& s) {
  return s.m ? s.lo - 1 : s.lo + 2;
}

// The voxel (x, y, z): flat offset (x*Y + y)*Z + z, 64-bit.
__device__ __forceinline__ float voxel(const MarchArgs& a, int x, int y,
                                       int z) {
  return __ldg(a.volume + ((long long)x * a.Y + y) * a.Z + z);
}

// One trilinear point from its 8 corner values (corner order i + 2j + 4k,
// x fastest) and its per-axis weights (1 - f, f): trilinear<true>'s sum,
// product for product and rounding for rounding.
__device__ __forceinline__ float point_sum(const float (&v)[8], float gx,
                                           float fx, float gy, float fy,
                                           float gz, float fz) {
  float s = __fmul_rn(v[0], (gx * gy) * gz);
  s = __fadd_rn(s, __fmul_rn(v[1], (fx * gy) * gz));
  s = __fadd_rn(s, __fmul_rn(v[2], (gx * fy) * gz));
  s = __fadd_rn(s, __fmul_rn(v[3], (fx * fy) * gz));
  s = __fadd_rn(s, __fmul_rn(v[4], (gx * gy) * fz));
  s = __fadd_rn(s, __fmul_rn(v[5], (fx * gy) * fz));
  s = __fadd_rn(s, __fmul_rn(v[6], (gx * fy) * fz));
  s = __fadd_rn(s, __fmul_rn(v[7], (fx * fy) * fz));
  return s;
}

// Whether the zero-opacity skip is exact for these shading settings.  A
// sample of opacity 0 shades to (c.rgb * (light * 0) * lc, 0): zeros, so
// it leaves r, g, b and T bitwise unchanged, wherever light * 0 is a zero.
// shade<true>'s light is min(1, ambient + diffuse * max(n.l, 0) + specular
// * pow(r.v, shininess)) with r.v >= 0.  With finite coefficients and
// specular >= 0 the sum is finite, +inf or NaN, never -inf, and fminf makes
// each of them at most 1: finite.  The sample's TF colour must be finite
// too (checked per sample), and the light colour.
__device__ __forceinline__ bool zero_skip_exact(const MarchArgs& a) {
  return isfinite(a.ambient) && isfinite(a.diffuse) &&
         isfinite(a.specular) && a.specular >= 0.0f && isfinite(a.lc_r) &&
         isfinite(a.lc_g) && isfinite(a.lc_b);
}

// One sample of the differentiable march at step s.  K1 and K2 both take
// their samples from sample_centre, sample_gradient and shade_sample, so K2
// recomputes K1's samples, opacities and early-ray-termination decisions
// bitwise.
struct Sample {
  float px, py, pz, v, gx, gy, gz, alpha;
  float4 c, sh;
  StencilAxis ax, ay, az;
  bool compact;   // the stencil's compact branch (else the general one)
  bool zero;      // opacity exactly 0, a finite TF colour and the skip
                  // exact (zero_skip_exact): the sample shades to 0
  float cell[8];  // compact: the centre's cell, corner order i + 2j + 4k
};

// The position, the stencil's axes and branch, the centre value, its TF
// colour and opacity.
template <bool kGlobalTf>
__device__ __forceinline__ Sample sample_centre(const MarchArgs& a,
                                                const float4* tf, int s,
                                                float t0, float dt, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz,
                                                bool zero_skip) {
  Sample q;
  const float t = __fadd_rn(t0, __fmul_rn((float)s, dt));
  q.px = ray_coord(ox, t, dx);
  q.py = ray_coord(oy, t, dy);
  q.pz = ray_coord(oz, t, dz);
  q.ax = stencil_axis(q.px, a.delta, a.scale_x, a.X);
  q.ay = stencil_axis(q.py, a.delta, a.scale_y, a.Y);
  q.az = stencil_axis(q.pz, a.delta, a.scale_z, a.Z);
  q.compact = q.ax.ok && q.ay.ok && q.az.ok;
  if (q.compact) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      q.cell[c] = voxel(a, q.ax.lo + (c & 1), q.ay.lo + ((c >> 1) & 1),
                        q.az.lo + (c >> 2));
    }
    q.v = point_sum(q.cell, 1.0f - q.ax.f, q.ax.f, 1.0f - q.ay.f, q.ay.f,
                    1.0f - q.az.f, q.az.f);
  } else {
    q.v = trilinear<true>(a, q.px, q.py, q.pz);
  }
  q.c = tf_lerp<kGlobalTf, true>(tf, a.R, q.v);
  q.alpha = opacity(a, q.c.w);
  q.zero = zero_skip && q.alpha == 0.0f && isfinite(q.c.x) &&
           isfinite(q.c.y) && isfinite(q.c.z);
  return q;
}

// The six +-delta points of a sample and its unnormalised gradient
// (v(+x) - v(-x), ...).  Compact: the extra layers' voxels, 4 per axis that
// has one, then the six sums from registers.
__device__ __forceinline__ void sample_gradient(const MarchArgs& a,
                                                Sample& q) {
  const float d = a.delta;
  if (!q.compact) {
    q.gx = trilinear<true>(a, q.px + d, q.py, q.pz) -
           trilinear<true>(a, q.px - d, q.py, q.pz);
    q.gy = trilinear<true>(a, q.px, q.py + d, q.pz) -
           trilinear<true>(a, q.px, q.py - d, q.pz);
    q.gz = trilinear<true>(a, q.px, q.py, q.pz + d) -
           trilinear<true>(a, q.px, q.py, q.pz - d);
    return;
  }
  const StencilAxis &X = q.ax, &Y = q.ay, &Z = q.az;
  // The extra x layer at (e, lo_y + j, lo_z + k) as j + 2k, the extra y
  // layer at (lo_x + i, e, lo_z + k) as i + 2k, the extra z layer at
  // (lo_x + i, lo_y + j, e) as i + 2j.
  float xe[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ye[4] = {0.0f, 0.0f, 0.0f, 0.0f},
        ze[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (X.m || X.pl) {
    const int e = extra_layer(X);
#pragma unroll
    for (int o = 0; o < 4; ++o)
      xe[o] = voxel(a, e, Y.lo + (o & 1), Z.lo + (o >> 1));
  }
  if (Y.m || Y.pl) {
    const int e = extra_layer(Y);
#pragma unroll
    for (int o = 0; o < 4; ++o)
      ye[o] = voxel(a, X.lo + (o & 1), e, Z.lo + (o >> 1));
  }
  if (Z.m || Z.pl) {
    const int e = extra_layer(Z);
#pragma unroll
    for (int o = 0; o < 4; ++o)
      ze[o] = voxel(a, X.lo + (o & 1), Y.lo + (o >> 1), e);
  }
  const float gx = 1.0f - X.f, gy = 1.0f - Y.f, gz = 1.0f - Z.f;
  const float(&c)[8] = q.cell;
  float vp[8], vm[8];
  // +-x: the corners (low, high) on x at each (j, k).
#pragma unroll
  for (int jk = 0; jk < 4; ++jk) {
    const int o = 2 * jk;   // corner (0, j, k)
    vp[o] = X.pl ? c[o + 1] : c[o];
    vp[o + 1] = X.pl ? xe[jk] : c[o + 1];
    vm[o] = X.m ? xe[jk] : c[o];
    vm[o + 1] = X.m ? c[o] : c[o + 1];
  }
  q.gx = point_sum(vp, 1.0f - X.fp, X.fp, gy, Y.f, gz, Z.f) -
         point_sum(vm, 1.0f - X.fm, X.fm, gy, Y.f, gz, Z.f);
#pragma unroll
  for (int ik = 0; ik < 4; ++ik) {
    const int o = (ik & 1) + 4 * (ik >> 1);   // corner (i, 0, k)
    vp[o] = Y.pl ? c[o + 2] : c[o];
    vp[o + 2] = Y.pl ? ye[ik] : c[o + 2];
    vm[o] = Y.m ? ye[ik] : c[o];
    vm[o + 2] = Y.m ? c[o] : c[o + 2];
  }
  q.gy = point_sum(vp, gx, X.f, 1.0f - Y.fp, Y.fp, gz, Z.f) -
         point_sum(vm, gx, X.f, 1.0f - Y.fm, Y.fm, gz, Z.f);
#pragma unroll
  for (int o = 0; o < 4; ++o) {   // corner (i, j, 0)
    vp[o] = Z.pl ? c[o + 4] : c[o];
    vp[o + 4] = Z.pl ? ze[o] : c[o + 4];
    vm[o] = Z.m ? ze[o] : c[o];
    vm[o + 4] = Z.m ? c[o] : c[o + 4];
  }
  q.gz = point_sum(vp, gx, X.f, gy, Y.f, 1.0f - Z.fp, Z.fp) -
         point_sum(vm, gx, X.f, gy, Y.f, 1.0f - Z.fm, Z.fm);
}

// The sample's premultiplied colour: 0 for a zero sample (K1 composites it
// as r += T * 0, T *= 1, which changes nothing), else shade<true>.
__device__ __forceinline__ void shade_sample(const MarchArgs& a, Sample& q,
                                             float vdx, float vdy, float vdz,
                                             float ox, float oy, float oz) {
  q.sh = q.zero ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                : shade<true>(a, q.c, q.alpha, q.px, q.py, q.pz, q.gx, q.gy,
                              q.gz, vdx, vdy, vdz, ox, oy, oz);
}

// One sample of the differentiable march, forward only: the centre, then
// the gradient and the shading unless it is a zero sample.
template <bool kGlobalTf>
__device__ __forceinline__ Sample march_sample(const MarchArgs& a,
                                               const float4* tf, int s,
                                               float t0, float dt, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz,
                                               bool zero_skip) {
  Sample q = sample_centre<kGlobalTf>(a, tf, s, t0, dt, ox, oy, oz, dx, dy,
                                      dz, zero_skip);
  if (!q.zero) sample_gradient(a, q);
  shade_sample(a, q, dx, dy, dz, ox, oy, oz);
  return q;
}
