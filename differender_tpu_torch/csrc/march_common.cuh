// Shared device code of the march kernels: K1 march_diff_fwd and K3
// march_nondiff (march.cu) and K2 march_diff_bwd (march_bwd.cu).
//
// K2 recomputes K1's march through these same functions (sample_centre,
// sample_gradient, shade_sample), so it takes bitwise the same samples,
// opacities and early-ray-termination decisions.  Their 7-point stencil
// loads each distinct voxel once (see "The 7-point stencil" below); K3 takes
// the same stencil (stencil_gradient) with fused sums.  Each kernel has a
// kAnalytic instantiation (RenderConfig.analytic_normals): the gradient is
// the analytic in-cell derivative of the centre's 8 corners (cell_gradient),
// which the kernel holds anyway, so it loads no voxel beyond them.
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
  int* counts;     // K3 (if set): 3 counts per ray, its cell loads (the
                   // centre cell's cache misses), the voxels its composited
                   // samples loaded beyond that cell, and its grid reads;
                   // unused by K1/K2
  int H, W, X, Y, Z, R, max_steps, ert;
  int nx, ny, nz, cell, jump_every;  // the grid's shape, its cell edge in
                                     // voxels; look up every Nth iteration
  float scale_x, scale_y, scale_z, delta, inv_sr, thr;
  float ambient, diffuse, specular, shininess;
  float lc_r, lc_g, lc_b, alpha_skip;
  float cell_world;  // world L-inf size of one macrocell step
  float sc_x, sc_y, sc_z;  // f32(delta) * scale: the analytic gradient's
                           // factor per axis
  int analytic;      // 1: the kAnalytic instantiation
  // Segment instantiations (kSegment, parallel/volume_sharding.py): the
  // march over one X-slab of a volume sharded along X.  volume holds the
  // shard's padded block of Xp planes, global planes [x_start, x_start +
  // Xp); X is the global size.  s_lo: per ray, the first step of its window
  // of length steps; null outside a segment.  A sample is owned where its
  // voxel coordinate c_x lies in [x_lo, x_hi).
  const int* s_lo;
  int length, x_start, Xp;
  float x_lo, x_hi;
};

// Positions and voxel coordinates are rounded after every multiply and add
// (__fmul_rn/__fadd_rn are never contracted into an FMA), as the plain
// version rounds them: the TF's steep alpha ramps turn a one-ulp shift of
// the position into a visible change of the sample's opacity.
// The voxel coordinate clamp(0.5 p + 0.5, 0, 1) * scale of a position p.
__device__ __forceinline__ float voxel_coord(float p, float scale) {
  return __fmul_rn(
      fminf(fmaxf(__fadd_rn(__fmul_rn(0.5f, p), 0.5f), 0.0f), 1.0f), scale);
}

// c: the voxel coordinate itself.
__device__ __forceinline__ float voxel_axis(float p, float scale, int size,
                                            int& lo, int& hi, float& c) {
  c = voxel_coord(p, scale);
  const float lo_f = floorf(c);
  lo = (int)lo_f;
  hi = min(lo + 1, size - 1);
  return c - lo_f;
}

__device__ __forceinline__ float voxel_axis(float p, float scale, int size,
                                            int& lo, int& hi) {
  float c;
  return voxel_axis(p, scale, size, lo, hi, c);
}

__device__ __forceinline__ float ray_coord(float o, float t, float d) {
  return __fadd_rn(o, __fmul_rn(t, d));
}

// The plane of the volume that holds the global x plane x: x itself, or in
// a segment instantiation x - x_start, clamped into the padded block as
// sampling.py::trilinear_shard clamps it.  The global clamp of voxel_axis
// comes first, and an owned sample's stencil (delta below a voxel) stays
// inside the block, so the outer shards' wrapped halos are never read.
template <bool kSegment>
__device__ __forceinline__ int plane(const MarchArgs& a, int x) {
  if constexpr (kSegment) {
    return min(max(x - a.x_start, 0), a.Xp - 1);
  } else {
    return x;
  }
}

// kSegment: the eligible samples [s_begin, s_end) of ray p, s_end holding
// min(n, max_steps) on entry.  The window is s = s_lo + j for j < length; a
// sample is eligible where it is owned, x_lo <= c_x < x_hi on voxel_axis's
// own c_x (the exact ownership test of every shard, so each sample of the
// ray has one owner).  Every rounding from s to c_x is monotone, so c_x is
// monotone in s and the eligible samples are one run: the scan takes
// positions only and stops at the first sample past it.
__device__ __forceinline__ void segment_range(const MarchArgs& a, long long p,
                                              float t0, float dt, float ox,
                                              float dx, int& s_begin,
                                              int& s_end) {
  const int lo = a.s_lo[p];
  const int stop = min(lo + a.length, s_end);
  int b = stop, e = stop;
  for (int s = lo; s < stop; ++s) {
    const float t = __fadd_rn(t0, __fmul_rn((float)s, dt));
    const float c = voxel_coord(ray_coord(ox, t, dx), a.scale_x);
    const bool own = c >= a.x_lo && c < a.x_hi;
    if (own && b == stop) b = s;
    if (!own && b != stop) {
      e = s;
      break;
    }
  }
  s_begin = b;
  s_end = e;
}

// Macrocell index of a position on one axis, as occupancy.py::jump_steps
// computes it: the voxel coordinate c of voxel_axis (scale is f32(size - 1 -
// 1e-4) there too), divided by the cell edge, truncated and clamped to the
// grid.  K3 has c and its floor lo at hand: for a power-of-two cell edge
// c / cell is exact in f32, and its truncation is lo >> log2(cell).
__device__ __forceinline__ int occ_cell(float c, int lo, int cell, int n) {
  const int q = (cell & (cell - 1)) == 0 ? lo >> (__ffs(cell) - 1)
                                         : (int)__fdiv_rn(c, (float)cell);
  return min(q, n - 1);
}

// Samples K3 may skip from its head sample without evaluating them, at most
// `left` (occupancy.py::jump_steps): the head's macrocell lies at L-inf
// distance d (in macrocells) from any cell whose TF alpha can exceed
// alpha_skip, so every point within (d - 1) * cell_world of the head
// classifies at or below alpha_skip.  It depends on d and dt alone, so a
// macrocell once read at d <= 1 gives no jump while the head stays in it.
__device__ __forceinline__ int jump_from_distance(const MarchArgs& a, int d,
                                                  int left, float dt) {
  if (d <= 1 || !(dt > 0.0f)) return 0;
  const float q =
      __fdiv_rn(__fmul_rn((float)(d - 1), a.cell_world), fmaxf(dt, 1e-30f));
  return (int)fminf(q, (float)left);
}

// s + x*w: with kExact rounded after the product and the sum; otherwise one
// FMA.
template <bool kExact>
__device__ __forceinline__ float add_product(float s, float x, float w) {
  if (kExact) return __fadd_rn(s, __fmul_rn(x, w));
  return __fmaf_rn(x, w, s);
}

// One trilinear point, 8 corner loads.  kExact: the weighted sum is rounded
// corner by corner as the plain version sums it (no FMA): the TF's slope
// jumps at texel edges, so an ulp of intensity between the kernels and the
// plain march can move a sample's TF gradient by a whole texel's slope.  K1
// and K2 take it, through point_sum in the stencil's compact branch and
// through this function, point by point, in its general branch.  K3 takes
// the fused sum (kExact false, the same two branches), which is faster and
// holds to the plain march within the image limits; nothing there is
// differentiated.
template <bool kExact, bool kSegment = false>
__device__ __forceinline__ float trilinear(const MarchArgs& a, float px,
                                           float py, float pz) {
  int x0, x1, y0, y1, z0, z1;
  const float fx = voxel_axis(px, a.scale_x, a.X, x0, x1);
  const float fy = voxel_axis(py, a.scale_y, a.Y, y0, y1);
  const float fz = voxel_axis(pz, a.scale_z, a.Z, z0, z1);
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  x0 = plane<kSegment>(a, x0);
  x1 = plane<kSegment>(a, x1);
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
// The 7-point stencil of K1, K2 and K3: the centre and the +-delta points
// on each axis (the value and the central-difference gradient).
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

// The voxel (x, y, z): flat offset (x*Y + y)*Z + z, 64-bit, x the plane
// that holds global plane x (plane).
template <bool kSegment = false>
__device__ __forceinline__ float voxel(const MarchArgs& a, int x, int y,
                                       int z) {
  return __ldg(a.volume +
               ((long long)plane<kSegment>(a, x) * a.Y + y) * a.Z + z);
}

// One trilinear point from its 8 corner values (corner order i + 2j + 4k,
// x fastest) and its per-axis weights (1 - f, f): trilinear<kExact>'s sum,
// product for product and rounding for rounding.
template <bool kExact>
__device__ __forceinline__ float point_sum(const float (&v)[8], float gx,
                                           float fx, float gy, float fy,
                                           float gz, float fz) {
  const float w0 = (gx * gy) * gz;
  float s = kExact ? __fmul_rn(v[0], w0) : v[0] * w0;
  s = add_product<kExact>(s, v[1], (fx * gy) * gz);
  s = add_product<kExact>(s, v[2], (gx * fy) * gz);
  s = add_product<kExact>(s, v[3], (fx * fy) * gz);
  s = add_product<kExact>(s, v[4], (gx * gy) * fz);
  s = add_product<kExact>(s, v[5], (fx * gy) * fz);
  s = add_product<kExact>(s, v[6], (gx * fy) * fz);
  s = add_product<kExact>(s, v[7], (fx * fy) * fz);
  return s;
}

// ---------------------------------------------------------------------------
// Analytic mode (sampling.py::sample_with_gradient_analytic): the gradient
// is the derivative of the trilinear interpolant inside the centre's cell,
// from its 8 corners v (order i + 2j + 4k, the high indices clamped).  Along
// an axis it is sum_c (+-1) v_c w'_c: the sign the corner's bit on that axis,
// w'_c the product of its weights on the other two axes.
// ---------------------------------------------------------------------------

// The three in-cell derivatives (before the scale), corner by corner;
// kExact rounds as the plain version does (K1, K2), else fused (K3).
template <bool kExact>
__device__ __forceinline__ void cell_derivatives(const float (&v)[8],
                                                 float fx, float fy,
                                                 float fz, float& dx,
                                                 float& dy, float& dz) {
  const float ex = 1.0f - fx, ey = 1.0f - fy, ez = 1.0f - fz;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wx = c & 1 ? fx : ex, wy = c & 2 ? fy : ey,
                wz = c & 4 ? fz : ez;
    const float yz = wy * wz, xz = wx * wz, xy = wx * wy;
    const float tx = c & 1 ? yz : -yz, ty = c & 2 ? xz : -xz,
                tz = c & 4 ? xy : -xy;
    if (c == 0) {
      dx = kExact ? __fmul_rn(v[0], tx) : v[0] * tx;
      dy = kExact ? __fmul_rn(v[0], ty) : v[0] * ty;
      dz = kExact ? __fmul_rn(v[0], tz) : v[0] * tz;
    } else {
      dx = add_product<kExact>(dx, v[c], tx);
      dy = add_product<kExact>(dy, v[c], ty);
      dz = add_product<kExact>(dz, v[c], tz);
    }
  }
}

// The analytic gradient: the in-cell derivatives times sc.
template <bool kExact>
__device__ __forceinline__ void cell_gradient(const MarchArgs& a,
                                              const float (&v)[8], float fx,
                                              float fy, float fz, float& gx,
                                              float& gy, float& gz) {
  cell_derivatives<kExact>(v, fx, fy, fz, gx, gy, gz);
  gx = __fmul_rn(gx, a.sc_x);
  gy = __fmul_rn(gy, a.sc_y);
  gz = __fmul_rn(gz, a.sc_z);
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
  float cell[8];  // compact or analytic: the centre's cell, corner order
                  // i + 2j + 4k
};

// The position, the stencil's axes and branch, the centre value, its TF
// colour and opacity.  kAnalytic: the centre's 8 corners, the high indices
// clamped, are always loaded (q.cell); only each axis's lo and f are set,
// and the sample counts as compact.
template <bool kGlobalTf, bool kAnalytic, bool kSegment = false>
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
  if constexpr (kAnalytic) {
    int hx, hy, hz;
    q.ax.f = voxel_axis(q.px, a.scale_x, a.X, q.ax.lo, hx);
    q.ay.f = voxel_axis(q.py, a.scale_y, a.Y, q.ay.lo, hy);
    q.az.f = voxel_axis(q.pz, a.scale_z, a.Z, q.az.lo, hz);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      q.cell[c] = voxel<kSegment>(a, c & 1 ? hx : q.ax.lo,
                                  c & 2 ? hy : q.ay.lo, c & 4 ? hz : q.az.lo);
    }
    q.compact = true;
    q.v = point_sum<true>(q.cell, 1.0f - q.ax.f, q.ax.f, 1.0f - q.ay.f,
                          q.ay.f, 1.0f - q.az.f, q.az.f);
  } else {
    q.ax = stencil_axis(q.px, a.delta, a.scale_x, a.X);
    q.ay = stencil_axis(q.py, a.delta, a.scale_y, a.Y);
    q.az = stencil_axis(q.pz, a.delta, a.scale_z, a.Z);
    q.compact = q.ax.ok && q.ay.ok && q.az.ok;
    if (q.compact) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        q.cell[c] = voxel<kSegment>(a, q.ax.lo + (c & 1),
                                    q.ay.lo + ((c >> 1) & 1),
                                    q.az.lo + (c >> 2));
      }
      q.v = point_sum<true>(q.cell, 1.0f - q.ax.f, q.ax.f, 1.0f - q.ay.f,
                            q.ay.f, 1.0f - q.az.f, q.az.f);
    } else {
      q.v = trilinear<true, kSegment>(a, q.px, q.py, q.pz);
    }
  }
  q.c = tf_lerp<kGlobalTf, true>(tf, a.R, q.v);
  q.alpha = opacity(a, q.c.w);
  q.zero = zero_skip && q.alpha == 0.0f && isfinite(q.c.x) &&
           isfinite(q.c.y) && isfinite(q.c.z);
  return q;
}

// The six +-delta points of a sample at (px, py, pz) with stencil axes X, Y,
// Z and its unnormalised gradient (v(+x) - v(-x), ...).  Compact: the extra
// layers' voxels, 4 per axis that has one, then the six sums from registers
// and the centre's cell c; else the general branch, 6 points of 8 loads.
// Returns the voxels it loaded.
template <bool kExact, bool kSegment = false>
__device__ __forceinline__ int stencil_gradient(
    const MarchArgs& a, const StencilAxis& X, const StencilAxis& Y,
    const StencilAxis& Z, bool compact, const float (&c)[8], float px,
    float py, float pz, float& grad_x, float& grad_y, float& grad_z) {
  const float d = a.delta;
  if (!compact) {
    grad_x = trilinear<kExact, kSegment>(a, px + d, py, pz) -
             trilinear<kExact, kSegment>(a, px - d, py, pz);
    grad_y = trilinear<kExact, kSegment>(a, px, py + d, pz) -
             trilinear<kExact, kSegment>(a, px, py - d, pz);
    grad_z = trilinear<kExact, kSegment>(a, px, py, pz + d) -
             trilinear<kExact, kSegment>(a, px, py, pz - d);
    return 48;
  }
  // The extra x layer at (e, lo_y + j, lo_z + k) as j + 2k, the extra y
  // layer at (lo_x + i, e, lo_z + k) as i + 2k, the extra z layer at
  // (lo_x + i, lo_y + j, e) as i + 2j.
  float xe[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ye[4] = {0.0f, 0.0f, 0.0f, 0.0f},
        ze[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int loads = 0;
  if (X.m || X.pl) {
    const int e = extra_layer(X);
#pragma unroll
    for (int o = 0; o < 4; ++o)
      xe[o] = voxel<kSegment>(a, e, Y.lo + (o & 1), Z.lo + (o >> 1));
    loads += 4;
  }
  if (Y.m || Y.pl) {
    const int e = extra_layer(Y);
#pragma unroll
    for (int o = 0; o < 4; ++o)
      ye[o] = voxel<kSegment>(a, X.lo + (o & 1), e, Z.lo + (o >> 1));
    loads += 4;
  }
  if (Z.m || Z.pl) {
    const int e = extra_layer(Z);
#pragma unroll
    for (int o = 0; o < 4; ++o)
      ze[o] = voxel<kSegment>(a, X.lo + (o & 1), Y.lo + (o >> 1), e);
    loads += 4;
  }
  const float gx = 1.0f - X.f, gy = 1.0f - Y.f, gz = 1.0f - Z.f;
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
  grad_x = point_sum<kExact>(vp, 1.0f - X.fp, X.fp, gy, Y.f, gz, Z.f) -
           point_sum<kExact>(vm, 1.0f - X.fm, X.fm, gy, Y.f, gz, Z.f);
#pragma unroll
  for (int ik = 0; ik < 4; ++ik) {
    const int o = (ik & 1) + 4 * (ik >> 1);   // corner (i, 0, k)
    vp[o] = Y.pl ? c[o + 2] : c[o];
    vp[o + 2] = Y.pl ? ye[ik] : c[o + 2];
    vm[o] = Y.m ? ye[ik] : c[o];
    vm[o + 2] = Y.m ? c[o] : c[o + 2];
  }
  grad_y = point_sum<kExact>(vp, gx, X.f, 1.0f - Y.fp, Y.fp, gz, Z.f) -
           point_sum<kExact>(vm, gx, X.f, 1.0f - Y.fm, Y.fm, gz, Z.f);
#pragma unroll
  for (int o = 0; o < 4; ++o) {   // corner (i, j, 0)
    vp[o] = Z.pl ? c[o + 4] : c[o];
    vp[o + 4] = Z.pl ? ze[o] : c[o + 4];
    vm[o] = Z.m ? ze[o] : c[o];
    vm[o + 4] = Z.m ? c[o] : c[o + 4];
  }
  grad_z = point_sum<kExact>(vp, gx, X.f, gy, Y.f, 1.0f - Z.fp, Z.fp) -
           point_sum<kExact>(vm, gx, X.f, gy, Y.f, 1.0f - Z.fm, Z.fm);
  return loads;
}

// K1/K2: the gradient of a sample from sample_centre; kAnalytic loads
// nothing.
template <bool kAnalytic, bool kSegment = false>
__device__ __forceinline__ void sample_gradient(const MarchArgs& a,
                                                Sample& q) {
  if constexpr (kAnalytic) {
    cell_gradient<true>(a, q.cell, q.ax.f, q.ay.f, q.az.f, q.gx, q.gy, q.gz);
  } else {
    stencil_gradient<true, kSegment>(a, q.ax, q.ay, q.az, q.compact, q.cell,
                                     q.px, q.py, q.pz, q.gx, q.gy, q.gz);
  }
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
template <bool kGlobalTf, bool kAnalytic, bool kSegment = false>
__device__ __forceinline__ Sample march_sample(const MarchArgs& a,
                                               const float4* tf, int s,
                                               float t0, float dt, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz,
                                               bool zero_skip) {
  Sample q = sample_centre<kGlobalTf, kAnalytic, kSegment>(
      a, tf, s, t0, dt, ox, oy, oz, dx, dy, dz, zero_skip);
  if (!q.zero) sample_gradient<kAnalytic, kSegment>(a, q);
  shade_sample(a, q, dx, dy, dz, ox, oy, oz);
  return q;
}
