// K2 march_diff_bwd: the backward of the differentiable march, one thread
// per ray, in the same 16x8 pixel tiles as K1.
//
// Replaces the JAX package's main-path backward, which is XLA code with no
// Pallas in it: AD through render.py::_eval_block_soa and
// composite_block_soa (with _exclusive_cumprod), the clamped
// shading.py::unit_normal_soa VJP, sampling.py::_apply_tf_dot_bwd, and the
// sorted/tiled volume-VJP family (sampling.py:919-960, :1357-1470).  What
// it computes, not its form: the JAX march saves named residuals per block
// and scatters d_volume through sorted windows; here each thread recomputes
// its ray front to back with K1's own device functions (march_common.cuh),
// so it takes bitwise K1's samples and early-ray-termination (ERT)
// decisions, and per sample it pulls the cotangents of the premultiplied
// colour and alpha through the composite, the headlight shading (light
// clamp included), the opacity correction, the clamped unit-normal VJP and
// the TF lerp (tf_lerp_bwd in tf_lerp.cuh), then scatters the sample's 56
// voxel terms (8 for the value, 48 for the six +-delta gradient points,
// opposite signs for + and -) into d_volume.  d_tf is summed per block in
// shared memory (R <= kMaxSharedTexels) and added to the global d_tf once
// per block.
//
// The composite's alpha cotangent.  With T_s the transmittance before
// sample s, f_s = 1 - a_s and g the image cotangent, dL/dc_s = T_s g.rgb and
// dL/da_s = -T_s U_s, where U_s = dL/dT_{s+1} sums what lies behind s:
// U_s = sum_{j>s} (T_j / T_{s+1}) g.c_j - g.a * T_F / T_{s+1}.  A front-to-
// back pass knows the whole sum from K1's image (rgb_F and T_F = 1 - A) and
// subtracts the prefix, so per sample dL/da_s = -(T_b / f_s)(U - P_s) within
// a segment that starts at transmittance T_b with U its whole sum behind.
// That divides by f_s, which is 0 where a TF alpha of exactly 1 makes a_s =
// 1.  So: the last composited sample of a ray (the usual place of such a
// sample when ERT is on) takes the exact U = -g.a; any other sample with
// f_s < kRestartBelow marches the rest of its ray once more with a local
// transmittance that starts at 1, which gives its U without a division and
// starts a new segment.  Once T is exactly 0 every later cotangent is 0 and
// the thread stops (without ERT it still counts the samples K1 composited).
//
// Bound on the H100: operations (about 3x K1's per sample: the recompute,
// the backward chain and the scatter).  In practice the recompute's
// data-addressed loads and the atomics decide the time: 56 scalar atomics
// per sample went to about 11 distinct addresses, 7 of them back to back to
// each corner of the centre's cell, and d_volume and the volume (64 MiB
// each at 256^3) overflow the 50 MB L2, so misses are read-modify-writes in
// HBM.  What the design does about it: the recompute loads each distinct
// voxel of the stencil once (the compact branch in march_common.cuh), and
// scatter_sample merges the 56 terms in registers into one total per
// distinct voxel and adds each non-zero total with one scalar atomic
// (float4 vector atomics on aligned z runs, and warp aggregation of equal
// addresses, were both slower).  A zero cotangent adds nothing, which skips
// most atomics in empty space.  A sample of opacity 0 whose d_tf needs no
// light skips the gradient points (see march_diff_bwd_kernel).  The kernel
// is held to 128 registers so that 4 blocks fit on an SM.
//
// Analytic normals (kAnalytic, RenderConfig.analytic_normals): the gradient
// comes from the centre's 8 corners (cell_gradient), and scatter_cell adds
// each sample's cotangents to those 8 voxels, one atomic per distinct one.
//
// Camera gradients (kCamera, launched only where a ray tensor needs a
// gradient): sample s of a ray sits at p = o + (t0 + s dt) d.  Per sample
// K2 also forms the position's cotangent d_p: dv times the centre value's
// trilinear derivative, plus each dg_axis times its gradient component's
// derivative (the parity stencil: the trilinear derivatives of its +-delta
// points; analytic: the interpolant's mixed second derivatives, its pure
// ones being 0), each through d(voxel coordinate)/dp = 0.5 scale, plus
// shading's light-direction term d_l (the light sits at o + (0, 1, 0)).
// It writes 12 floats per ray: P = sum d_p, S = sum s d_p, L = sum d_l and
// V = sum d_v, the cotangent of shading's view direction, which is d.  The
// caller maps them onto the ray tensors (render.py::ray_cotangents):
// d_o = sum (P - L), d_d = t0 P + dt S + V, d_t0 = d.P, d_dt = d.S.  Twelve
// accumulators and the derivative points would spill in the default
// instantiation's 128 registers, so the camera one is held to 168 (3 blocks
// an SM).
//
// TF gradient only (kVolumeGrad false, launched where d_volume is null: the
// volume needs no gradient, nor does any ray tensor, as in a transfer-
// function fit).  The recompute stays whole (the gradient points still feed
// the light, so d_c), and so do the composite's backward, the shading's
// backward to the TF colour, tf_lerp_bwd into d_tf, ERT, the restart rule and
// the counts of steps.  Left out: the normal's cotangent (shade_bwd's chain
// from the light to the gradient), the value's cotangent dv and the scatter,
// with the d_volume buffer the caller would zero.  Only without kCamera and
// kSegment.
#include <cuda_runtime.h>

#include "march_common.cuh"

// Mirrored field for field by differender_tpu_torch/render.py::_MarchBwdArgs.
struct MarchBwdArgs {
  MarchArgs f;        // f.image: K1's image (read); f.steps: K2's counts;
                      // f.shaded, if set: 4 counts per ray, the samples
                      // that add to d_volume, those that add nothing and
                      // need the light (their d_tf does), the atomics added
                      // to d_volume, and the samples of the stencil's
                      // general branch (the TF-only instantiation counts
                      // only the last, the others stay 0)
  const float* grad;  // (H*W, 4) image cotangent
  float* d_volume;    // (X*Y*Z), zeroed by the caller; null: the TF-only
                      // instantiation runs (no ray_sums, no segment)
  float* d_tf;        // (R*4), zeroed by the caller
  float* ray_sums;    // (H*W, 12) P, S, L, V per ray, or null: the camera
                      // instantiation runs where it is set
};

// A sample whose f = 1 - a is below this starts a new segment (see above):
// the division's error is at most ~1/kRestartBelow ulps of the ray's sum.
// Below the default ERT gate's 0.01, so with ERT on only the last sample of
// a ray can have such an f, and no ray marches twice.
constexpr float kRestartBelow = 1.0f / 128.0f;

// d max(x, 0)/dx with JAX's convention: half at the tie.
__device__ __forceinline__ float relu_slope(float x) {
  return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
}

// The general branch's scatter of one point: 8 atomics, or none for dv = 0.
// Returns the atomics issued.
template <bool kSegment>
__device__ __forceinline__ int trilinear_scatter(const MarchArgs& a,
                                                 float* dvol, float px,
                                                 float py, float pz,
                                                 float dv) {
  if (dv == 0.0f) return 0;
  int x0, x1, y0, y1, z0, z1;
  const float fx = voxel_axis(px, a.scale_x, a.X, x0, x1);
  const float fy = voxel_axis(py, a.scale_y, a.Y, y0, y1);
  const float fz = voxel_axis(pz, a.scale_z, a.Z, z0, z1);
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  x0 = plane<kSegment>(a, x0);
  x1 = plane<kSegment>(a, x1);
  const long long r00 = ((long long)x0 * a.Y + y0) * a.Z;
  const long long r10 = ((long long)x1 * a.Y + y0) * a.Z;
  const long long r01 = ((long long)x0 * a.Y + y1) * a.Z;
  const long long r11 = ((long long)x1 * a.Y + y1) * a.Z;
  atomicAdd(dvol + r00 + z0, dv * ((gx * gy) * gz));
  atomicAdd(dvol + r10 + z0, dv * ((fx * gy) * gz));
  atomicAdd(dvol + r01 + z0, dv * ((gx * fy) * gz));
  atomicAdd(dvol + r11 + z0, dv * ((fx * fy) * gz));
  atomicAdd(dvol + r00 + z1, dv * ((gx * gy) * fz));
  atomicAdd(dvol + r10 + z1, dv * ((fx * gy) * fz));
  atomicAdd(dvol + r01 + z1, dv * ((gx * fy) * fz));
  atomicAdd(dvol + r11 + z1, dv * ((fx * fy) * fz));
  return 8;
}

// Adds w to d_volume at o with one atomic, unless w is 0.  Returns the
// atomics issued.
__device__ __forceinline__ int add_voxel(float* dvol, long long o, float w) {
  if (w == 0.0f) return 0;
  atomicAdd(dvol + o, w);
  return 1;
}

// One axis's share of the +-delta points' weights, merged onto the three
// layers it can touch in the compact branch: the centre's low and high
// layers and the extra one.  dg * (w(+delta) - w(-delta)) on each.
__device__ __forceinline__ void arm_weights(const StencilAxis& s, float dg,
                                            float& a0, float& a1,
                                            float& ae) {
  const float gp = 1.0f - s.fp, gm = 1.0f - s.fm;
  const float p0 = s.pl ? 0.0f : gp, p1 = s.pl ? gp : s.fp,
              pe = s.pl ? s.fp : 0.0f;
  const float m0 = s.m ? s.fm : gm, m1 = s.m ? 0.0f : s.fm,
              me = s.m ? gm : 0.0f;
  a0 = dg * (p0 - m0);
  a1 = dg * (p1 - m1);
  ae = dg * (pe - me);
}

// Analytic mode: one sample's volume cotangents on the centre's 8 corners,
// dv w_c + sum_axis dg_axis sc_axis (+-1) w'_c (the terms of
// cell_gradient), one atomic per distinct corner: a high index clamped onto
// its low one merges the two corners' totals.  Returns the atomics issued.
__device__ __forceinline__ int scatter_cell(const MarchArgs& a, float* dvol,
                                            const Sample& q, float dv,
                                            float dgx, float dgy,
                                            float dgz) {
  int lx, hx, ly, hy, lz, hz;
  const float fx = voxel_axis(q.px, a.scale_x, a.X, lx, hx);
  const float fy = voxel_axis(q.py, a.scale_y, a.Y, ly, hy);
  const float fz = voxel_axis(q.pz, a.scale_z, a.Z, lz, hz);
  const float ex = 1.0f - fx, ey = 1.0f - fy, ez = 1.0f - fz;
  const float ax = dgx * a.sc_x, ay = dgy * a.sc_y, az = dgz * a.sc_z;
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wx = c & 1 ? fx : ex, wy = c & 2 ? fy : ey,
                wz = c & 4 ? fz : ez;
    const float yz = wy * wz, xz = wx * wz, xy = wx * wy;
    w[c] = dv * (xy * wz) + ax * (c & 1 ? yz : -yz) +
           ay * (c & 2 ? xz : -xz) + az * (c & 4 ? xy : -xy);
  }
  // Corners on one voxel: merge along x, then y, then z.
#pragma unroll
  for (int bit = 1; bit < 8; bit <<= 1) {
    const bool same = bit == 1 ? hx == lx : bit == 2 ? hy == ly : hz == lz;
    if (same) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (!(c & bit)) {
          w[c] += w[c + bit];
          w[c + bit] = 0.0f;
        }
      }
    }
  }
  int count = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    count += add_voxel(dvol,
                       ((long long)(c & 1 ? hx : lx) * a.Y +
                        (c & 2 ? hy : ly)) * a.Z + (c & 4 ? hz : lz),
                       w[c]);
  }
  return count;
}

// Adds one sample's volume cotangents into d_volume: dv at the centre and
// +-dg_axis at the +-delta points of each axis.  The compact branch merges
// the 56 terms into one total per distinct voxel (sums of the same products
// in another order) and adds each with one atomic; the general branch
// scatters point by point.  kAnalytic: scatter_cell.  kSegment: into the
// shard's padded block (plane), halo planes included.  Returns the atomics
// issued.
template <bool kAnalytic, bool kSegment = false>
__device__ __forceinline__ int scatter_sample(const MarchArgs& a,
                                              float* dvol, const Sample& q,
                                              float dv, float dgx, float dgy,
                                              float dgz) {
  if constexpr (kAnalytic) return scatter_cell(a, dvol, q, dv, dgx, dgy, dgz);
  if (!q.compact) {
    const float d = a.delta;
    return trilinear_scatter<kSegment>(a, dvol, q.px, q.py, q.pz, dv) +
           trilinear_scatter<kSegment>(a, dvol, q.px + d, q.py, q.pz, dgx) +
           trilinear_scatter<kSegment>(a, dvol, q.px - d, q.py, q.pz, -dgx) +
           trilinear_scatter<kSegment>(a, dvol, q.px, q.py + d, q.pz, dgy) +
           trilinear_scatter<kSegment>(a, dvol, q.px, q.py - d, q.pz, -dgy) +
           trilinear_scatter<kSegment>(a, dvol, q.px, q.py, q.pz + d, dgz) +
           trilinear_scatter<kSegment>(a, dvol, q.px, q.py, q.pz - d, -dgz);
  }
  // The axes again from the position, bitwise sample_centre's: cheaper
  // than keeping them in registers across the shading backward.
  const StencilAxis X = stencil_axis(q.px, a.delta, a.scale_x, a.X);
  const StencilAxis Y = stencil_axis(q.py, a.delta, a.scale_y, a.Y);
  const StencilAxis Z = stencil_axis(q.pz, a.delta, a.scale_z, a.Z);
  const float wx[2] = {1.0f - X.f, X.f}, wy[2] = {1.0f - Y.f, Y.f},
              wz[2] = {1.0f - Z.f, Z.f};
  float ax[2], ay[2], az[2], axe, aye, aze;
  arm_weights(X, dgx, ax[0], ax[1], axe);
  arm_weights(Y, dgy, ay[0], ay[1], aye);
  arm_weights(Z, dgz, az[0], az[1], aze);
  const bool xs = X.m || X.pl, ys = Y.m || Y.pl, zs = Z.m || Z.pl;
  const int ex = extra_layer(X), ey = extra_layer(Y), ez = extra_layer(Z);
  int count = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The centre's cell on the line (lo_x + i, lo_y + j), and the extra z
      // layer there.
      const long long row =
          ((long long)plane<kSegment>(a, X.lo + i) * a.Y + (Y.lo + j)) *
          a.Z;
      const float xv = dv * wx[i] + ax[i];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        count += add_voxel(dvol, row + Z.lo + k,
                           xv * wy[j] * wz[k] +
                               wx[i] * (ay[j] * wz[k] + az[k] * wy[j]));
      }
      if (zs) count += add_voxel(dvol, row + ez, aze * (wx[i] * wy[j]));
    }
  }
  // The extra x layer at (e, lo_y + j, lo_z + k) and the extra y layer at
  // (lo_x + i, e, lo_z + k).
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (xs) {
        count += add_voxel(
            dvol,
            ((long long)plane<kSegment>(a, ex) * a.Y + (Y.lo + l)) * a.Z +
                Z.lo + k,
            axe * (wy[l] * wz[k]));
      }
      if (ys) {
        count += add_voxel(
            dvol,
            ((long long)plane<kSegment>(a, X.lo + l) * a.Y + ey) * a.Z +
                Z.lo + k,
            aye * (wx[l] * wz[k]));
      }
    }
  }
  return count;
}

// Backward of shade<true> for the cotangent d_sh of its output: returns
// the cotangent of the TF colour c and writes that of the gradient.  Ties
// of max/min take half, as in JAX; the unit normal's VJP is clamped at
// |g| = 1e-6 (shading.py::_unit_normal_soa_bwd).  kCamera: also adds the
// cotangents of the position in the light direction, p - (o + (0, 1, 0)),
// to d_l and of the view direction to d_v (both 0 without a normal).
// kNormalGrad false: the TF colour's cotangent alone, the gradient's 0.
template <bool kCamera, bool kNormalGrad = true>
__device__ __forceinline__ float4 shade_bwd(const MarchArgs& a, float4 c,
                                            float px, float py, float pz,
                                            float gx, float gy, float gz,
                                            float vdx, float vdy, float vdz,
                                            float ox, float oy, float oz,
                                            float4 d_sh, float& dgx,
                                            float& dgy, float& dgz,
                                            float3& d_l, float3& d_v) {
  const float m1 = 1.0f - c.w;
  const float mm = fmaxf(m1, 0.0f);
  const float alpha = 1.0f - powf(mm, a.inv_sr);

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
  const float q = -(rx * vdx + ry * vdy + rz * vdz);
  const float r_dot_v = fmaxf(q, 0.0f);
  const float specular =
      a.specular * (has_n ? powf(r_dot_v, a.shininess) : 0.0f);
  const float light_raw = diffuse + specular + a.ambient;
  const float light = fminf(1.0f, light_raw);
  const float la = light * alpha;

  float4 d_c;
  d_c.x = d_sh.x * la * a.lc_r;
  d_c.y = d_sh.y * la * a.lc_g;
  d_c.z = d_sh.z * la * a.lc_b;
  const float d_la =
      d_sh.x * c.x * a.lc_r + d_sh.y * c.y * a.lc_g + d_sh.z * c.z * a.lc_b;
  const float d_alpha = d_la * light + d_sh.w;
  // alpha = 1 - mm^e: JAX's pow derivative e * mm^(e - 1).
  const float d_mm = -d_alpha * (a.inv_sr * powf(mm, a.inv_sr - 1.0f));
  d_c.w = -d_mm * relu_slope(m1);
  if constexpr (!kNormalGrad) {
    dgx = dgy = dgz = 0.0f;
    return d_c;
  }

  const float d_raw = d_la * alpha *
      (light_raw < 1.0f ? 1.0f : (light_raw == 1.0f ? 0.5f : 0.0f));
  float dnx = 0.0f, dny = 0.0f, dnz = 0.0f;
  if (has_n) {
    const float d_pow =
        a.shininess == 0.0f
            ? 0.0f
            : a.shininess * powf(r_dot_v, a.shininess - 1.0f);
    const float d_q = a.specular * d_raw * d_pow * relu_slope(q);
    const float drx = -d_q * vdx, dry = -d_q * vdy, drz = -d_q * vdz;
    const float d_dot = a.diffuse * d_raw * relu_slope(dot) -
                        2.0f * (drx * nx + dry * ny + drz * nz);
    dnx = d_dot * ldx - 2.0f * dot * drx;
    dny = d_dot * ldy - 2.0f * dot * dry;
    dnz = d_dot * ldz - 2.0f * dot * drz;
    if constexpr (kCamera) {
      // The unit light direction's cotangent (dot = n.l, r = l - 2 dot n),
      // then through l = l_raw / |l_raw|; the view direction's from
      // q = -(r.v).
      const float dlx = d_dot * nx + drx, dly = d_dot * ny + dry,
                  dlz = d_dot * nz + drz;
      const float proj = dlx * ldx + dly * ldy + dlz * ldz;
      d_l.x += inv * (dlx - proj * ldx);
      d_l.y += inv * (dly - proj * ldy);
      d_l.z += inv * (dlz - proj * ldz);
      d_v.x -= d_q * rx;
      d_v.y -= d_q * ry;
      d_v.z -= d_q * rz;
    }
  }
  const float inv_mag = 1.0f / fmaxf(sqrtf(g2), 1e-6f);
  const float vn = dnx * nx + dny * ny + dnz * nz;
  dgx = (dnx - vn * nx) * inv_mag;
  dgy = (dny - vn * ny) * inv_mag;
  dgz = (dnz - vn * nz) * inv_mag;
  return d_c;
}

// d(voxel coordinate)/d(position) on one axis: 0.5 * scale inside the
// clamp to [0, 1], its bounds included (torch.clamp's gradient, which the
// plain version takes), else 0.
__device__ __forceinline__ float coord_slope(float p, float scale) {
  const float u = __fadd_rn(__fmul_rn(0.5f, p), 0.5f);
  return u >= 0.0f && u <= 1.0f ? 0.5f * scale : 0.0f;
}

// Adds w times the position gradient of the trilinear interpolant at one
// point to (o.x, o.y, o.z): its 8 corners loaded, the in-cell derivatives
// times coord_slope.  No-op for w = 0.  kSegment: the corners' global x
// indices are clamped to the volume first (voxel_axis, as
// sampling.py::trilinear_shard takes them), then shifted into the shard's
// padded block (voxel<kSegment>), so the slope at the volume's faces is the
// global clamp's, not a clamp at the block's edges.
template <bool kSegment>
__device__ __forceinline__ void add_point_gradient(const MarchArgs& a,
                                                   float px, float py,
                                                   float pz, float w,
                                                   float3& o) {
  if (w == 0.0f) return;
  int x[2], y[2], z[2];
  const float fx = voxel_axis(px, a.scale_x, a.X, x[0], x[1]);
  const float fy = voxel_axis(py, a.scale_y, a.Y, y[0], y[1]);
  const float fz = voxel_axis(pz, a.scale_z, a.Z, z[0], z[1]);
  float v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    v[c] = voxel<kSegment>(a, x[c & 1], y[(c >> 1) & 1], z[c >> 2]);
  }
  float dx, dy, dz;
  cell_derivatives<false>(v, fx, fy, fz, dx, dy, dz);
  o.x += w * (coord_slope(px, a.scale_x) * dx);
  o.y += w * (coord_slope(py, a.scale_y) * dy);
  o.z += w * (coord_slope(pz, a.scale_z) * dz);
}

// kCamera: adds the part of a sample's position cotangent that flows
// through its value (dv) and its gradient (dg) to o.  Parity: the value's
// trilinear derivative and, per axis, the difference of the derivatives at
// the +-delta points.  Analytic: from the centre's cell, the value's first
// derivatives and the gradient's mixed second ones, d g_x / d f_y =
// sc_x sum_c v_c (+-1)_x (+-1)_y w_z,c and so on.  kSegment (parity only):
// the points read the shard's padded block (add_point_gradient).
template <bool kAnalytic, bool kSegment = false>
__device__ __forceinline__ void add_position_cotangent(
    const MarchArgs& a, const Sample& q, float dv, float dgx, float dgy,
    float dgz, float3& o) {
  if constexpr (kAnalytic) {
    const float fx = q.ax.f, fy = q.ay.f, fz = q.az.f;
    const float ex = 1.0f - fx, ey = 1.0f - fy, ez = 1.0f - fz;
    float dx, dy, dz;
    cell_derivatives<false>(q.cell, fx, fy, fz, dx, dy, dz);
    float dxy = 0.0f, dxz = 0.0f, dyz = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float sx = c & 1 ? 1.0f : -1.0f, sy = c & 2 ? 1.0f : -1.0f,
                  sz = c & 4 ? 1.0f : -1.0f;
      dxy += (sx * sy) * q.cell[c] * (c & 4 ? fz : ez);
      dxz += (sx * sz) * q.cell[c] * (c & 2 ? fy : ey);
      dyz += (sy * sz) * q.cell[c] * (c & 1 ? fx : ex);
    }
    const float ax = dgx * a.sc_x, ay = dgy * a.sc_y, az = dgz * a.sc_z;
    o.x += coord_slope(q.px, a.scale_x) * (dv * dx + ay * dxy + az * dxz);
    o.y += coord_slope(q.py, a.scale_y) * (dv * dy + ax * dxy + az * dyz);
    o.z += coord_slope(q.pz, a.scale_z) * (dv * dz + ax * dxz + ay * dyz);
  } else {
    const float d = a.delta;
    add_point_gradient<kSegment>(a, q.px, q.py, q.pz, dv, o);
    add_point_gradient<kSegment>(a, q.px + d, q.py, q.pz, dgx, o);
    add_point_gradient<kSegment>(a, q.px - d, q.py, q.pz, -dgx, o);
    add_point_gradient<kSegment>(a, q.px, q.py + d, q.pz, dgy, o);
    add_point_gradient<kSegment>(a, q.px, q.py - d, q.pz, -dgy, o);
    add_point_gradient<kSegment>(a, q.px, q.py, q.pz + d, dgz, o);
    add_point_gradient<kSegment>(a, q.px, q.py, q.pz - d, -dgz, o);
  }
}

// The TF-gradient rule of the JAX march for this TF size (kGlobalTf is
// R > kMaxSharedTexels = 1024, the JAX march's own switch).
template <bool kGlobalTf>
constexpr int kMarchTfMask = kGlobalTf ? kTfGradEveryT : kTfGradFracPositive;

// U, the whole sum behind sample s, for a sample whose f = 1 - a is below
// kRestartBelow: the rest of the ray marched once more with a local
// transmittance from 1, under the same ERT gate on the real transmittance
// (which starts at Tn).  Inlined: a call's saved registers cost K2 more
// than the code size.
template <bool kGlobalTf, bool kAnalytic, bool kSegment = false>
__device__ __forceinline__ float rest_of_ray(
    const MarchArgs& a, const float4* tf, int s, int steps, float Tn,
    float4 g, float t0, float dt, float ox, float oy, float oz, float dx,
    float dy, float dz, bool zero_skip) {
  float Ur = 0.0f, Tl = 1.0f, Tr = Tn;
  for (int s2 = s + 1; s2 < steps; ++s2) {
    if (!kSegment && a.ert && !(Tr > a.thr)) break;
    const Sample r = march_sample<kGlobalTf, kAnalytic, kSegment>(
        a, tf, s2, t0, dt, ox, oy, oz, dx, dy, dz, zero_skip);
    Ur += Tl * (g.x * r.sh.x + g.y * r.sh.y + g.z * r.sh.z);
    Tl *= 1.0f - r.sh.w;
    Tr *= 1.0f - r.sh.w;
    if (Tl == 0.0f) break;
  }
  return Ur - g.w * Tl;
}

// At least 4 blocks of 128 threads per SM: at most 128 registers a thread.
// Left to itself nvcc gives K2 240 registers, 2 blocks per SM, too few
// warps to hide its data-addressed loads and atomics.  The camera
// instantiation: 3 blocks, 168 registers.
//
// kSegment (parity only, no ERT): the backward of K1's segment
// instantiation.  It marches bitwise K1's eligible run (segment_range),
// f.image holding that run's composite, scatters d_volume into the shard's
// padded block (its halo planes included: the caller sends their cotangents
// to the shards that own them) and takes the TF gradient of JAX's
// apply_tf, autograd of the gather-lerp (kTfGradEveryT), for every R.
// kSegment with kCamera: the 12 per-ray sums over the owned run, with the
// global sample index s, so the caller maps them through ray_cotangents
// unchanged; the ranks' sums of one ray add up to the whole ray's.
//
// kVolumeGrad false (neither kCamera nor kSegment): d_tf alone, see the top
// of this file.
template <bool kGlobalTf, bool kAnalytic, bool kCamera, bool kSegment,
          bool kVolumeGrad = true>
__global__ void __launch_bounds__(128, kCamera ? 3 : 4)
    march_diff_bwd_kernel(MarchBwdArgs b) {
  extern __shared__ float4 s_tf[];
  const MarchArgs& a = b.f;
  const float4* tf =
      stage_tf<kGlobalTf>(reinterpret_cast<const float4*>(a.tf), a.R, s_tf);
  float* acc = kGlobalTf ? b.d_tf : reinterpret_cast<float*>(s_tf + a.R);
  if (!kGlobalTf) zero_tf_grad(acc, a.R);

  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (w < a.W && h < a.H) {
    const long long p = (long long)h * a.W + w;
    const float ox = __ldg(a.origin), oy = __ldg(a.origin + 1),
                oz = __ldg(a.origin + 2);
    const float dx = a.dx[p], dy = a.dy[p], dz = a.dz[p];
    const float t0 = a.t0[p], dt = a.dt[p];
    int s0 = 0, steps = min(a.n[p], a.max_steps);
    if constexpr (kSegment) segment_range(a, p, t0, dt, ox, dx, s0, steps);
    const float4 g = reinterpret_cast<const float4*>(b.grad)[p];
    const float4 img = reinterpret_cast<const float4*>(a.image)[p];
    const bool zero_skip = zero_skip_exact(a);
    // A zero sample (opacity 0, see march_common.cuh) shades to 0 whatever
    // its normal, its shading backward gives dg = 0 and d_c.rgb = 0, and it
    // uses the light (so the normal) only in d_alpha = d_la * light +
    // d_sh.a.  So it needs the gradient points only where d_la = T g.rgb .
    // (c.rgb lc) != 0, or where d_pow (a shininess below 1 and not 0) could
    // make dg = d_raw * d_pow = 0 * inf a NaN, as the full chain does;
    // elsewhere a zero gradient (ambient light) gives the same d_c and
    // dg = 0, up to the sign of a zero.
    const bool light_always = !(a.shininess >= 1.0f || a.shininess == 0.0f);

    // Segment state: base transmittance, whole sum behind the segment's
    // start, local transmittance and the prefix of that sum.
    float Tb = 1.0f, Tloc = 1.0f, P = 0.0f;
    float U = g.x * img.x + g.y * img.y + g.z * img.z - g.w * (1.0f - img.w);
    float T = 1.0f;
    int cnt = kSegment ? 0 : 1, scattered = 0, quiet_light = 0, atomics = 0,
        general = 0;
    // kCamera: the per-ray sums P, S, L, V.
    float3 sum_p = make_float3(0.0f, 0.0f, 0.0f), sum_s = sum_p,
           sum_l = sum_p, sum_v = sum_p;
    for (int s = s0; s < steps; ++s) {
      if (!kSegment && a.ert && !(T > a.thr)) break;
      if (T == 0.0f) {          // without ERT: nothing more to add
        cnt += steps - s;
        break;
      }
      Sample q = sample_centre<kGlobalTf, kAnalytic, kSegment>(
          a, tf, s, t0, dt, ox, oy, oz, dx, dy, dz, zero_skip);
      const float4 d_sh = make_float4(T * g.x, T * g.y, T * g.z, 0.0f);
      const float d_la = d_sh.x * q.c.x * a.lc_r + d_sh.y * q.c.y * a.lc_g +
                         d_sh.z * q.c.z * a.lc_b;
      const bool light = !q.zero || d_la != 0.0f || light_always;
      general += !q.compact;
      if (light) {
        sample_gradient<kAnalytic, kSegment>(a, q);
      } else {
        q.gx = q.gy = q.gz = 0.0f;
      }
      shade_sample(a, q, dx, dy, dz, ox, oy, oz);
      const float f = 1.0f - q.sh.w;
      const float Tn = T * f;
      const bool last =
          s + 1 == steps || (!kSegment && a.ert && !(Tn > a.thr));
      float d_a;
      if (last) {
        d_a = T * g.w;
      } else if (f < kRestartBelow) {
        const float Ur = rest_of_ray<kGlobalTf, kAnalytic, kSegment>(
            a, tf, s, steps, Tn, g, t0, dt, ox, oy, oz, dx, dy, dz,
            zero_skip);
        d_a = -T * Ur;
        Tb = Tn;
        U = Ur;
        P = 0.0f;
        Tloc = 1.0f;
      } else {
        P += Tloc * (g.x * q.sh.x + g.y * q.sh.y + g.z * q.sh.z);
        d_a = -(Tb / f) * (U - P);
        Tloc *= f;
      }
      float dgx, dgy, dgz;
      float3 d_p = make_float3(0.0f, 0.0f, 0.0f);
      const float4 d_c = shade_bwd<kCamera, kVolumeGrad>(
          a, q.c, q.px, q.py, q.pz, q.gx, q.gy, q.gz, dx, dy, dz, ox, oy, oz,
          make_float4(d_sh.x, d_sh.y, d_sh.z, d_a), dgx, dgy, dgz, d_p,
          sum_v);
      const float dv =
          tf_lerp_bwd<kSegment ? kTfGradEveryT : kMarchTfMask<kGlobalTf>,
                      kGlobalTf>(tf, a.R, q.v, d_c, acc);
      if constexpr (kVolumeGrad) {
        if (dv != 0.0f || dgx != 0.0f || dgy != 0.0f || dgz != 0.0f) {
          ++scattered;
          atomics += scatter_sample<kAnalytic, kSegment>(a, b.d_volume, q,
                                                         dv, dgx, dgy, dgz);
        } else {
          quiet_light += light;
        }
      }
      if constexpr (kCamera) {
        // d_p holds the light-direction term so far.
        sum_l.x += d_p.x;
        sum_l.y += d_p.y;
        sum_l.z += d_p.z;
        add_position_cotangent<kAnalytic, kSegment>(a, q, dv, dgx, dgy,
                                                    dgz, d_p);
        const float sf = (float)s;
        sum_p.x += d_p.x;
        sum_p.y += d_p.y;
        sum_p.z += d_p.z;
        sum_s.x += sf * d_p.x;
        sum_s.y += sf * d_p.y;
        sum_s.z += sf * d_p.z;
      }
      T = Tn;
      ++cnt;
    }
    a.steps[p] = cnt;
    if constexpr (kCamera) {
      float* o = b.ray_sums + 12 * p;
      const float3 sums[4] = {sum_p, sum_s, sum_l, sum_v};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[3 * k] = sums[k].x;
        o[3 * k + 1] = sums[k].y;
        o[3 * k + 2] = sums[k].z;
      }
    }
    if (a.shaded) {
      a.shaded[4 * p] = scattered;
      a.shaded[4 * p + 1] = quiet_light;
      a.shaded[4 * p + 2] = atomics;
      a.shaded[4 * p + 3] = general;
    }
  }
  if (!kGlobalTf) flush_tf_grad(acc, a.R, b.d_tf);
}

template <bool kAnalytic, bool kCamera, bool kSegment = false,
          bool kVolumeGrad = true>
static void launch_bwd(const MarchBwdArgs& b, dim3 grid, dim3 block,
                       cudaStream_t s) {
  if (b.f.R <= kMaxSharedTexels) {
    march_diff_bwd_kernel<false, kAnalytic, kCamera, kSegment, kVolumeGrad>
        <<<grid, block, 2 * b.f.R * sizeof(float4), s>>>(b);
  } else {
    march_diff_bwd_kernel<true, kAnalytic, kCamera, kSegment, kVolumeGrad>
        <<<grid, block, 0, s>>>(b);
  }
}

extern "C" int dr_march_diff_bwd(const MarchBwdArgs* b, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const MarchArgs& a = b->f;
  if (a.H <= 0 || a.W <= 0) return 0;
  const dim3 block(16, 8);
  const dim3 grid((a.W + block.x - 1) / block.x,
                  (a.H + block.y - 1) / block.y);
  cudaStream_t s = (cudaStream_t)stream;
  const bool camera = b->ray_sums != nullptr;
  const bool tf_only = b->d_volume == nullptr;
  if (tf_only && (camera || a.s_lo)) return (int)cudaErrorInvalidValue;
  if (a.s_lo) {
    // The segment instantiations: parity only (the caller never asks for
    // analytic normals in a segment, as JAX's segment ignores them).
    if (a.analytic) return (int)cudaErrorInvalidValue;
    if (camera) {
      launch_bwd<false, true, true>(*b, grid, block, s);
    } else {
      launch_bwd<false, false, true>(*b, grid, block, s);
    }
  } else if (a.analytic) {
    if (camera) {
      launch_bwd<true, true>(*b, grid, block, s);
    } else if (tf_only) {
      launch_bwd<true, false, false, false>(*b, grid, block, s);
    } else {
      launch_bwd<true, false>(*b, grid, block, s);
    }
  } else if (camera) {
    launch_bwd<false, true>(*b, grid, block, s);
  } else if (tf_only) {
    launch_bwd<false, false, false, false>(*b, grid, block, s);
  } else {
    launch_bwd<false, false>(*b, grid, block, s);
  }
  return (int)cudaGetLastError();
}
