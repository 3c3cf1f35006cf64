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
#include <cuda_runtime.h>

#include "march_common.cuh"

// Mirrored field for field by differender_tpu_torch/render.py::_MarchBwdArgs.
struct MarchBwdArgs {
  MarchArgs f;        // f.image: K1's image (read); f.steps: K2's counts;
                      // f.shaded, if set: 4 counts per ray, the samples
                      // that add to d_volume, those that add nothing and
                      // need the light (their d_tf does), the atomics added
                      // to d_volume, and the samples of the stencil's
                      // general branch
  const float* grad;  // (H*W, 4) image cotangent
  float* d_volume;    // (X*Y*Z), zeroed by the caller
  float* d_tf;        // (R*4), zeroed by the caller
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

// Adds one sample's volume cotangents into d_volume: dv at the centre and
// +-dg_axis at the +-delta points of each axis.  The compact branch merges
// the 56 terms into one total per distinct voxel (sums of the same products
// in another order) and adds each with one atomic; the general branch
// scatters point by point.  Returns the atomics issued.
__device__ __forceinline__ int scatter_sample(const MarchArgs& a,
                                              float* dvol, const Sample& q,
                                              float dv, float dgx, float dgy,
                                              float dgz) {
  if (!q.compact) {
    const float d = a.delta;
    return trilinear_scatter(a, dvol, q.px, q.py, q.pz, dv) +
           trilinear_scatter(a, dvol, q.px + d, q.py, q.pz, dgx) +
           trilinear_scatter(a, dvol, q.px - d, q.py, q.pz, -dgx) +
           trilinear_scatter(a, dvol, q.px, q.py + d, q.pz, dgy) +
           trilinear_scatter(a, dvol, q.px, q.py - d, q.pz, -dgy) +
           trilinear_scatter(a, dvol, q.px, q.py, q.pz + d, dgz) +
           trilinear_scatter(a, dvol, q.px, q.py, q.pz - d, -dgz);
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
          ((long long)(X.lo + i) * a.Y + (Y.lo + j)) * a.Z;
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
            dvol, ((long long)ex * a.Y + (Y.lo + l)) * a.Z + Z.lo + k,
            axe * (wy[l] * wz[k]));
      }
      if (ys) {
        count += add_voxel(
            dvol, ((long long)(X.lo + l) * a.Y + ey) * a.Z + Z.lo + k,
            aye * (wx[l] * wz[k]));
      }
    }
  }
  return count;
}

// Backward of shade<true> for the cotangent d_sh of its output: returns
// the cotangent of the TF colour c and writes that of the gradient.  Ties
// of max/min take half, as in JAX; the unit normal's VJP is clamped at
// |g| = 1e-6 (shading.py::_unit_normal_soa_bwd).
__device__ __forceinline__ float4 shade_bwd(const MarchArgs& a, float4 c,
                                            float px, float py, float pz,
                                            float gx, float gy, float gz,
                                            float vdx, float vdy, float vdz,
                                            float ox, float oy, float oz,
                                            float4 d_sh, float& dgx,
                                            float& dgy, float& dgz) {
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
  }
  const float inv_mag = 1.0f / fmaxf(sqrtf(g2), 1e-6f);
  const float vn = dnx * nx + dny * ny + dnz * nz;
  dgx = (dnx - vn * nx) * inv_mag;
  dgy = (dny - vn * ny) * inv_mag;
  dgz = (dnz - vn * nz) * inv_mag;
  return d_c;
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
template <bool kGlobalTf>
__device__ __forceinline__ float rest_of_ray(
    const MarchArgs& a, const float4* tf, int s, int steps, float Tn,
    float4 g, float t0, float dt, float ox, float oy, float oz, float dx,
    float dy, float dz, bool zero_skip) {
  float Ur = 0.0f, Tl = 1.0f, Tr = Tn;
  for (int s2 = s + 1; s2 < steps; ++s2) {
    if (a.ert && !(Tr > a.thr)) break;
    const Sample r = march_sample<kGlobalTf>(a, tf, s2, t0, dt, ox, oy, oz,
                                             dx, dy, dz, zero_skip);
    Ur += Tl * (g.x * r.sh.x + g.y * r.sh.y + g.z * r.sh.z);
    Tl *= 1.0f - r.sh.w;
    Tr *= 1.0f - r.sh.w;
    if (Tl == 0.0f) break;
  }
  return Ur - g.w * Tl;
}

// At least 4 blocks of 128 threads per SM: at most 128 registers a thread.
// Left to itself nvcc gives K2 240 registers, 2 blocks per SM, too few
// warps to hide its data-addressed loads and atomics.
template <bool kGlobalTf>
__global__ void __launch_bounds__(128, 4)
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
    const int steps = min(a.n[p], a.max_steps);
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
    int cnt = 1, scattered = 0, quiet_light = 0, atomics = 0, general = 0;
    for (int s = 0; s < steps; ++s) {
      if (a.ert && !(T > a.thr)) break;
      if (T == 0.0f) {          // without ERT: nothing more to add
        cnt += steps - s;
        break;
      }
      Sample q = sample_centre<kGlobalTf>(a, tf, s, t0, dt, ox, oy, oz, dx,
                                          dy, dz, zero_skip);
      const float4 d_sh = make_float4(T * g.x, T * g.y, T * g.z, 0.0f);
      const float d_la = d_sh.x * q.c.x * a.lc_r + d_sh.y * q.c.y * a.lc_g +
                         d_sh.z * q.c.z * a.lc_b;
      const bool light = !q.zero || d_la != 0.0f || light_always;
      general += !q.compact;
      if (light) {
        sample_gradient(a, q);
      } else {
        q.gx = q.gy = q.gz = 0.0f;
      }
      shade_sample(a, q, dx, dy, dz, ox, oy, oz);
      const float f = 1.0f - q.sh.w;
      const float Tn = T * f;
      const bool last = s + 1 == steps || (a.ert && !(Tn > a.thr));
      float d_a;
      if (last) {
        d_a = T * g.w;
      } else if (f < kRestartBelow) {
        const float Ur = rest_of_ray<kGlobalTf>(a, tf, s, steps, Tn, g, t0,
                                                dt, ox, oy, oz, dx, dy, dz,
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
      const float4 d_c = shade_bwd(
          a, q.c, q.px, q.py, q.pz, q.gx, q.gy, q.gz, dx, dy, dz, ox, oy, oz,
          make_float4(d_sh.x, d_sh.y, d_sh.z, d_a), dgx, dgy, dgz);
      const float dv = tf_lerp_bwd<kMarchTfMask<kGlobalTf>, kGlobalTf>(
          tf, a.R, q.v, d_c, acc);
      if (dv != 0.0f || dgx != 0.0f || dgy != 0.0f || dgz != 0.0f) {
        ++scattered;
        atomics += scatter_sample(a, b.d_volume, q, dv, dgx, dgy, dgz);
      } else {
        quiet_light += light;
      }
      T = Tn;
      ++cnt;
    }
    a.steps[p] = cnt;
    if (a.shaded) {
      a.shaded[4 * p] = scattered;
      a.shaded[4 * p + 1] = quiet_light;
      a.shaded[4 * p + 2] = atomics;
      a.shaded[4 * p + 3] = general;
    }
  }
  if (!kGlobalTf) flush_tf_grad(acc, a.R, b.d_tf);
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
  if (a.R <= kMaxSharedTexels) {
    march_diff_bwd_kernel<false><<<grid, block, 2 * a.R * sizeof(float4),
                                   s>>>(*b);
  } else {
    march_diff_bwd_kernel<true><<<grid, block, 0, s>>>(*b);
  }
  return (int)cudaGetLastError();
}
