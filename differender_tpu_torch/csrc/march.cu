// K1 march_diff_fwd and K3 march_nondiff: one thread per ray.
//
// Replaces the march of differender_tpu/render.py: march_diff (forward) and
// march_nondiff.  On the TPU these are XLA programs shaped around gather
// cost: supercell tables (sampling.py::sample_super_parity), the MXU-dot TF
// lookup (sampling.py::_apply_tf_dot2_p), the closed-form block composite
// (render.py::composite_block_soa) and alive-ray compaction.  Here each
// thread marches its ray front to back, as the reference renderer does:
// per sample it computes the position, 7 trilinear samples (56 loads) for
// the value and the central-difference gradient, the TF lerp
// (tf_lerp.cuh), opacity correction, headlight shading and the composite,
// and it stops at its own early ray termination (ERT).
//
// Bound on the H100: operations.  At the bench workload the volume (64 MiB)
// is read once in the byte count, but every sample needs ~350 f32 operations
// over its 56 loads, so the f32 rate bounds the work.  In practice the
// dependent, data-addressed loads (latency, L1/L2 hit rate) decide the time.
// What the design does about it: blocks cover 16x8 pixel tiles so the rays of
// a warp walk neighbouring voxels and share cache lines; the TF sits in
// shared memory; the transmittance is carried multiplicatively and each
// thread exits at ERT, so no work is spent past it.  K3 samples the 6
// gradient points only when the TF alpha passes alpha_skip.  No hardware
// texture filtering: its 8-bit weights would break parity with the f32
// weights of the reference.
//
// Semantics held to (differender_tpu line refs):
//   positions t = t0 + s*dt, p = origin + t*d            (render.py:220-229)
//   voxel coords clamp(0.5p+0.5,0,1)*scale, high clamp   (sampling.py:38-96)
//   ERT gate T > f32(1 - ert_threshold), valid_steps from 1 (render.py:347-367,551)
//   nondiff: no max_samples cap, alpha_skip gate, no light clamp, min(1, .)
//                                                        (render.py:716-745)
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
  float* image;    // (H*W, 4)
  int* steps;      // K1: valid_steps; K3: samples visited
  int* shaded;     // K3: samples composited; unused by K1
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
  float s = __ldg(v + r00 + z0) * ((gx * gy) * gz);
  s += __ldg(v + r10 + z0) * ((fx * gy) * gz);
  s += __ldg(v + r01 + z0) * ((gx * fy) * gz);
  s += __ldg(v + r11 + z0) * ((fx * fy) * gz);
  s += __ldg(v + r00 + z1) * ((gx * gy) * fz);
  s += __ldg(v + r10 + z1) * ((fx * gy) * fz);
  s += __ldg(v + r01 + z1) * ((gx * fy) * fz);
  s += __ldg(v + r11 + z1) * ((fx * fy) * fz);
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

template <bool kGlobalTf>
__global__ void __launch_bounds__(128) march_diff_fwd_kernel(MarchArgs a) {
  extern __shared__ float4 s_tf[];
  const float4* tf =
      stage_tf<kGlobalTf>(reinterpret_cast<const float4*>(a.tf), a.R, s_tf);
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (w >= a.W || h >= a.H) return;
  const long long p = (long long)h * a.W + w;

  const float ox = __ldg(a.origin), oy = __ldg(a.origin + 1),
              oz = __ldg(a.origin + 2);
  const float dx = a.dx[p], dy = a.dy[p], dz = a.dz[p];
  const float t0 = a.t0[p], dt = a.dt[p];
  const int steps = min(a.n[p], a.max_steps);
  const float d = a.delta;

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int cnt = 1;
  for (int s = 0; s < steps; ++s) {
    if (a.ert && !(T > a.thr)) break;
    const float t = __fadd_rn(t0, __fmul_rn((float)s, dt));
    const float px = ray_coord(ox, t, dx), py = ray_coord(oy, t, dy),
                pz = ray_coord(oz, t, dz);
    const float v = trilinear(a, px, py, pz);
    const float gx = trilinear(a, px + d, py, pz) - trilinear(a, px - d, py, pz);
    const float gy = trilinear(a, px, py + d, pz) - trilinear(a, px, py - d, pz);
    const float gz = trilinear(a, px, py, pz + d) - trilinear(a, px, py, pz - d);
    const float4 c = tf_lerp<kGlobalTf>(tf, a.R, v);
    const float4 sh = shade<true>(a, c, px, py, pz, gx, gy, gz, dx, dy, dz,
                                  ox, oy, oz);
    r += T * sh.x;
    g += T * sh.y;
    b += T * sh.z;
    T *= 1.0f - sh.w;
    ++cnt;
  }
  reinterpret_cast<float4*>(a.image)[p] = make_float4(r, g, b, 1.0f - T);
  a.steps[p] = cnt;
}

template <bool kGlobalTf>
__global__ void __launch_bounds__(128) march_nondiff_kernel(MarchArgs a) {
  extern __shared__ float4 s_tf[];
  const float4* tf =
      stage_tf<kGlobalTf>(reinterpret_cast<const float4*>(a.tf), a.R, s_tf);
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y * blockDim.y + threadIdx.y;
  if (w >= a.W || h >= a.H) return;
  const long long p = (long long)h * a.W + w;

  const float ox = __ldg(a.origin), oy = __ldg(a.origin + 1),
              oz = __ldg(a.origin + 2);
  const float dx = a.dx[p], dy = a.dy[p], dz = a.dz[p];
  const float t0 = a.t0[p], dt = a.dt[p];
  const int steps = min(a.n[p], a.max_steps);
  const float d = a.delta;

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int visited = 0, shaded = 0;
  for (int s = 0; s < steps; ++s) {
    if (!(T > a.thr)) break;
    ++visited;
    const float t = __fadd_rn(t0, __fmul_rn((float)s, dt));
    const float px = ray_coord(ox, t, dx), py = ray_coord(oy, t, dy),
                pz = ray_coord(oz, t, dz);
    const float4 c = tf_lerp<kGlobalTf>(tf, a.R, trilinear(a, px, py, pz));
    if (!(c.w > a.alpha_skip)) continue;
    ++shaded;
    const float gx = trilinear(a, px + d, py, pz) - trilinear(a, px - d, py, pz);
    const float gy = trilinear(a, px, py + d, pz) - trilinear(a, px, py - d, pz);
    const float gz = trilinear(a, px, py, pz + d) - trilinear(a, px, py, pz - d);
    const float4 sh = shade<false>(a, c, px, py, pz, gx, gy, gz, dx, dy, dz,
                                   ox, oy, oz);
    r += T * sh.x;
    g += T * sh.y;
    b += T * sh.z;
    T *= 1.0f - sh.w;
  }
  reinterpret_cast<float4*>(a.image)[p] =
      make_float4(fminf(1.0f, r), fminf(1.0f, g), fminf(1.0f, b),
                  fminf(1.0f, 1.0f - T));
  a.steps[p] = visited;
  a.shaded[p] = shaded;
}

template <template <bool> class Launch>
static int launch(const MarchArgs* a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->H <= 0 || a->W <= 0) return 0;
  const dim3 block(16, 8);
  const dim3 grid((a->W + block.x - 1) / block.x,
                  (a->H + block.y - 1) / block.y);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->R <= kMaxSharedTexels) {
    Launch<false>::run(grid, block, a->R * sizeof(float4), s, *a);
  } else {
    Launch<true>::run(grid, block, 0, s, *a);
  }
  return (int)cudaGetLastError();
}

template <bool kGlobalTf>
struct LaunchDiff {
  static void run(dim3 g, dim3 b, size_t smem, cudaStream_t s,
                  const MarchArgs& a) {
    march_diff_fwd_kernel<kGlobalTf><<<g, b, smem, s>>>(a);
  }
};

template <bool kGlobalTf>
struct LaunchNondiff {
  static void run(dim3 g, dim3 b, size_t smem, cudaStream_t s,
                  const MarchArgs& a) {
    march_nondiff_kernel<kGlobalTf><<<g, b, smem, s>>>(a);
  }
};

extern "C" int dr_march_diff_fwd(const MarchArgs* a, int device,
                                 void* stream) {
  return launch<LaunchDiff>(a, device, stream);
}

extern "C" int dr_march_nondiff(const MarchArgs* a, int device,
                                void* stream) {
  return launch<LaunchNondiff>(a, device, stream);
}
