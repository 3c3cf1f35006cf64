// K1 march_diff_fwd and K3 march_nondiff: one thread per ray.
//
// Replaces the march of differender_tpu/render.py: march_diff (forward) and
// march_nondiff.  On the TPU these are XLA programs shaped around gather
// cost: supercell tables (sampling.py::sample_super_parity), the MXU-dot TF
// lookup (sampling.py::_apply_tf_dot2_p), the closed-form block composite
// (render.py::composite_block_soa) and alive-ray compaction.  Here each
// thread marches its ray front to back, as the reference renderer does:
// per sample it computes the position, the value and the central-difference
// gradient (7 trilinear points), the TF lerp (tf_lerp.cuh), opacity
// correction, headlight shading and the composite, and it stops at its own
// early ray termination (ERT).
//
// Bound on the H100: operations.  At the bench workload the volume (64 MiB)
// is read once in the byte count, but a shaded sample needs ~350 f32
// operations, so the f32 rate bounds the work.  In practice the
// data-addressed loads (latency, L1/L2 hit rate, load instructions issued)
// decide the time.  What the design does about it: blocks cover 16x8 pixel
// tiles so the rays of a warp walk neighbouring voxels and share cache
// lines; the TF sits in shared memory; the transmittance is carried
// multiplicatively and each thread exits at ERT.  K1 loads each distinct
// voxel of a sample's stencil once, 8 to 20 of them in place of 56 (the
// compact branch in march_common.cuh), and a sample whose opacity is
// exactly 0 loads only the centre's cell and skips the gradient and the
// shading, which cannot change the composite (zero_skip_exact).  Held to
// 102 registers (5 blocks per SM).  K3 keeps 7 points of 8 loads; it
// samples the 6 gradient points only when the TF alpha passes alpha_skip,
// and with an occupancy grid (occupancy.py) it jumps over empty space: at
// its head sample it reads the macrocell's distance d and skips
// floor((d - 1) * cell_world / dt) samples that provably classify at or
// below alpha_skip (occupancy_jump in march_common.cuh).  JAX rounds each
// jump down to a march block so that its blocked composite stays bitwise;
// K3 composites per thread and takes the whole jump.  Positions stay
// t0 + s*dt from the sample index, so a jump lands on the no-skip lattice and
// the image is bitwise K3's without the grid.  No hardware texture
// filtering: its 8-bit weights would break parity with the f32 weights of
// the reference.
//
// Semantics held to (differender_tpu line refs):
//   positions t = t0 + s*dt, p = origin + t*d            (render.py:220-229)
//   voxel coords clamp(0.5p+0.5,0,1)*scale, high clamp   (sampling.py:38-96)
//   ERT gate T > f32(1 - ert_threshold), valid_steps from 1 (render.py:347-367,551)
//   nondiff: no max_samples cap, alpha_skip gate, no light clamp, min(1, .)
//                                                        (render.py:716-745)
#include <cuda_runtime.h>

#include "march_common.cuh"

// At least 5 blocks of 128 threads per SM: at most 102 registers a thread
// (nvcc's own choice is 113, 4 blocks, a little slower).
template <bool kGlobalTf>
__global__ void __launch_bounds__(128, 5)
    march_diff_fwd_kernel(MarchArgs a) {
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
  const bool zero_skip = zero_skip_exact(a);

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int cnt = 1, skipped = 0, general = 0;
  for (int s = 0; s < steps; ++s) {
    if (a.ert && !(T > a.thr)) break;
    const Sample q = march_sample<kGlobalTf>(a, tf, s, t0, dt, ox, oy, oz,
                                             dx, dy, dz, zero_skip);
    ++cnt;
    general += !q.compact;
    // A zero sample composites r += T * 0, T *= 1: nothing changes.
    if (q.zero) {
      ++skipped;
      continue;
    }
    r += T * q.sh.x;
    g += T * q.sh.y;
    b += T * q.sh.z;
    T *= 1.0f - q.sh.w;
  }
  reinterpret_cast<float4*>(a.image)[p] = make_float4(r, g, b, 1.0f - T);
  a.steps[p] = cnt;
  if (a.shaded) {
    a.shaded[2 * p] = skipped;
    a.shaded[2 * p + 1] = general;
  }
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
  // With a grid, look up the head's jump at every jump_every-th iteration,
  // except right after a composited sample: that sample's cell is occupied,
  // so the next one's cell is at distance <= 1 (no jump) unless a step
  // crosses a whole cell, and then a lookup skipped costs one sample.  A
  // grid with no cell at distance 2 or more gives no jump: no lookups.
  const bool grid = a.occ != nullptr && __ldg(a.occ_far) >= 2;
  bool look = grid;
  for (int s = 0, it = 0; s < steps; ++s, ++it) {
    if (!(T > a.thr)) break;
    if (look && it % a.jump_every == 0) {
      s += occupancy_jump(a, s, steps - s, t0, dt, ox, oy, oz, dx, dy, dz);
      if (s >= steps) break;
    }
    ++visited;
    const float t = __fadd_rn(t0, __fmul_rn((float)s, dt));
    const float px = ray_coord(ox, t, dx), py = ray_coord(oy, t, dy),
                pz = ray_coord(oz, t, dz);
    const float4 c =
        tf_lerp<kGlobalTf>(tf, a.R, trilinear<false>(a, px, py, pz));
    look = grid;
    if (!(c.w > a.alpha_skip)) continue;
    look = false;
    ++shaded;
    const float gx = trilinear<false>(a, px + d, py, pz) -
                     trilinear<false>(a, px - d, py, pz);
    const float gy = trilinear<false>(a, px, py + d, pz) -
                     trilinear<false>(a, px, py - d, pz);
    const float gz = trilinear<false>(a, px, py, pz + d) -
                     trilinear<false>(a, px, py, pz - d);
    const float4 sh = shade<false>(a, c, opacity(a, c.w), px, py, pz, gx, gy,
                                   gz, dx, dy, dz, ox, oy, oz);
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
