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
// shading, which cannot change the composite (zero_skip_exact).  K1 is held
// to 102 registers (5 blocks per SM), K3 to 128 (4).  K3's samples are
// dense along a ray (16 per voxel at the viewer's sampling rate), so it
// keeps the centre's 2x2x2 cell in registers and loads its 8 voxels only
// when the centre's low indices change (the values a fresh load would give:
// exact); it takes the 6 gradient points only when the TF alpha passes
// alpha_skip, through K1's distinct-voxel stencil on the cached cell (fused
// sums).  In the kAnalytic instantiation (RenderConfig.analytic_normals)
// K1 and K3 take the gradient from the centre's cell itself
// (cell_gradient): K1 loads the 8 corners of every sample, even where the
// stencil's compact branch would not hold, and K3 loads nothing beyond its
// cached cell.  With an
// occupancy grid (occupancy.py) it jumps over empty space: at its head
// sample it reads the macrocell's distance d and skips floor((d - 1) *
// cell_world / dt) samples that provably classify at or below alpha_skip
// (jump_from_distance in march_common.cuh), and it does not read the grid
// again while the head stays in a macrocell whose lookup gave no jump (the
// jump depends on d and dt alone).  JAX rounds each jump down to a march
// block so that its blocked composite stays bitwise; K3 composites per
// thread and takes the whole jump.  Positions stay t0 + s*dt from the
// sample index, so a jump lands on the no-skip lattice and the image is
// bitwise K3's without the grid.  No hardware texture
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
//
// kSegment (parity only, no ERT): the march over one X-slab of a sharded
// volume (parallel/volume_sharding.py::segment_march; JAX's
// volume_sharding.py::segment_render).  The ray marches only its eligible
// run of samples (segment_range in march_common.cuh) and writes that run's
// premultiplied composite (r, g, b, 1 - T) and its length.
template <bool kGlobalTf, bool kAnalytic, bool kSegment>
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
  int s0 = 0, steps = min(a.n[p], a.max_steps);
  if constexpr (kSegment) segment_range(a, p, t0, dt, ox, dx, s0, steps);
  const bool zero_skip = zero_skip_exact(a);

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int cnt = kSegment ? 0 : 1, skipped = 0, general = 0;
  for (int s = s0; s < steps; ++s) {
    if (!kSegment && a.ert && !(T > a.thr)) break;
    const Sample q = march_sample<kGlobalTf, kAnalytic, kSegment>(
        a, tf, s, t0, dt, ox, oy, oz, dx, dy, dz, zero_skip);
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

// The centre of a K3 sample at step s: its position and, per axis, the
// voxel coordinate, its low and high indices and its fraction.
struct Centre {
  float px, py, pz, cx, cy, cz, fx, fy, fz;
  int lx, ly, lz, hx, hy, hz;
};

__device__ __forceinline__ Centre centre_at(const MarchArgs& a, int s,
                                            float t0, float dt, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz) {
  Centre q;
  const float t = __fadd_rn(t0, __fmul_rn((float)s, dt));
  q.px = ray_coord(ox, t, dx);
  q.py = ray_coord(oy, t, dy);
  q.pz = ray_coord(oz, t, dz);
  q.fx = voxel_axis(q.px, a.scale_x, a.X, q.lx, q.hx, q.cx);
  q.fy = voxel_axis(q.py, a.scale_y, a.Y, q.ly, q.hy, q.cy);
  q.fz = voxel_axis(q.pz, a.scale_z, a.Z, q.lz, q.hz, q.cz);
  return q;
}

// At least 4 blocks of 128 threads per SM: at most 128 registers a thread
// (5 blocks, 96 registers, spill; 3 blocks take 168; neither was faster).
template <bool kGlobalTf, bool kAnalytic>
__global__ void __launch_bounds__(128, 4) march_nondiff_kernel(MarchArgs a) {
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

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int visited = 0, shaded = 0, cell_loads = 0, extra_loads = 0,
      grid_reads = 0;
  // The centre's 2x2x2 cell (corner order i + 2j + 4k) and the low indices
  // it was loaded at: consecutive samples mostly share it.
  float cell[8];
  int kx = -1, ky = -1, kz = -1;
  // The macrocell of the last lookup that gave no jump: it gives none again.
  int mx = -1, my = -1, mz = -1;
  // With a grid, look up the head's jump at every jump_every-th iteration,
  // except right after a composited sample: that sample's cell is occupied,
  // so the next one's cell is at distance <= 1 (no jump) unless a step
  // crosses a whole cell, and then a lookup skipped costs one sample.  A
  // grid with no cell at distance 2 or more gives no jump: no lookups.
  const bool grid = a.occ != nullptr && __ldg(a.occ_far) >= 2;
  bool look = grid;
  for (int s = 0, it = 0; s < steps; ++s, ++it) {
    if (!(T > a.thr)) break;
    Centre q = centre_at(a, s, t0, dt, ox, oy, oz, dx, dy, dz);
    if (look && it % a.jump_every == 0) {
      const int cx = occ_cell(q.cx, q.lx, a.cell, a.nx);
      const int cy = occ_cell(q.cy, q.ly, a.cell, a.ny);
      const int cz = occ_cell(q.cz, q.lz, a.cell, a.nz);
      if (cx != mx || cy != my || cz != mz) {
        ++grid_reads;
        const int j = jump_from_distance(
            a, __ldg(a.occ + ((long long)cx * a.ny + cy) * a.nz + cz),
            steps - s, dt);
        if (j == 0) {
          mx = cx;
          my = cy;
          mz = cz;
        } else {
          s += j;
          if (s >= steps) break;
          q = centre_at(a, s, t0, dt, ox, oy, oz, dx, dy, dz);
        }
      }
    }
    ++visited;
    if (q.lx != kx || q.ly != ky || q.lz != kz) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cell[k] = voxel(a, k & 1 ? q.hx : q.lx, k & 2 ? q.hy : q.ly,
                        k & 4 ? q.hz : q.lz);
      }
      kx = q.lx;
      ky = q.ly;
      kz = q.lz;
      ++cell_loads;
    }
    const float4 c = tf_lerp<kGlobalTf>(
        tf, a.R,
        point_sum<false>(cell, 1.0f - q.fx, q.fx, 1.0f - q.fy, q.fy,
                         1.0f - q.fz, q.fz));
    look = grid;
    if (!(c.w > a.alpha_skip)) continue;
    look = false;
    ++shaded;
    float gx, gy, gz;
    if constexpr (kAnalytic) {
      cell_gradient<false>(a, cell, q.fx, q.fy, q.fz, gx, gy, gz);
    } else {
      const StencilAxis X = stencil_axis(q.px, a.delta, a.scale_x, a.X);
      const StencilAxis Y = stencil_axis(q.py, a.delta, a.scale_y, a.Y);
      const StencilAxis Z = stencil_axis(q.pz, a.delta, a.scale_z, a.Z);
      extra_loads += stencil_gradient<false>(a, X, Y, Z,
                                             X.ok && Y.ok && Z.ok, cell, q.px,
                                             q.py, q.pz, gx, gy, gz);
    }
    const float4 sh = shade<false>(a, c, opacity(a, c.w), q.px, q.py, q.pz,
                                   gx, gy, gz, dx, dy, dz, ox, oy, oz);
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
  if (a.counts) {
    a.counts[3 * p] = cell_loads;
    a.counts[3 * p + 1] = extra_loads;
    a.counts[3 * p + 2] = grid_reads;
  }
}

template <template <bool, bool> class Launch, bool kAnalytic>
static void launch_tf(const MarchArgs& a, dim3 grid, dim3 block,
                      cudaStream_t s) {
  if (a.R <= kMaxSharedTexels) {
    Launch<false, kAnalytic>::run(grid, block, a.R * sizeof(float4), s, a);
  } else {
    Launch<true, kAnalytic>::run(grid, block, 0, s, a);
  }
}

template <template <bool, bool> class Launch>
static int launch(const MarchArgs* a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->H <= 0 || a->W <= 0) return 0;
  const dim3 block(16, 8);
  const dim3 grid((a->W + block.x - 1) / block.x,
                  (a->H + block.y - 1) / block.y);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->analytic) {
    launch_tf<Launch, true>(*a, grid, block, s);
  } else {
    launch_tf<Launch, false>(*a, grid, block, s);
  }
  return (int)cudaGetLastError();
}

template <bool kGlobalTf, bool kAnalytic>
struct LaunchDiff {
  static void run(dim3 g, dim3 b, size_t smem, cudaStream_t s,
                  const MarchArgs& a) {
    march_diff_fwd_kernel<kGlobalTf, kAnalytic, false><<<g, b, smem, s>>>(a);
  }
};

// The segment instantiation is parity only (JAX's segment takes the
// central-difference stencil whatever analytic_normals says).
template <bool kGlobalTf, bool kAnalytic>
struct LaunchSegment {
  static void run(dim3 g, dim3 b, size_t smem, cudaStream_t s,
                  const MarchArgs& a) {
    march_diff_fwd_kernel<kGlobalTf, false, true><<<g, b, smem, s>>>(a);
  }
};

template <bool kGlobalTf, bool kAnalytic>
struct LaunchNondiff {
  static void run(dim3 g, dim3 b, size_t smem, cudaStream_t s,
                  const MarchArgs& a) {
    march_nondiff_kernel<kGlobalTf, kAnalytic><<<g, b, smem, s>>>(a);
  }
};

extern "C" int dr_march_diff_fwd(const MarchArgs* a, int device,
                                 void* stream) {
  if (a->s_lo) return launch<LaunchSegment>(a, device, stream);
  return launch<LaunchDiff>(a, device, stream);
}

extern "C" int dr_march_nondiff(const MarchArgs* a, int device,
                                void* stream) {
  return launch<LaunchNondiff>(a, device, stream);
}
