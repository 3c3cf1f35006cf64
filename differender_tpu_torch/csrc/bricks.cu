// K4 brick_sums and K5 brick_rows: sums of 32^3 boxes of voxels; K6
// cell_minmax: the occupancy grid's per-macrocell (min, max).
//
// K4 replaces experiments/exp_pallas_dma.py::brick_sum_kernel (launched by
// run_brick_sums): the sum of the B^3 brick of a volume at each origin,
// written to all 128 lanes of the origin's output row.  K5 replaces
// brick_row_kernel (run_brick_rows): the sum of a pre-bricked table entry
// chosen by index, written the same way.  On the TPU each grid step DMAs one
// brick from HBM into VMEM by a scalar-prefetched origin and sums it there.
//
// Out-of-range origins: the Pallas DMA has no defined result for a brick
// that leaves the volume.  K4 and K5 check every origin and write NaN to the
// row of a brick that does not lie wholly inside the volume (or an index
// outside the table); they never clamp it, which would quietly sum another
// brick.  Neither uses float atomics: every partial sum has a fixed slot and
// the slots are added in a fixed order, so a call gives the same bits every
// time.
//
// K4.  Bound on the H100: bytes, the union of the bricks read once (0.017 ms
// for the probe's 2048 bricks on a 256^3 volume).  Bricks at arbitrary
// origins overlap (2048 x 128 KiB is four times the 64 MiB volume), and a
// block per brick reads the overlap from L2 or, since the volume is larger
// than L2, mostly from HBM again.  So K4 tiles the volume, not the bricks:
//   * The volume is cut into aligned tiles (kTile*: 8 x 8 x 256 voxels,
//     64 KiB, three blocks an SM; a brick meets at most 5 x 5 x 2 of them,
//     its slots).  A binning pass lists each tile's bricks in time linear in
//     n + tiles: a count per tile (brick_bin_kernel<false>), an exclusive
//     scan (tile_scan_kernel), a fill (brick_bin_kernel<true>).  A list's
//     order does not matter.
//   * A block per tile copies into shared memory, with cp.async, only the
//     bounding box of its bricks' intersections with the tile: 16-byte
//     copies where rows are 16-byte aligned (Z % 4 == 0 and an aligned
//     base), 4-byte copies otherwise.  Each voxel that some brick covers is
//     read from HBM once; the four-fold re-reading happens in shared memory.
//   * A warp sums one (brick, tile) intersection at a time: a row of the
//     box per step with lanes along z (a row is at most 32 floats, one
//     conflict-free shared load; the 8 rows of an x loaded together, at
//     offsets known to the compiler), then a shuffle tree, into the
//     brick's slot for that tile's position relative to the brick's first
//     tile.
//   * brick_final_kernel adds a brick's slots in a fixed order and writes
//     the sum, or NaN, to its 128 lanes.
// At the probe's 2048 bricks the copies and the sums take about as long,
// one after the other in each block; at more bricks the sums set K4's
// pace: a row costs a shared load and an add a lane, and the row loop is
// kept to those and little else.  Its times beside the bound: PERF.md,
// from chip_smoke.py.
//
// K5.  Bound on the H100: bytes of the distinct bricks (0.063 ms for the
// probe's 1607 distinct bricks of 128 KiB).  A table brick is one contiguous
// run of floats, so:
//   * row_owner_kernel: owner[b] = the least i with idx[i] == b (atomicMin;
//     indices outside [0, NB) are skipped before it).
//   * row_chunk_kernel: only the owner of a brick reads it, in chunks of
//     kChunk floats (four to a 128 KiB brick), thread t
//     reading float4 t, t + 256, ... with eight loads in flight; a partial
//     per (owner, chunk).
//   * row_final_kernel adds the owner's partials in chunk order and writes
//     the sum, or NaN, to all 128 lanes of every row, duplicates included.
//
// K6 replaces the reduce_window pair of differender_tpu/occupancy.py::
// _cell_minmax (an XLA program, not Pallas): per macrocell c the (min, max)
// of the voxels in [c*cell - 1, (c+1)*cell] on each axis, indices clamped to
// [0, size - 1].  The clamp gives exactly the set of values that JAX's two
// edge pads put in the window (the window cut to the volume), and min and
// max are exact, so K6 equals JAX bit for bit.
//
// Bound on the H100: bytes (the volume read once, two floats written per
// macrocell: 0.025 ms at 256^3, cell 2).  Windows overlap (by 2 voxels per
// axis), so a thread per macrocell reads each voxel (1 + 2/cell)^3 times
// with loads `cell` floats apart.  The design reads each voxel from HBM
// about once and reduces it along x before anything else:
//   * A block owns a tile of ty x tz macrocells in (y, z) and a chunk of cx
//     macrocells along x, and streams the x-planes of the chunk's windows
//     (the first and last planes of a chunk are its halo).
//   * Each thread holds 8 voxels of the tile's plane (neighbouring threads
//     on neighbouring z, coalesced loads) and folds every plane into the
//     running (min, max) of the windows along x that are open, in
//     registers: a plane lies in at most two windows (three at cell 1).
//   * When a plane ends a window, the tile's x-reduced plane goes to shared
//     memory and is reduced along z and then y into the tile's cells, one
//     write per cell, neighbouring threads on neighbouring z: cell + 2
//     planes reduced once per cell of x, not once per plane.
// The tiling (ty, tz, cx) is chosen by the wrapper (ops/bricks.py::
// k6_plan): at most 64 voxels along z and 2048 a plane (256 threads x 8),
// chunks along x for three blocks an SM.  Reads beyond the volume: the
// y/z halo of each tile and the x halo of each chunk (1.2x at cell 2,
// 256^3, most of them L2 hits of a neighbour's planes).  A tile larger
// than 2048 voxels a plane (one cell from cell 44 on) is taken in bands.
// Its times beside the bound: PERF.md, from chip_smoke.py.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kLanes = 128;        // output lanes per brick (the TPU's row)
constexpr int kBrick = 32;         // K4's brick edge (exp_pallas_dma.py:36)
constexpr int kThreads = 256;      // K4's and K5's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
// K4's tiles (ops/bricks.py::K4_TILE): 64 KiB of shared memory, three
// blocks an SM; a brick meets at most kSlots of them.
constexpr int kTileX = 8;
constexpr int kTileY = 8;
constexpr int kTileZ = 256;
constexpr int kTileFloats = kTileX * kTileY * kTileZ;
constexpr int kSlotsX = (kBrick - 2) / kTileX + 2;
constexpr int kSlotsY = (kBrick - 2) / kTileY + 2;
constexpr int kSlotsZ = (kBrick - 2) / kTileZ + 2;
constexpr int kSlots = kSlotsX * kSlotsY * kSlotsZ;
// K5's chunk of a brick (ops/bricks.py::K5_CHUNK): 32 KiB, four to a 32^3
// brick.
constexpr int kChunk = 8192;
constexpr int kChunkLoads = 8;     // K5: float4 loads in flight a thread
constexpr int kCellThreads = 256;
constexpr int kCellSlots = 8;       // K6: voxels of a band per thread
constexpr int kCellBand = kCellThreads * kCellSlots;

__device__ __forceinline__ float warp_sum(float s) {
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  return s;
}

// Row i of the output: s in all 128 lanes, a float4 per lane of the warp.
__device__ __forceinline__ void write_lanes(float* out, long long i, float s,
                                            int lane) {
  reinterpret_cast<float4*>(out + i * kLanes)[lane] = make_float4(s, s, s, s);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K4's volume and its tiles per axis.
struct Tiling {
  int X, Y, Z;
  int ntx, nty, ntz;
};

__device__ __forceinline__ bool brick_inside(const Tiling& g, int3 o) {
  return o.x >= 0 && o.y >= 0 && o.z >= 0 && o.x <= g.X - kBrick &&
         o.y <= g.Y - kBrick && o.z <= g.Z - kBrick;
}

__device__ __forceinline__ int3 load_origin(const int* __restrict__ origins,
                                            int i) {
  return make_int3(__ldg(origins + 3 * i), __ldg(origins + 3 * i + 1),
                   __ldg(origins + 3 * i + 2));
}

// The tiles a brick at o meets along each axis.
__device__ __forceinline__ int3 tiles_met(int3 o) {
  return make_int3((o.x + kBrick - 1) / kTileX - o.x / kTileX + 1,
                   (o.y + kBrick - 1) / kTileY - o.y / kTileY + 1,
                   (o.z + kBrick - 1) / kTileZ - o.z / kTileZ + 1);
}

// K4's binning: thread (i, s) takes slot s = (dx * kSlotsY + dy) * kSlotsZ
// + dz of brick i, the tile at (dx, dy, dz) from the brick's first tile, if
// the brick is inside and meets it; kFill = false counts the tile's
// bricks, true lists brick i at the tile's cursor (the scan's start, moved
// on by each entry).
template <bool kFill>
__global__ void __launch_bounds__(kThreads)
    brick_bin_kernel(const int* __restrict__ origins, int n, Tiling g,
                     int* counts, int* cursor, int* list) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n * kSlots) return;
  const int i = k / kSlots, s = k % kSlots;
  const int3 o = load_origin(origins, i);
  const int dx = s / (kSlotsY * kSlotsZ), dy = s / kSlotsZ % kSlotsY,
            dz = s % kSlotsZ;
  const int3 met = tiles_met(o);
  if (!brick_inside(g, o) || dx >= met.x || dy >= met.y || dz >= met.z) {
    return;
  }
  const int t = ((o.x / kTileX + dx) * g.nty + o.y / kTileY + dy) * g.ntz +
                o.z / kTileZ + dz;
  if (kFill) {
    list[atomicAdd(cursor + t, 1)] = i;
  } else {
    atomicAdd(counts + t, 1);
  }
}

// Exclusive scan of the tiles' counts into cursor, one block: thread t sums
// a run of consecutive tiles, the runs are scanned across the block.
__global__ void __launch_bounds__(kScanThreads)
    tile_scan_kernel(const int* __restrict__ counts, int tiles, int* cursor) {
  __shared__ int s_warp[kScanThreads / 32];
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int a = min((int)threadIdx.x * per, tiles);
  const int b = min(a + per, tiles);
  int run = 0;
  for (int t = a; t < b; ++t) run += counts[t];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = run;   // inclusive scan within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int start = v - run + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int t = a; t < b; ++t) {
    cursor[t] = start;
    start += counts[t];
  }
}

// The intersection of brick o with the tile at org of extent ext, in tile
// coordinates, half-open: [lo, hi).
__device__ __forceinline__ void intersect(int3 o, int3 org, int3 ext,
                                          int3& lo, int3& hi) {
  lo = make_int3(max(o.x - org.x, 0), max(o.y - org.y, 0),
                 max(o.z - org.z, 0));
  hi = make_int3(min(o.x + kBrick - org.x, ext.x),
                 min(o.y + kBrick - org.y, ext.y),
                 min(o.z + kBrick - org.z, ext.z));
}

// K4: block t takes tile t of the binning.  Entries of its list are staged
// in shared memory kThreads at a time (brick and origin); the bounding box
// of the list's intersections with the tile is copied in once; then each
// warp sums whole intersections into their slots.  Shared memory: the
// tile, row (x, y) at (x * kTileY + y) * kTileZ.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    brick_tile_kernel(const float* __restrict__ vol,
                      const int* __restrict__ origins, Tiling g,
                      const int* __restrict__ counts,
                      const int* __restrict__ cursor,
                      const int* __restrict__ list,
                      float* __restrict__ partial) {
  extern __shared__ float4 s_dyn[];
  float* tile = reinterpret_cast<float*>(s_dyn);
  __shared__ int4 s_entry[kThreads];   // (brick, x0, y0, z0)
  __shared__ int s_box[6];
  const int t = blockIdx.x;
  const int cnt = counts[t];
  if (cnt == 0) return;
  const int first = cursor[t] - cnt;
  const int3 it = make_int3(t / (g.nty * g.ntz), t / g.ntz % g.nty,
                            t % g.ntz);
  const int3 org = make_int3(it.x * kTileX, it.y * kTileY, it.z * kTileZ);
  const int3 ext = make_int3(min(kTileX, g.X - org.x),
                             min(kTileY, g.Y - org.y),
                             min(kTileZ, g.Z - org.z));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 6) s_box[threadIdx.x] = threadIdx.x < 3 ? INT_MAX : 0;
  __syncthreads();

  // The bounding box of all the list's intersections; the first kThreads
  // entries staged.
  int3 blo = make_int3(INT_MAX, INT_MAX, INT_MAX), bhi = make_int3(0, 0, 0);
  for (int j = threadIdx.x; j < cnt; j += kThreads) {
    const int i = list[first + j];
    const int3 o = load_origin(origins, i);
    if (j < kThreads) s_entry[j] = make_int4(i, o.x, o.y, o.z);
    int3 lo, hi;
    intersect(o, org, ext, lo, hi);
    blo = make_int3(min(blo.x, lo.x), min(blo.y, lo.y), min(blo.z, lo.z));
    bhi = make_int3(max(bhi.x, hi.x), max(bhi.y, hi.y), max(bhi.z, hi.z));
  }
  for (int d = 16; d > 0; d >>= 1) {
    blo.x = min(blo.x, __shfl_xor_sync(0xffffffffu, blo.x, d));
    blo.y = min(blo.y, __shfl_xor_sync(0xffffffffu, blo.y, d));
    blo.z = min(blo.z, __shfl_xor_sync(0xffffffffu, blo.z, d));
    bhi.x = max(bhi.x, __shfl_xor_sync(0xffffffffu, bhi.x, d));
    bhi.y = max(bhi.y, __shfl_xor_sync(0xffffffffu, bhi.y, d));
    bhi.z = max(bhi.z, __shfl_xor_sync(0xffffffffu, bhi.z, d));
  }
  if (lane == 0) {
    atomicMin(s_box + 0, blo.x);
    atomicMin(s_box + 1, blo.y);
    atomicMin(s_box + 2, blo.z);
    atomicMax(s_box + 3, bhi.x);
    atomicMax(s_box + 4, bhi.y);
    atomicMax(s_box + 5, bhi.z);
  }
  __syncthreads();

  // Copy the box in: a warp per row, lanes along z.  The 16-byte route
  // widens the box's z range to multiples of 4 (within the tile: Z and so
  // ext.z are multiples of 4 there).
  const int bx0 = s_box[0], by0 = s_box[1], wy = s_box[4] - by0;
  const int bz0 = kVec ? s_box[2] & ~3 : s_box[2];
  const int bz1 = kVec ? (s_box[5] + 3) & ~3 : s_box[5];
  const int rows = (s_box[3] - bx0) * wy;
  for (int r = warp; r < rows; r += kWarps) {
    const int lx = bx0 + r / wy, ly = by0 + r % wy;
    const float* src =
        vol + ((long long)(org.x + lx) * g.Y + org.y + ly) * g.Z + org.z;
    float* dst = tile + (lx * kTileY + ly) * kTileZ;
    if (kVec) {
      for (int z = bz0 + 4 * lane; z < bz1; z += 128) {
        cp_async16(dst + z, src + z);
      }
    } else {
      for (int z = bz0 + lane; z < bz1; z += 32) {
        cp_async4(dst + z, src + z);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int j0 = 0; j0 < cnt; j0 += kThreads) {
    if (j0 > 0) {
      __syncthreads();
      const int j = j0 + threadIdx.x;
      if (j < cnt) {
        const int i = list[first + j];
        const int3 o = load_origin(origins, i);
        s_entry[threadIdx.x] = make_int4(i, o.x, o.y, o.z);
      }
      __syncthreads();
    }
    const int m = min(kThreads, cnt - j0);
    for (int jj = warp; jj < m; jj += kWarps) {
      const int4 e = s_entry[jj];
      const int3 o = make_int3(e.y, e.z, e.w);
      int3 lo, hi;
      intersect(o, org, ext, lo, hi);
      // Lane l sums column lo.z + l of the box's rows in (x, y) order, the
      // kTileY rows of an x loaded ahead of their adds; a row is at most 32
      // floats.
      float acc = 0.0f;
      if (lane < hi.z - lo.z) {
        const float* p = tile + lo.x * (kTileY * kTileZ) + lo.z + lane;
        for (int lx = lo.x; lx < hi.x; ++lx, p += kTileY * kTileZ) {
          float v[kTileY];
#pragma unroll
          for (int u = 0; u < kTileY; ++u) {
            v[u] = u >= lo.y && u < hi.y ? p[u * kTileZ] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kTileY; ++u) acc += v[u];
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const int slot = ((it.x - o.x / kTileX) * kSlotsY +
                          it.y - o.y / kTileY) * kSlotsZ +
                         it.z - o.z / kTileZ;
        partial[(long long)e.x * kSlots + slot] = acc;
      }
    }
  }
}

// K4's last pass: a warp per brick adds the slots it meets in slot order,
// which is (dx, dy, dz) order; every lane loads them (broadcasts).
__global__ void __launch_bounds__(kThreads)
    brick_final_kernel(const int* __restrict__ origins, int n, Tiling g,
                       const float* __restrict__ partial,
                       float* __restrict__ out) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (i >= n) return;
  const int3 o = load_origin(origins, (int)i);
  float s = NAN;
  if (brick_inside(g, o)) {
    const int3 met = tiles_met(o);
    const float* p = partial + i * kSlots;
    float v[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const bool on = k / (kSlotsY * kSlotsZ) < met.x &&
                      k / kSlotsZ % kSlotsY < met.y && k % kSlotsZ < met.z;
      v[k] = on ? p[k] : 0.0f;
    }
    s = 0.0f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) s += v[k];
  }
  write_lanes(out, i, s, threadIdx.x & 31);
}

// K5: owner[b] = min i with idx[i] == b, owner filled with INT_MAX-like
// bytes (0x7f7f7f7f) beforehand.
__global__ void __launch_bounds__(kThreads)
    row_owner_kernel(const int* __restrict__ idx, int n, int nb, int* owner) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int b = __ldg(idx + i);
  if (b >= 0 && b < nb) atomicMin(owner + b, i);
}

// K5: block (i, c) sums chunk c of brick idx[i] if i owns it, into
// partial[i * chunks + c]; per-thread sums in load order, a shuffle tree,
// the warps' sums in order.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    row_chunk_kernel(const float* __restrict__ bricks, long long len, int nb,
                     int chunks, const int* __restrict__ idx,
                     const int* __restrict__ owner,
                     float* __restrict__ partial) {
  __shared__ float s_warp[kWarps];
  const int i = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int b = __ldg(idx + i);
  if (b < 0 || b >= nb || __ldg(owner + b) != i) return;
  const long long a = (long long)c * kChunk;
  const int m = (int)min((long long)kChunk, len - a);
  const float* p = bricks + b * len + a;
  float s = 0.0f;
  if (kVec) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const int m4 = m / 4;
    for (int k0 = threadIdx.x; k0 < m4; k0 += kChunkLoads * kThreads) {
      float4 v[kChunkLoads];
#pragma unroll
      for (int u = 0; u < kChunkLoads; ++u) {
        const int k = k0 + u * kThreads;
        v[u] = k < m4 ? __ldg(q + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kChunkLoads; ++u) {
        s += v[u].x;
        s += v[u].y;
        s += v[u].z;
        s += v[u].w;
      }
    }
  } else {
    for (int k0 = threadIdx.x; k0 < m; k0 += kChunkLoads * kThreads) {
      float v[kChunkLoads];
#pragma unroll
      for (int u = 0; u < kChunkLoads; ++u) {
        const int k = k0 + u * kThreads;
        v[u] = k < m ? __ldg(p + k) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kChunkLoads; ++u) s += v[u];
    }
  }
  s = warp_sum(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float w = 0.0f;
    for (int k = 0; k < kWarps; ++k) w += s_warp[k];
    partial[(long long)i * chunks + c] = w;
  }
}

// K5's last pass: a warp per row j adds the partials of idx[j]'s owner in
// chunk order.
__global__ void __launch_bounds__(kThreads)
    row_final_kernel(const int* __restrict__ idx, int n, int nb,
                     const int* __restrict__ owner,
                     const float* __restrict__ partial, int chunks,
                     float* __restrict__ out) {
  const long long j = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (j >= n) return;
  const int b = __ldg(idx + j);
  float s = NAN;
  if (b >= 0 && b < nb) {
    const float* p = partial + (long long)__ldg(owner + b) * chunks;
    s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += p[c];
  }
  write_lanes(out, j, s, threadIdx.x & 31);
}

// K6: block b takes the tile (ty0, tz0) of ty x tz cells in (y, z) and the
// cells [cx0, cx1) along x.  The tile's voxel rows and columns (its cells'
// windows, cut to the volume) are split into bands of at most `slots`
// voxels (one band up to cell 43 at the plan's tiles), and for each band:
//   * thread t holds voxels t + k * kCellThreads, k < kCellSlots, of the
//     band (neighbouring threads on neighbouring columns), and for each the
//     (min, max) of the windows along x that are open: A for cell cur, B for
//     cur + 1, C for cur + 2 (kThree: cell 1 only; from cell 2 on a plane
//     lies in at most two windows).  The planes of the chunk stream through
//     registers, each loaded while the one before it is folded.
//   * When a plane ends cur's window, A goes to shared memory, is reduced
//     along z into (row, cell) and then along y into the band's cells, and
//     the ring moves on.  A cell that several bands meet is combined in the
//     output, the first band writing it.
template <bool kThree>
__global__ void __launch_bounds__(kCellThreads, kThree ? 2 : 3)
    cell_minmax_kernel(const float* __restrict__ vol, int X, int Y, int Z,
                       int cell, int nx, int ny, int nz, int ty, int tz,
                       int cx, int slots, float* lo, float* hi) {
  __shared__ float w_lo[kCellBand], w_hi[kCellBand];  // a band's window
  __shared__ float r_lo[kCellBand], r_hi[kCellBand];  // ... along z

  const int tiles_z = (nz + tz - 1) / tz, tiles_y = (ny + ty - 1) / ty;
  int b = blockIdx.x;
  const int tz0 = (b % tiles_z) * tz;
  b /= tiles_z;
  const int ty0 = (b % tiles_y) * ty;
  const int cx0 = (b / tiles_y) * cx;
  const int ncy = min(ty, ny - ty0), ncz = min(tz, nz - tz0);
  const int cx1 = min(cx0 + cx, nx);
  const int y0 = max(ty0 * cell - 1, 0);
  const int rows = min((ty0 + ncy) * cell, Y - 1) - y0 + 1;
  const int z0 = max(tz0 * cell - 1, 0);
  const int cols = min((tz0 + ncz) * cell, Z - 1) - z0 + 1;
  const int p0 = max(cx0 * cell - 1, 0), p1 = min(cx1 * cell, X - 1);
  const int nq = min(cols, slots), nr = max(1, min(rows, slots / nq));
  const long long plane = (long long)Y * Z;

  // Cells of the tile on threads: (t >> lg) in y (or in a z-reduced row),
  // t & (2^lg - 1) in z.
  int lg = 0;
  while ((1 << lg) < ncz) ++lg;
  const int cz = threadIdx.x & ((1 << lg) - 1), step = kCellThreads >> lg;
  const int gz = tz0 + cz;
  const int za = max(gz * cell - 1, 0) - z0;
  const int zz = min((gz + 1) * cell, Z - 1) - z0;

  for (int br = 0; br < rows; br += nr) {
    for (int bq = 0; bq < cols; bq += nq) {
      const int hr = min(nr, rows - br), hq = min(nq, cols - bq);
      const int nvox = hr * hq;
      // This thread's voxels of the band; a slot past the band re-reads
      // the band's first voxel and is never stored.
      int off[kCellSlots];
      float v[kCellSlots], a_lo[kCellSlots], a_hi[kCellSlots];
      float b_lo[kCellSlots], b_hi[kCellSlots];
      float c_lo[kCellSlots], c_hi[kCellSlots];   // kThree only
#pragma unroll
      for (int k = 0; k < kCellSlots; ++k) {
        const int i = threadIdx.x + k * kCellThreads;
        const int r = i < nvox ? i / hq : 0, q = i < nvox ? i % hq : 0;
        off[k] = (y0 + br + r) * Z + z0 + bq + q;
        v[k] = __ldg(vol + p0 * plane + off[k]);
        a_lo[k] = b_lo[k] = INFINITY;
        a_hi[k] = b_hi[k] = -INFINITY;
        if (kThree) {
          c_lo[k] = INFINITY;
          c_hi[k] = -INFINITY;
        }
      }
      int cur = cx0;
      for (int p = p0; p <= p1; ++p) {
        float nv[kCellSlots];
        const long long pn = min(p + 1, p1) * plane;
#pragma unroll
        for (int k = 0; k < kCellSlots; ++k) nv[k] = __ldg(vol + pn + off[k]);
        const bool in_b = p >= (cur + 1) * cell - 1;
        const bool in_c = kThree && p >= (cur + 2) * cell - 1;
#pragma unroll
        for (int k = 0; k < kCellSlots; ++k) {
          const float x = v[k];
          a_lo[k] = fminf(a_lo[k], x);
          a_hi[k] = fmaxf(a_hi[k], x);
          if (in_b) {
            b_lo[k] = fminf(b_lo[k], x);
            b_hi[k] = fmaxf(b_hi[k], x);
          }
          if (kThree && in_c) {
            c_lo[k] = fminf(c_lo[k], x);
            c_hi[k] = fmaxf(c_hi[k], x);
          }
          v[k] = nv[k];
        }
        // Every cell whose window ends at p (two at the far face, where the
        // clamp ends both at X - 1): reduce A over its cells, move on.
        while (cur < cx1 && p == min((cur + 1) * cell, X - 1)) {
#pragma unroll
          for (int k = 0; k < kCellSlots; ++k) {
            const int i = threadIdx.x + k * kCellThreads;
            if (i < nvox) {
              w_lo[i] = a_lo[k];
              w_hi[i] = a_hi[k];
            }
          }
          __syncthreads();
          // Along z: band row r, cell cz, over the window's columns in
          // the band.
          const int qa = max(za, bq) - bq, qz = min(zz, bq + hq - 1) - bq;
          if (cz < ncz) {
            for (int r = threadIdx.x >> lg; r < hr; r += step) {
              float l = INFINITY, h = -INFINITY;
              for (int q = qa; q <= qz; ++q) {
                l = fminf(l, w_lo[r * hq + q]);
                h = fmaxf(h, w_hi[r * hq + q]);
              }
              r_lo[r * ncz + cz] = l;
              r_hi[r * ncz + cz] = h;
            }
          }
          __syncthreads();
          // Along y: cell (cy, cz) over the window's rows in the band.
          if (cz < ncz && qa <= qz) {
            for (int cy = threadIdx.x >> lg; cy < ncy; cy += step) {
              const int gy = ty0 + cy;
              const int ra = max(gy * cell - 1, 0) - y0;
              const int rz = min((gy + 1) * cell, Y - 1) - y0;
              const int r0 = max(ra, br) - br, r1 = min(rz, br + hr - 1) - br;
              if (r0 > r1) continue;
              float l = INFINITY, h = -INFINITY;
              for (int r = r0; r <= r1; ++r) {
                l = fminf(l, r_lo[r * ncz + cz]);
                h = fmaxf(h, r_hi[r * ncz + cz]);
              }
              const long long o = ((long long)cur * ny + gy) * nz + gz;
              if (ra >= br && za >= bq) {   // the first band of this cell
                lo[o] = l;
                hi[o] = h;
              } else {
                lo[o] = fminf(lo[o], l);
                hi[o] = fmaxf(hi[o], h);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < kCellSlots; ++k) {
            a_lo[k] = b_lo[k];
            a_hi[k] = b_hi[k];
            if (kThree) {
              b_lo[k] = c_lo[k];
              b_hi[k] = c_hi[k];
              c_lo[k] = INFINITY;
              c_hi[k] = -INFINITY;
            } else {
              b_lo[k] = INFINITY;
              b_hi[k] = -INFINITY;
            }
          }
          ++cur;
        }
      }
    }
  }
}

}  // namespace

// Returns from a C entry on a refused launch.
#define DR_LAUNCHED()                          \
  do {                                         \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// K4.  scratch holds `words` 4-byte words: the tiles' counts and cursors,
// then n * kSlots list entries and n * kSlots partial sums
// (ops/bricks.py::k4_plan).
extern "C" int dr_brick_sums(const float* vol, int X, int Y, int Z,
                             const int* origins, int n, int* scratch,
                             long long words, float* out, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (X < 1 || Y < 1 || Z < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const Tiling g{X, Y, Z, (X + kTileX - 1) / kTileX,
                 (Y + kTileY - 1) / kTileY, (Z + kTileZ - 1) / kTileZ};
  const long long tiles = (long long)g.ntx * g.nty * g.ntz;
  const long long pairs = (long long)n * kSlots;
  if (tiles > INT_MAX || pairs > INT_MAX || words < 2 * tiles + 2 * pairs) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  int* counts = scratch;
  int* cursor = counts + tiles;
  int* list = cursor + tiles;
  float* partial = reinterpret_cast<float*>(list + pairs);
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(counts, 0, tiles * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned bin_blocks = (unsigned)((pairs + kThreads - 1) / kThreads);
  brick_bin_kernel<false><<<bin_blocks, kThreads, 0, s>>>(
      origins, n, g, counts, cursor, list);
  DR_LAUNCHED();
  tile_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, (int)tiles, cursor);
  DR_LAUNCHED();
  brick_bin_kernel<true><<<bin_blocks, kThreads, 0, s>>>(
      origins, n, g, counts, cursor, list);
  DR_LAUNCHED();
  const bool vec = Z % 4 == 0 && (reinterpret_cast<uintptr_t>(vol) & 15) == 0;
  auto tile_kernel = vec ? brick_tile_kernel<true> : brick_tile_kernel<false>;
  constexpr int smem = kTileFloats * sizeof(float);
  err = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<(unsigned)tiles, kThreads, smem, s>>>(
      vol, origins, g, counts, cursor, list, partial);
  DR_LAUNCHED();
  brick_final_kernel<<<(unsigned)((n + kWarps - 1) / kWarps), kThreads, 0,
                       s>>>(origins, n, g, partial, out);
  DR_LAUNCHED();
  return 0;
}

// K5 on a table of nb bricks of len floats each, in chunks of kChunk
// floats.  scratch holds `words` 4-byte words: the owners (nb), then
// n * chunks partial sums (ops/bricks.py::k5_plan).
extern "C" int dr_brick_rows(const float* bricks, int nb, long long len,
                             const int* idx, int n, int* scratch,
                             long long words, float* out, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 0 || len < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const long long chunks = (len + kChunk - 1) / kChunk;
  if (chunks * n > INT_MAX || n >= 0x7f7f7f7f ||
      words < nb + chunks * n) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  int* owner = scratch;
  float* partial = reinterpret_cast<float*>(owner + nb);
  cudaStream_t s = (cudaStream_t)stream;
  if (nb > 0) {   // 0x7f7f7f7f: above every row index
    err = cudaMemsetAsync(owner, 0x7f, (size_t)nb * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  row_owner_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      idx, n, nb, owner);
  DR_LAUNCHED();
  const bool vec = len % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(bricks) & 15) == 0;
  auto chunk_kernel = vec ? row_chunk_kernel<true> : row_chunk_kernel<false>;
  chunk_kernel<<<(unsigned)(chunks * n), kThreads, 0, s>>>(
      bricks, len, nb, (int)chunks, idx, owner, partial);
  DR_LAUNCHED();
  row_final_kernel<<<(unsigned)((n + kWarps - 1) / kWarps), kThreads, 0,
                     s>>>(idx, n, nb, owner, partial, (int)chunks, out);
  DR_LAUNCHED();
  return 0;
}

// K6 with the tiling (ty, tz, cx) and band size (slots) of ops/bricks.py::
// k6_plan.
extern "C" int dr_cell_minmax(const float* vol, int X, int Y, int Z, int cell,
                              int ty, int tz, int cx, int slots, float* lo,
                              float* hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cell < 1 || ty < 1 || tz < 1 || tz > kCellThreads || cx < 1 ||
      slots < 1 || slots > kCellBand || (long long)Y * Z > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int nx = (X + cell - 1) / cell, ny = (Y + cell - 1) / cell,
            nz = (Z + cell - 1) / cell;
  if ((long long)nx * ny * nz <= 0) return 0;
  const long long blocks = (long long)((ny + ty - 1) / ty) *
                           ((nz + tz - 1) / tz) * ((nx + cx - 1) / cx);
  cudaStream_t s = (cudaStream_t)stream;
  if (cell == 1) {
    cell_minmax_kernel<true><<<(unsigned)blocks, kCellThreads, 0, s>>>(
        vol, X, Y, Z, cell, nx, ny, nz, ty, tz, cx, slots, lo, hi);
  } else {
    cell_minmax_kernel<false><<<(unsigned)blocks, kCellThreads, 0, s>>>(
        vol, X, Y, Z, cell, nx, ny, nz, ty, tz, cx, slots, lo, hi);
  }
  return (int)cudaGetLastError();
}
