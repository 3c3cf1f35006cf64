// K4 brick_sums and K5 brick_rows: sums of boxes of voxels, through one
// row-reduce device function (reduce_rows); K6 cell_minmax: the occupancy
// grid's per-macrocell (min, max), a kernel of its own.
//
// K4 replaces experiments/exp_pallas_dma.py::brick_sum_kernel (launched by
// run_brick_sums): the sum of the B^3 brick of a volume at each origin,
// written to all 128 lanes of the origin's output row.  K5 replaces
// brick_row_kernel (run_brick_rows): the sum of a pre-bricked row block
// chosen by index, written the same way.  On the TPU each grid step DMAs one
// brick from HBM into VMEM by a scalar-prefetched origin and sums it there.
// Here one CTA takes one brick, loads its own origin, and its threads stride
// over the brick's rows (runs of contiguous floats); per-thread sums, a warp
// shuffle, a shared-memory sum across warps, one write of the 128 lanes.
// K5 is K4 on the table viewed as a (NB, rows, cols) volume with the origin
// (idx, 0, 0), so both are one kernel template.  Bound on the H100: bytes.
// K4 and K5 read each brick once (128 KiB at B = 32) and do one add per
// float.  Rows are read with 16-byte loads once their address is 16-byte
// aligned; a row that starts unaligned (K4 at an origin with z0 % 4 != 0)
// takes scalar loads up to the first aligned float.
//
// Out-of-range origins: the Pallas DMA has no defined result for a brick
// that leaves the volume.  K4 and K5 check every origin and write NaN to the
// row of a brick that does not lie wholly inside the volume (or table); they
// never clamp it, which would quietly sum another brick.
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
constexpr int kBrickThreads = 256;
constexpr int kCellThreads = 256;
constexpr int kCellSlots = 8;       // K6: voxels of a band per thread
constexpr int kCellBand = kCellThreads * kCellSlots;

struct SumAcc {
  float s = 0.0f;
  __device__ __forceinline__ void operator()(float v) { s += v; }
};

// Feeds the floats p[0 .. len) to acc: scalar loads up to the first 16-byte
// aligned address, then float4 loads, then the scalar tail.
template <class Acc>
__device__ __forceinline__ void reduce_row(const float* p, int len, Acc& acc) {
  int k = 0;
  while (k < len && (reinterpret_cast<uintptr_t>(p + k) & 15)) {
    acc(__ldg(p + k));
    ++k;
  }
  for (; k + 4 <= len; k += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + k));
    acc(v.x);
    acc(v.y);
    acc(v.z);
    acc(v.w);
  }
  for (; k < len; ++k) acc(__ldg(p + k));
}

// The rows r = first, first + step, ... < wx*wy of the box
// [x0, x0+wx) x [y0, y0+wy) x [z0, z0+wz) of a (., Y, Z) volume; row r is
// (x0 + r / wy, y0 + r % wy, z0 .. z0+wz).  K4/K5 split a brick's rows over
// a CTA (step = blockDim.x).
template <class Acc>
__device__ __forceinline__ void reduce_rows(const float* vol, int Y, int Z,
                                            int x0, int y0, int z0, int wx,
                                            int wy, int wz, int first,
                                            int step, Acc& acc) {
  for (int r = first; r < wx * wy; r += step) {
    const long long x = x0 + r / wy, y = y0 + r % wy;
    reduce_row(vol + (x * Y + y) * Z + z0, wz, acc);
  }
}

struct OriginXYZ {             // K4: origins (n, 3) int32
  const int* o;
  __device__ void operator()(int i, int& x, int& y, int& z) const {
    x = o[3 * i];
    y = o[3 * i + 1];
    z = o[3 * i + 2];
  }
};

struct OriginIdx {             // K5: idx (n,) int32, brick idx at (idx, 0, 0)
  const int* idx;
  __device__ void operator()(int i, int& x, int& y, int& z) const {
    x = idx[i];
    y = 0;
    z = 0;
  }
};

template <class Origin>
__global__ void __launch_bounds__(kBrickThreads)
    brick_sum_kernel(const float* vol, int X, int Y, int Z, Origin origin,
                     int bx, int by, int bz, float* out) {
  __shared__ float s_warp[kBrickThreads / 32];
  const int i = blockIdx.x;
  int x0, y0, z0;
  origin(i, x0, y0, z0);
  float* row = out + (long long)i * kLanes;
  const bool inside = x0 >= 0 && y0 >= 0 && z0 >= 0 && x0 <= X - bx &&
                      y0 <= Y - by && z0 <= Z - bz;
  if (!inside) {
    for (int l = threadIdx.x; l < kLanes; l += blockDim.x) row[l] = NAN;
    return;
  }
  SumAcc acc;
  reduce_rows(vol, Y, Z, x0, y0, z0, bx, by, bz, threadIdx.x, blockDim.x,
              acc);
  float s = acc.s;
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0.0f;
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) s_warp[0] = s;
  }
  __syncthreads();
  s = s_warp[0];
  for (int l = threadIdx.x; l < kLanes; l += blockDim.x) row[l] = s;
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

template <class Origin>
int launch_bricks(const float* vol, int X, int Y, int Z, Origin origin, int n,
                  int bx, int by, int bz, float* out, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  brick_sum_kernel<Origin><<<n, kBrickThreads, 0, (cudaStream_t)stream>>>(
      vol, X, Y, Z, origin, bx, by, bz, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dr_brick_sums(const float* vol, int X, int Y, int Z,
                             const int* origins, int n, float* out, int device,
                             void* stream) {
  return launch_bricks(vol, X, Y, Z, OriginXYZ{origins}, n, kBrick, kBrick,
                       kBrick, out, device, stream);
}

// A brick of the table is rows*cols contiguous floats: it is reduced as runs
// of 32 (or the largest power of two below that divides it), so a CTA's
// threads share its rows as they share K4's.
extern "C" int dr_brick_rows(const float* bricks, int nb, int rows, int cols,
                             const int* idx, int n, float* out, int device,
                             void* stream) {
  const int len = rows * cols;
  int run = 32;
  while (len % run) run >>= 1;
  return launch_bricks(bricks, nb, len / run, run, OriginIdx{idx}, n, 1,
                       len / run, run, out, device, stream);
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
