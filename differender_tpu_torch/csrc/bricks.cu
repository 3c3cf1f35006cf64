// K4 brick_sums, K5 brick_rows and K6 cell_minmax: reductions of boxes of
// voxels, all through one row-reduce device function (reduce_rows).
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
// (idx, 0, 0), so both are one kernel template.
//
// K6 replaces the reduce_window pair of differender_tpu/occupancy.py::
// _cell_minmax (an XLA program, not Pallas): per macrocell c the (min, max)
// of the voxels in [c*cell - 1, (c+1)*cell] on each axis, indices clamped to
// [0, size - 1].  The clamp gives exactly the set of values that JAX's two
// edge pads put in the window, and min and max are exact, so K6 equals JAX
// bit for bit.  One thread per macrocell, neighbouring threads on
// neighbouring cells along z, so a warp's loads of one row share lines.
//
// Bound on the H100: bytes.  K4 and K5 read each brick once (128 KiB at
// B = 32) and do one add per float; K6 reads the volume and writes two floats
// per macrocell, the windows' overlap is served from L1/L2.  Rows are read
// with 16-byte loads once their address is 16-byte aligned; a row that starts
// unaligned (K4 at an origin with z0 % 4 != 0, K6's clamped windows) takes
// scalar loads up to the first aligned float.
//
// Out-of-range origins: the Pallas DMA has no defined result for a brick
// that leaves the volume.  K4 and K5 check every origin and write NaN to the
// row of a brick that does not lie wholly inside the volume (or table); they
// never clamp it, which would quietly sum another brick.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kLanes = 128;        // output lanes per brick (the TPU's row)
constexpr int kBrick = 32;         // K4's brick edge (exp_pallas_dma.py:36)
constexpr int kBrickThreads = 256;
constexpr int kCellThreads = 128;

struct SumAcc {
  float s = 0.0f;
  __device__ __forceinline__ void operator()(float v) { s += v; }
};

struct MinMaxAcc {
  float lo = INFINITY, hi = -INFINITY;
  __device__ __forceinline__ void operator()(float v) {
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
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
// a CTA (step = blockDim.x); K6 takes a whole window in one thread (step 1).
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

__global__ void __launch_bounds__(kCellThreads)
    cell_minmax_kernel(const float* vol, int X, int Y, int Z, int cell,
                       int nx, int ny, int nz, float* lo, float* hi) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)nx * ny * nz) return;
  const int cz = (int)(c % nz);
  const long long cxy = c / nz;
  const int cy = (int)(cxy % ny), cx = (int)(cxy / ny);
  const int x0 = max(cx * cell - 1, 0), x1 = min((cx + 1) * cell, X - 1);
  const int y0 = max(cy * cell - 1, 0), y1 = min((cy + 1) * cell, Y - 1);
  const int z0 = max(cz * cell - 1, 0), z1 = min((cz + 1) * cell, Z - 1);
  MinMaxAcc acc;
  reduce_rows(vol, Y, Z, x0, y0, z0, x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1, 0,
              1, acc);
  lo[c] = acc.lo;
  hi[c] = acc.hi;
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

extern "C" int dr_cell_minmax(const float* vol, int X, int Y, int Z, int cell,
                              float* lo, float* hi, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nx = (X + cell - 1) / cell, ny = (Y + cell - 1) / cell,
            nz = (Z + cell - 1) / cell;
  const long long cells = (long long)nx * ny * nz;
  if (cells <= 0) return 0;
  const long long blocks = (cells + kCellThreads - 1) / kCellThreads;
  cell_minmax_kernel<<<(unsigned)blocks, kCellThreads, 0,
                       (cudaStream_t)stream>>>(vol, X, Y, Z, cell, nx, ny, nz,
                                               lo, hi);
  return (int)cudaGetLastError();
}
