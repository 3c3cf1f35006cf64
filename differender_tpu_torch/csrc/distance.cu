// K7 cell_distance: the occupancy grid's L-inf (chessboard) distance field.
//
// Replaces the TF range table, the classification and the dilation loop of
// differender_tpu/occupancy.py::build_occupancy (XLA, not Pallas): a cell
// with intensity range [lo, hi] (K6) is occupied when the TF range table
// (occupancy.py::tf_alpha_range_max) at texels [floor(lo*(R-1)),
// ceil(hi*(R-1))], clamped to [0, R-1], exceeds alpha_skip; then for every
// macrocell the L-inf distance, in cells, to the nearest occupied cell of the
// grid, saturated at max_dist (max_dist where no cell is occupied), which JAX
// takes from max_dist - 1 rounds of a 3^3 max reduce_window.  k rounds of a
// 3^3 dilation padded with -inf reach exactly the cells within L-inf
// distance k inside the grid, so both give the same integers.
//
// The L-inf distance is separable:
//   D(c) = min_o max(|dx|, |dy|, |dz|)
//        = min_ox max(|dx|, min_oy max(|dy|, min_oz max(|dz|, f0(o)))),
// with f0 = 0 on occupied cells and max_dist elsewhere; saturating at
// max_dist commutes with every min and max.  So three passes, one per axis.
//
// Bound on the H100: bytes (lo, hi in, one int out per cell), at 128^3 cells
// about 7.5 us.  A walk outward from each cell, the plain way, costs
// the cell's distance (up to max_dist - 1 steps in air), and a separate
// table, classification and memset cost launches.  The design, in three
// launches and no memset:
//   1. z_pass: each block builds a sparse table of the TF's alpha (maxima
//      over power-of-two texel spans, over groups of B texels where R is
//      large) in shared memory, so a cell's range maximum takes two shared
//      reads (and under 2B alphas at the ends of a span when B > 1), not a
//      table of R^2 floats in device memory.  Each warp classifies a z-row
//      (neighbouring lanes on neighbouring cells), keeps the row as ballot
//      masks in shared memory, and takes each cell's distance to the nearest
//      occupied cell on either side from the masks (bit scans), saturated at
//      max_dist: the 1-D distance of a 0/max_dist row, exactly.
//   2., 3. line_pass along y, then x: one thread per line, neighbouring
//      threads on neighbouring z.  out(c) = min_j max(|c - j|, in(j)),
//      saturated at max_dist (cells outside the grid count as max_dist), is
//      min(L(c), R(c)) with L over j <= c and R over j >= c, each one linear
//      scan.  Every cell j < c has max(c - j, in(j)) equal to its value at
//      c - 1 or one more, so the best of them at c, L'(c), is L(c - 1) or
//      L(c - 1) + 1, and it is L(c - 1) exactly when the last cell j < c
//      with in(j) = L(c - 1) lies at j >= c - L(c - 1) (it is still on the
//      flat part of max(c - j, in(j))); then L(c) = min(in(c), L'(c),
//      max_dist).  The last position of each value sits in shared memory.
//      R is the same scan backward.  So each cell costs O(1) whatever its
//      distance.  The x pass reduces the field's largest value ("far") per
//      block and adds it with one atomicMax; K3 reads it to skip its
//      lookups where no cell lies at distance 2 or more, without a host
//      sync.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroups = 512;    // texel groups of the sparse table
constexpr int kLineThreads = 128;  // threads (lines) of a line_pass block
constexpr int kBatch = 8;          // cells a line_pass thread loads at once

__device__ __forceinline__ float alpha_at(const float* tf, int i) {
  return __ldg(tf + 4 * i + 3);
}

// max(alpha[lo..hi]), lo <= hi, from the sparse table sp (level k, group g
// at sp[k * G + g]: the maximum over groups g .. g + 2^k - 1 of 2^lb texels
// each) and, for the ends of the span that do not fill a group, from the TF
// itself.
__device__ __forceinline__ float range_max(const float* tf, const float* sp,
                                           int lb, int G, int lo, int hi) {
  const int gl = (lo + (1 << lb) - 1) >> lb, gh = ((hi + 1) >> lb) - 1;
  float m = -INFINITY;
  if (gl > gh) {
    for (int i = lo; i <= hi; ++i) m = fmaxf(m, alpha_at(tf, i));
    return m;
  }
  for (int i = lo; i < gl << lb; ++i) m = fmaxf(m, alpha_at(tf, i));
  for (int i = (gh + 1) << lb; i <= hi; ++i) m = fmaxf(m, alpha_at(tf, i));
  const int k = 31 - __clz(gh - gl + 1);
  return fmaxf(m, fmaxf(sp[k * G + gl], sp[k * G + gh - (1 << k) + 1]));
}

// Occupied or not, with the plain version's f32 arithmetic: the texel range
// (the product rounded before floor/ceil, both clamped to the table), its
// alpha maximum and, unless the range is (0, R - 1), a 0 in that maximum
// (JAX masks the texels outside [lo, hi] to 0 before its max); 0 where the
// range is empty.
__device__ __forceinline__ bool occupied(float lo, float hi, const float* tf,
                                         const float* sp, int R, int lb, int G,
                                         float alpha_skip) {
  const float top = (float)(R - 1);
  const int li = (int)fminf(fmaxf(floorf(__fmul_rn(lo, top)), 0.0f), top);
  const int hi_i = (int)fminf(fmaxf(ceilf(__fmul_rn(hi, top)), 0.0f), top);
  float v = 0.0f;
  if (li <= hi_i) {
    const float m = range_max(tf, sp, lb, G, li, hi_i);
    v = li == 0 && hi_i == R - 1 ? m : fmaxf(m, 0.0f);
  }
  return v > alpha_skip;
}

// Pass 1: the sparse table, the classification and the distance along z.
// Dynamic shared memory: the table (levels * G floats), then nz / 32 mask
// words per warp.  Zeroes far for the x pass.
__global__ void __launch_bounds__(kThreads)
    z_pass(const float* lo, const float* hi, const float* tf, int R, int lb,
           int G, float alpha_skip, long long rows, int nz, int maxd,
           int* out, int* far) {
  extern __shared__ unsigned smem[];
  float* sp = reinterpret_cast<float*>(smem);
  const int levels = 32 - __clz(G);
  const int nw = (nz + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* masks = smem + levels * G + warp * nw;
  for (int g = tid; g < G; g += kThreads) {
    float m = -INFINITY;
    const int end = min(R, (g + 1) << lb);
    for (int i = g << lb; i < end; ++i) m = fmaxf(m, alpha_at(tf, i));
    sp[g] = m;
  }
  __syncthreads();
  for (int k = 1; k < levels; ++k) {
    const int half = 1 << (k - 1);
    for (int i = tid; i + 2 * half <= G; i += kThreads)
      sp[k * G + i] = fmaxf(sp[(k - 1) * G + i], sp[(k - 1) * G + i + half]);
    __syncthreads();
  }
  if (blockIdx.x == 0 && tid == 0) *far = 0;

  for (long long row = (long long)blockIdx.x * kWarps + warp; row < rows;
       row += (long long)gridDim.x * kWarps) {
    const long long base = row * nz;
    // Four words of the row at a time: their loads are all in flight before
    // the first classification.
    for (int j0 = 0; j0 < nw; j0 += 4) {
      float l[4], u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int z = (j0 + k) * 32 + lane;
        l[k] = z < nz ? __ldg(lo + base + z) : 0.0f;
        u[k] = z < nz ? __ldg(hi + base + z) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j0 + k >= nw) break;
        const int z = (j0 + k) * 32 + lane;
        const bool on =
            z < nz && occupied(l[k], u[k], tf, sp, R, lb, G, alpha_skip);
        const unsigned m = __ballot_sync(0xffffffffu, on);
        if (lane == 0) masks[j0 + k] = m;
      }
    }
    __syncwarp();
    for (int j = 0; j < nw; ++j) {
      const int z = j * 32 + lane;
      if (z >= nz) break;
      int best = maxd;
      // The nearest occupied cell at or below z, then at or above it; a
      // word whose nearest cell is no closer than best is not read.
      unsigned m = masks[j] & (0xffffffffu >> (31 - lane));
      for (int w = j;;) {
        if (m) {
          best = min(best, z - (w * 32 + 31 - __clz(m)));
          break;
        }
        if (--w < 0 || z - (w * 32 + 31) >= best) break;
        m = masks[w];
      }
      m = masks[j] & (0xffffffffu << lane);
      for (int w = j;;) {
        if (m) {
          best = min(best, w * 32 + __ffs(m) - 1 - z);
          break;
        }
        if (++w >= nw || w * 32 - z >= best) break;
        m = masks[w];
      }
      out[base + z] = best;
    }
    __syncwarp();
  }
}

// Passes 2 and 3, along one axis of length n (stride axis_stride): one
// thread per line; thread t takes z = t % nz and the other axis' index
// t / nz, so neighbouring threads read and write neighbouring z.  Dynamic
// shared memory: last[v], the last position of value v, for v in [0, maxd],
// one column per thread.  With far, the block's largest value goes into it
// with one atomicMax.
__global__ void line_pass(const int* in, int* out, int n,
                          long long axis_stride, int nz,
                          long long other_stride, long long lines, int maxd,
                          int* far) {
  extern __shared__ int last[];
  __shared__ int s_top[32];
  const int T = blockDim.x;
  const long long t = (long long)blockIdx.x * T + threadIdx.x;
  int top = 0;
  if (t < lines) {
    const long long base = (t / nz) * other_stride + t % nz;
    int* my = last + threadIdx.x;
    // Forward: a = L(c), saturated.  No cell before c = 0: ap = maxd + 1.
    // kBatch cells' loads at a time are in flight before the scan, one
    // dependent chain, uses them.
    for (int v = 0; v <= maxd; ++v) my[v * T] = INT_MIN / 2;
    int a = maxd;
    for (int c0 = 0; c0 < n; c0 += kBatch) {
      int gv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 + k;
        gv[k] = c < n ? __ldg(in + base + c * axis_stride) : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 + k;
        if (c >= n) break;
        const int g = min(gv[k], maxd);
        const int ap = my[a * T] >= c - a ? a : a + 1;
        a = min(min(g, ap), maxd);
        my[g * T] = c;
        out[base + c * axis_stride] = a;
      }
    }
    // Backward: b = R(c), then out = min(L, R).
    for (int v = 0; v <= maxd; ++v) my[v * T] = INT_MAX / 2;
    int b = maxd;
    for (int c0 = n - 1; c0 >= 0; c0 -= kBatch) {
      int gv[kBatch], lv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 - k;
        gv[k] = c >= 0 ? __ldg(in + base + c * axis_stride) : 0;
        lv[k] = c >= 0 ? out[base + c * axis_stride] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 - k;
        if (c < 0) break;
        const int g = min(gv[k], maxd);
        const int bp = my[b * T] <= c + b ? b : b + 1;
        b = min(min(g, bp), maxd);
        my[g * T] = c;
        const int r = min(lv[k], b);
        out[base + c * axis_stride] = r;
        top = max(top, r);
      }
    }
  }
  if (far != nullptr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) s_top[warp] = top;
    __syncthreads();
    if (threadIdx.x == 0) {
      int m = 0;
      for (int w = 0; w < T / 32; ++w) m = max(m, s_top[w]);
      if (m > 0) atomicMax(far, m);
    }
  }
}

int launch_line_pass(const int* in, int* out, int n, long long axis_stride,
                     int others, long long other_stride, int nz, int maxd,
                     int* far, cudaStream_t s) {
  // 128 threads a block; fewer where last[] would not fit in 48 KB, and
  // above that the opt-in limit.
  int T = kLineThreads;
  size_t smem = (size_t)(maxd + 1) * T * sizeof(int);
  while (T > 32 && smem > 48 * 1024) {
    T -= 32;
    smem = (size_t)(maxd + 1) * T * sizeof(int);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        line_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long lines = (long long)others * nz;
  const unsigned blocks = (unsigned)((lines + T - 1) / T);
  line_pass<<<blocks, T, smem, s>>>(in, out, n, axis_stride, nz,
                                    other_stride, lines, maxd, far);
  return (int)cudaGetLastError();
}

}  // namespace

// lo, hi: (nx, ny, nz) f32; tf: (R, 4) f32; tmp, out: nx*ny*nz int32; far:
// one int32.  Three launches: the z pass into out, the y pass into tmp, the
// x pass into out.
extern "C" int dr_cell_distance(const float* lo, const float* hi,
                                const float* tf, int R, float alpha_skip,
                                int nx, int ny, int nz, int max_dist,
                                int* tmp, int* out, int* far, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)nx * ny * nz <= 0 || R < 1) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int lb = 0;  // texel groups of 2^lb texels
  while (((R + (1 << lb) - 1) >> lb) > kMaxGroups) ++lb;
  const int G = (R + (1 << lb) - 1) >> lb;
  const int levels = 32 - __builtin_clz((unsigned)G);
  const size_t smem =
      ((size_t)levels * G + (size_t)kWarps * ((nz + 31) / 32)) * 4;
  const long long rows = (long long)nx * ny;
  const int blocks = (int)std::min<long long>((rows + kWarps - 1) / kWarps,
                                              1024);
  z_pass<<<blocks, kThreads, smem, s>>>(lo, hi, tf, R, lb, G, alpha_skip,
                                        rows, nz, max_dist, out, far);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long yz = (long long)ny * nz;
  const int e = launch_line_pass(out, tmp, ny, nz, nx, yz, nz, max_dist,
                                 nullptr, s);
  if (e != 0) return e;
  return launch_line_pass(tmp, out, nx, yz, ny, nz, nz, max_dist, far, s);
}
