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
// max_dist commutes with every min and max.  So three passes, one per axis,
// each  out(c) = min over |d| < max_dist of max(|d|, in(c + d * e_axis)),
// cells outside the grid counting as max_dist.  One thread per cell walks
// outward from d = 0 and stops once d reaches its best value so far (no
// farther cell can lower it): a cell next to an occupied one reads a few
// values, and a grid that is all occupied reads one per cell and pass.
// Neighbouring threads take neighbouring cells along z, so a warp's loads at
// one offset d share lines on every axis.  The last pass also takes the
// field's largest value ("far"), which K3 reads to skip its lookups where no
// cell lies at distance 2 or more, without a host sync.
//
// One C call makes the whole field: the table, the classification, the three
// passes; the build of a grid is K6 and this call.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;

// tab[hi * R + lo] = max(alpha[lo..hi]) and, unless (lo, hi) = (0, R - 1),
// 0 (JAX masks the texels outside [lo, hi] to 0 before its max); 0 where
// lo > hi.  One thread per lo walks hi upward; threads of one hi write
// neighbouring floats.
__global__ void range_table(const float* tf, int R, float* tab) {
  const int lo = blockIdx.x * blockDim.x + threadIdx.x;
  if (lo >= R) return;
  float m = -INFINITY;
  for (int hi = 0; hi < R; ++hi) {
    float v = 0.0f;
    if (hi >= lo) {
      m = fmaxf(m, __ldg(tf + 4 * hi + 3));
      v = lo == 0 && hi == R - 1 ? m : fmaxf(m, 0.0f);
    }
    tab[(long long)hi * R + lo] = v;
  }
}

// Occupied or not, with the plain version's f32 arithmetic: the product is
// rounded before floor/ceil, and both are clamped to the table.
__global__ void __launch_bounds__(kThreads)
    classify(const float* lo, const float* hi, const float* table, int R,
             float alpha_skip, long long cells, unsigned char* occ) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  const float top = (float)(R - 1);
  const int li =
      (int)fminf(fmaxf(floorf(__fmul_rn(__ldg(lo + c), top)), 0.0f), top);
  const int hi_i =
      (int)fminf(fmaxf(ceilf(__fmul_rn(__ldg(hi + c), top)), 0.0f), top);
  occ[c] = __ldg(table + (long long)hi_i * R + li) > alpha_skip;
}

struct FromOccupied {          // pass 1: f0 from the occupancy bytes
  const unsigned char* occ;
  int maxd;
  __device__ __forceinline__ int operator()(long long c) const {
    return __ldg(occ + c) ? 0 : maxd;
  }
};

struct FromDistance {          // passes 2 and 3: the previous pass
  const int* in;
  __device__ __forceinline__ int operator()(long long c) const {
    return __ldg(in + c);
  }
};

template <int kAxis, class In>
__global__ void __launch_bounds__(kThreads)
    distance_pass(In in, int nx, int ny, int nz, int maxd, int* out,
                  int* far) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)nx * ny * nz) return;
  const int cz = (int)(c % nz);
  const long long cxy = c / nz;
  const int cy = (int)(cxy % ny), cx = (int)(cxy / ny);
  const int pos = kAxis == 0 ? cx : kAxis == 1 ? cy : cz;
  const int n = kAxis == 0 ? nx : kAxis == 1 ? ny : nz;
  const long long stride =
      kAxis == 0 ? (long long)ny * nz : kAxis == 1 ? (long long)nz : 1;
  int best = min(in(c), maxd);
  for (int d = 1; d < best; ++d) {
    int v = maxd;
    if (pos - d >= 0) v = in(c - d * stride);
    if (pos + d < n) v = min(v, in(c + d * stride));
    best = min(best, max(d, v));
  }
  out[c] = best;
  if (far != nullptr) {
    const int m = __reduce_max_sync(__activemask(), best);
    if ((threadIdx.x & 31) == 0 && m > *(volatile int*)far) atomicMax(far, m);
  }
}

}  // namespace

// lo, hi: (nx, ny, nz) f32; tf: (R, 4) f32; scratch: table R*R f32, occ
// nx*ny*nz bytes, tmp nx*ny*nz int32; out: nx*ny*nz int32; far: one int32.
// Builds the table, classifies, then passes along z, y and x.
extern "C" int dr_cell_distance(const float* lo, const float* hi,
                                const float* tf, int R, float alpha_skip,
                                int nx, int ny, int nz, int max_dist,
                                float* table, unsigned char* occ, int* tmp,
                                int* out, int* far, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)nx * ny * nz;
  if (cells <= 0 || R < 1) return 0;
  const unsigned blocks = (unsigned)((cells + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(far, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  range_table<<<(R + 127) / 128, 128, 0, s>>>(tf, R, table);
  classify<<<blocks, kThreads, 0, s>>>(lo, hi, table, R, alpha_skip, cells,
                                       occ);
  distance_pass<2><<<blocks, kThreads, 0, s>>>(
      FromOccupied{occ, max_dist}, nx, ny, nz, max_dist, out, nullptr);
  distance_pass<1><<<blocks, kThreads, 0, s>>>(FromDistance{out}, nx, ny, nz,
                                               max_dist, tmp, nullptr);
  distance_pass<0><<<blocks, kThreads, 0, s>>>(FromDistance{tmp}, nx, ny, nz,
                                               max_dist, out, far);
  return (int)cudaGetLastError();
}
