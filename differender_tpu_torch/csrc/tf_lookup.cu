// K0 tf_lookup_fwd: 1D linear RGBA transfer-function lookup, and
// K0b tf_lookup_bwd: its backward.
//
// Replaces: differender_tpu/ops/tf_lookup.py::_fwd_kernel (launched by
// _forward), which builds one-hot hat weights W (4096 x R) per block and
// computes W @ tf on the MXU.
//
// Bound on the H100: memory.  Each lookup reads 4 B and writes 16 B and does
// about 17 f32 operations, far below the card's operations-per-byte ridge.
// The hat-weight matmul would spend O(R) operations per lookup to avoid a
// gather, which a GPU does not need to avoid: here each thread gathers its two
// texels from a shared-memory copy of the TF (or through __ldg for R > 1024)
// and writes one float4, so the kernel moves just the bytes the function needs.
// A grid-stride loop over a bounded grid amortises the per-block TF staging.
//
// K0b replaces differender_tpu/ops/tf_lookup.py::_bwd_kernel (launched by
// _bwd), which rebuilds the hat weights W and their d/dfrac per block and
// computes d_intensity = ((dW @ tf) . g) * (R-1), masked to 0 < t < R-1 on
// the raw t, and d_tf = W^T @ g summed over the sequential grid in one VMEM
// accumulator.  A GPU's blocks run in parallel, so the sum over lookups
// becomes a scatter: each lookup adds (1 - frac) g to its low texel and
// frac g to its high one, 8 floats onto 8 of 4R addresses.
//
// Bound on the H100: bytes.  Each lookup reads 4 + 16 B and writes 4 B and
// takes about 40 f32 operations; d_tf is 16R B.  What stands in the way is
// the scatter: many lookups land on few texels (all of a block's 1024
// threads on 128 texels at R = 128), and same-address atomics serialise.
// The design:
//   * A grid sized to the card: as many 1024-thread blocks as fit on its
//     SMs at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each
//     striding over the lookups, four loads in flight per thread.
//   * A privatised d_tf in shared memory.  Up to kBwdLaneTexels texels
//     ("lanes": 512R B, the TF beside it) every lane of a warp owns a
//     column of the block's d_tf, laid out [texel-channel][lane], so the 32
//     lanes of an atomic never share an address or a bank, whatever their
//     texels; only warps of the block that meet on one lane and texel
//     contend.  Up to kBwdSharedTexels ("shared": 16R B, the 227 KB a block
//     may opt into holds R = 14336) the block keeps one copy,
//     channel-major, where the many texels spread the lanes, and reads the
//     TF for the slope through __ldg (L1), which leaves shared memory for
//     two blocks an SM up to R = 7168.  A float atomicAdd on shared memory
//     is a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN): each conflict
//     costs a retry, so what the layouts buy is fewer conflicts.
//   * No global atomics: each block writes its d_tf as a partial to
//     scratch, and a second launch sums the partials in a fixed order
//     (block b to warp b % 32 in increasing b, then the 32 warps in order).
//     The sums inside a block are shared-memory atomics, whose order
//     varies, so the last bits of d_tf may still vary from run to run.
//   * Above kBwdSharedTexels ("global") the TF is read through __ldg and
//     every term is a global atomicAdd into d_tf, zeroed by the caller.
// The backward of the march (K2) keeps its own tf_lerp_bwd and flush.
#include <cuda_runtime.h>

#include "tf_lerp.cuh"

template <bool kGlobal>
__global__ void __launch_bounds__(256)
tf_lookup_fwd_kernel(const float* __restrict__ intensity,
                     const float4* __restrict__ tf, float4* __restrict__ out,
                     long long n, int R) {
  extern __shared__ float4 s_tf[];
  const float4* table = stage_tf<kGlobal>(tf, R, s_tf);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = tf_lerp<kGlobal>(table, R, __ldg(intensity + i));
  }
}

extern "C" int dr_tf_lookup_fwd(const float* intensity, const float* tf,
                                float* out, long long n, int R, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int threads = 256;
  const long long needed = (n + threads - 1) / threads;
  const int blocks = (int)(needed < 4096 ? needed : 4096);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* tf4 = reinterpret_cast<const float4*>(tf);
  float4* out4 = reinterpret_cast<float4*>(out);
  if (R <= kMaxSharedTexels) {
    tf_lookup_fwd_kernel<false><<<blocks, threads, R * sizeof(float4), s>>>(
        intensity, tf4, out4, n, R);
  } else {
    tf_lookup_fwd_kernel<true><<<blocks, threads, 0, s>>>(intensity, tf4,
                                                          out4, n, R);
  }
  return (int)cudaGetLastError();
}

namespace {

constexpr int kBwdThreads = 1024;
constexpr int kBwdUnroll = 4;         // lookups a thread loads at once
constexpr int kBwdLaneTexels = 256;   // TF + 4R x 32 floats: 132 KB at 256
constexpr int kBwdSharedTexels = 14336;  // d_tf, 16R B: 224 KB
constexpr int kSumWarps = 32;         // warps of a partial-sum block

enum BwdMode { kBwdLanes = 0, kBwdShared = 1, kBwdGlobal = 2 };

int bwd_mode(int R) {
  if (R <= kBwdLaneTexels) return kBwdLanes;
  return R <= kBwdSharedTexels ? kBwdShared : kBwdGlobal;
}

size_t bwd_smem(int mode, int R) {
  if (mode == kBwdLanes) return (size_t)R * 16 + (size_t)R * 4 * 32 * 4;
  return mode == kBwdShared ? (size_t)R * 16 : 0;
}

// Adds w * g to texel r of the block's d_tf (see the header for the modes'
// layouts).
template <int kMode>
__device__ __forceinline__ void add_texel(float* acc, int R, int r, int lane,
                                          float w, float4 g) {
  if (kMode == kBwdLanes) {
    float* p = acc + r * 4 * 32 + lane;
    atomicAdd(p, w * g.x);
    atomicAdd(p + 32, w * g.y);
    atomicAdd(p + 64, w * g.z);
    atomicAdd(p + 96, w * g.w);
  } else if (kMode == kBwdShared) {
    atomicAdd(acc + r, w * g.x);
    atomicAdd(acc + R + r, w * g.y);
    atomicAdd(acc + 2 * R + r, w * g.z);
    atomicAdd(acc + 3 * R + r, w * g.w);
  } else {
    float* p = acc + 4 * r;
    atomicAdd(p, w * g.x);
    atomicAdd(p + 1, w * g.y);
    atomicAdd(p + 2, w * g.z);
    atomicAdd(p + 3, w * g.w);
  }
}

// One lookup's backward: its d_tf terms into acc, and d_intensity under the
// Pallas kernel's mask, rounded as tf_lerp_bwd rounds it.
template <int kMode>
__device__ __forceinline__ float lookup_bwd(const float4* table, int R,
                                            float x, float4 g, float* acc,
                                            int lane) {
  const float t_raw = x * (float)(R - 1);
  const float t = fmaxf(t_raw, 0.0f);
  const float low_f = floorf(t);
  const float frac = t - low_f;
  const int low = (int)fminf(low_f, (float)(R - 1));
  const int high = min(low + 1, R - 1);
  add_texel<kMode>(acc, R, low, lane, 1.0f - frac, g);
  if (frac != 0.0f) add_texel<kMode>(acc, R, high, lane, frac, g);
  if (!(t_raw > 0.0f && t_raw < (float)(R - 1))) return 0.0f;
  const bool staged = kMode == kBwdLanes;
  const float4 a = staged ? table[low] : __ldg(table + low);
  const float4 b = staged ? table[high] : __ldg(table + high);
  float slope = __fmul_rn(b.x - a.x, g.x);
  slope = __fadd_rn(slope, __fmul_rn(b.y - a.y, g.y));
  slope = __fadd_rn(slope, __fmul_rn(b.z - a.z, g.z));
  slope = __fadd_rn(slope, __fmul_rn(b.w - a.w, g.w));
  return __fmul_rn(slope, (float)(R - 1));
}

// Thread t of block b takes lookups b*1024 + t + k*stride, k = 0, 1, ...
// Lanes and shared: out is the (gridDim.x, 4R) partials, every entry
// written.  Global: out is d_tf.
template <int kMode>
__global__ void __launch_bounds__(kBwdThreads)
tf_lookup_bwd_kernel(const float* __restrict__ intensity,
                     const float4* __restrict__ tf,
                     const float4* __restrict__ g, float* __restrict__ d_int,
                     float* __restrict__ out, long long n, int R) {
  extern __shared__ float4 s_tf[];
  const float4* table = tf;
  float* acc = out;
  if (kMode == kBwdLanes) {
    for (int i = threadIdx.x; i < R; i += blockDim.x) s_tf[i] = __ldg(tf + i);
    table = s_tf;
    acc = reinterpret_cast<float*>(s_tf + R);
  } else if (kMode == kBwdShared) {
    acc = reinterpret_cast<float*>(s_tf);
  }
  if (kMode != kBwdGlobal) {
    const int m = kMode == kBwdLanes ? 4 * R * 32 : 4 * R;
    for (int i = threadIdx.x; i < m; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i0 < n; i0 += kBwdUnroll * stride) {
    float x[kBwdUnroll];
    float4 gg[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < n) {
        x[u] = __ldg(intensity + i);
        gg[u] = __ldg(g + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < n) d_int[i] = lookup_bwd<kMode>(table, R, x[u], gg[u], acc, lane);
    }
  }
  if (kMode == kBwdGlobal) return;
  __syncthreads();
  // The block's partial, texel-major like d_tf.  Lanes: the 32 columns of
  // entry j summed from lane j % 32 on (each thread on its own bank).
  float* part = out + (long long)blockIdx.x * 4 * R;
  for (int j = threadIdx.x; j < 4 * R; j += blockDim.x) {
    float s;
    if (kMode == kBwdLanes) {
      const float* row = acc + j * 32;
      s = 0.0f;
      for (int l = 0; l < 32; ++l) s += row[(j + l) & 31];
    } else {
      s = acc[(j & 3) * R + (j >> 2)];
    }
    part[j] = s;
  }
}

// d_tf[j] = sum over warps w = 0..31 of (sum over blocks b = w, w + 32, ...
// of part[b][j]), each sum in increasing order.
__global__ void __launch_bounds__(32 * kSumWarps)
tf_grad_sum_kernel(const float* __restrict__ part, int blocks, int m,
                   float* __restrict__ d_tf) {
  __shared__ float s[kSumWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float v = 0.0f;
  if (j < m) {
    for (int b = warp; b < blocks; b += kSumWarps) {
      v += part[(long long)b * m + j];
    }
  }
  s[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && j < m) {
    float t = 0.0f;
    for (int w = 0; w < kSumWarps; ++w) t += s[w][lane];
    d_tf[j] = t;
  }
}

void* bwd_kernel(int mode) {
  if (mode == kBwdLanes) return (void*)tf_lookup_bwd_kernel<kBwdLanes>;
  if (mode == kBwdShared) return (void*)tf_lookup_bwd_kernel<kBwdShared>;
  return (void*)tf_lookup_bwd_kernel<kBwdGlobal>;
}

// The grid of K0b for n lookups at R texels on this device: every block that
// fits on the card at once, fewer where there are not 1024 lookups for each.
int bwd_blocks(long long n, int R, int device, int* blocks) {
  const int mode = bwd_mode(R);
  const size_t smem = bwd_smem(mode, R);
  const void* k = bwd_kernel(mode);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kBwdThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long needed = (n + kBwdThreads - 1) / kBwdThreads;
  const long long cap = (long long)per_sm * sms;
  *blocks = (int)(needed < cap ? needed : cap);
  return 0;
}

}  // namespace

// The launch plan of K0b: *blocks, the grid, and *partials, the floats of
// scratch that dr_tf_lookup_bwd needs (0 above kBwdSharedTexels, where it
// adds into d_tf, which must then be zeroed).
extern "C" int dr_tf_lookup_bwd_plan(long long n, int R, int device,
                                     int* blocks, long long* partials) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  *blocks = 0;
  *partials = 0;
  if (n <= 0 || R < 1) return 0;
  const int e = bwd_blocks(n, R, device, blocks);
  if (e != 0) return e;
  if (bwd_mode(R) != kBwdGlobal) *partials = (long long)*blocks * 4 * R;
  return 0;
}

// blocks and partial from dr_tf_lookup_bwd_plan.  Lanes and shared: two
// launches, the lookups into the partials, then their sum into d_tf (every
// entry written).  Global: one launch adding into d_tf.
extern "C" int dr_tf_lookup_bwd(const float* intensity, const float* tf,
                                const float* g, float* d_int, float* d_tf,
                                float* partial, int blocks, long long n,
                                int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* tf4 = reinterpret_cast<const float4*>(tf);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const int mode = bwd_mode(R);
  const size_t smem = bwd_smem(mode, R);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bwd_kernel(mode),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (mode == kBwdLanes) {
    tf_lookup_bwd_kernel<kBwdLanes><<<blocks, kBwdThreads, smem, s>>>(
        intensity, tf4, g4, d_int, partial, n, R);
  } else if (mode == kBwdShared) {
    tf_lookup_bwd_kernel<kBwdShared><<<blocks, kBwdThreads, smem, s>>>(
        intensity, tf4, g4, d_int, partial, n, R);
  } else {
    tf_lookup_bwd_kernel<kBwdGlobal><<<blocks, kBwdThreads, 0, s>>>(
        intensity, tf4, g4, d_int, d_tf, n, R);
    return (int)cudaGetLastError();
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int m = 4 * R;
  tf_grad_sum_kernel<<<(m + 31) / 32, 32 * kSumWarps, 0, s>>>(partial, blocks,
                                                             m, d_tf);
  return (int)cudaGetLastError();
}

extern "C" const char* dr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
