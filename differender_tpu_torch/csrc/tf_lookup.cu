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
// accumulator.  Here a thread per intensity (tf_lerp_bwd in tf_lerp.cuh)
// writes d_intensity and adds its two texels' d_tf into the block's copy
// in shared memory; at the end each block adds its nonzero entries to the
// global d_tf with one atomicAdd each.  Above kMaxSharedTexels the TF and
// d_tf stay in global memory and every term is a global atomicAdd.
// Bound on the H100: memory.  Each intensity reads 4 + 16 B and writes 4 B
// and takes about 40 f32 operations; the block-level reduction keeps the
// global atomics to 4R per block at R <= 1024.
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

template <bool kGlobal>
__global__ void __launch_bounds__(256)
tf_lookup_bwd_kernel(const float* __restrict__ intensity,
                     const float4* __restrict__ tf,
                     const float4* __restrict__ g, float* __restrict__ d_int,
                     float* __restrict__ d_tf, long long n, int R) {
  extern __shared__ float4 s_tf[];
  const float4* table = stage_tf<kGlobal>(tf, R, s_tf);
  float* acc = kGlobal ? d_tf : reinterpret_cast<float*>(s_tf + R);
  if (!kGlobal) zero_tf_grad(acc, R);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    d_int[i] = tf_lerp_bwd<kTfGradPallas, kGlobal>(table, R,
                                                    __ldg(intensity + i),
                                                    g[i], acc);
  }
  if (!kGlobal) flush_tf_grad(acc, R, d_tf);
}

// d_tf (R*4 floats) must be zeroed by the caller.
extern "C" int dr_tf_lookup_bwd(const float* intensity, const float* tf,
                                const float* g, float* d_int, float* d_tf,
                                long long n, int R, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int threads = 256;
  const long long needed = (n + threads - 1) / threads;
  const int blocks = (int)(needed < 2048 ? needed : 2048);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* tf4 = reinterpret_cast<const float4*>(tf);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  if (R <= kMaxSharedTexels) {
    tf_lookup_bwd_kernel<false><<<blocks, threads, 2 * R * sizeof(float4),
                                  s>>>(intensity, tf4, g4, d_int, d_tf, n, R);
  } else {
    tf_lookup_bwd_kernel<true><<<blocks, threads, 0, s>>>(
        intensity, tf4, g4, d_int, d_tf, n, R);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
