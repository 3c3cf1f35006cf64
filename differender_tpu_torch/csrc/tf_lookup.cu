// K0 tf_lookup_fwd: 1D linear RGBA transfer-function lookup.
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

extern "C" const char* dr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
