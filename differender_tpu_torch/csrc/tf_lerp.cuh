// Shared 1D RGBA transfer-function lerp, used by tf_lookup_fwd (K0),
// march_diff_fwd (K1) and march_nondiff (K3).
//
// Semantics of tf_lookup_reference in differender_tpu/ops/tf_lookup.py:
//   t = max(i*(R-1), 0); low = min(floor t, R-1); high = min(low+1, R-1);
//   out = tf[low]*(1-frac) + tf[high]*frac with frac = t - floor t.
// Out-of-range intensities clamp to the end texels.
//
// Texels are staged in dynamic shared memory when R <= kMaxSharedTexels
// (16 KB); a larger TF is read through the read-only cache (__ldg) instead.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxSharedTexels = 1024;

template <bool kGlobal>
__device__ __forceinline__ float4 tf_texel(const float4* tf, int i) {
  if (kGlobal) return __ldg(tf + i);
  return tf[i];
}

template <bool kGlobal>
__device__ __forceinline__ float4 tf_lerp(const float4* tf, int R,
                                          float intensity) {
  const float t = fmaxf(intensity * (float)(R - 1), 0.0f);
  const float low_f = floorf(t);
  const float frac = t - low_f;
  const int low = (int)fminf(low_f, (float)(R - 1));
  const int high = min(low + 1, R - 1);
  const float4 a = tf_texel<kGlobal>(tf, low);
  const float4 b = tf_texel<kGlobal>(tf, high);
  const float w = 1.0f - frac;
  return make_float4(a.x * w + b.x * frac, a.y * w + b.y * frac,
                     a.z * w + b.z * frac, a.w * w + b.w * frac);
}

// Copies the TF into shared memory (all threads of the block take part and
// meet at the barrier) and returns the table the lerp should read.
template <bool kGlobal>
__device__ __forceinline__ const float4* stage_tf(const float4* tf, int R,
                                                  float4* smem) {
  if (kGlobal) return tf;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < R; i += nthreads) smem[i] = __ldg(tf + i);
  __syncthreads();
  return smem;
}
