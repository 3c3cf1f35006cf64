// Shared 1D RGBA transfer-function lerp, used by tf_lookup_fwd (K0),
// march_diff_fwd (K1) and march_nondiff (K3), and its backward, used by
// march_diff_bwd (K2).  tf_lookup_bwd (K0b) has its own backward, with the
// Pallas kernel's mask or the dot form's, in tf_lookup.cu.
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

// x*w + y*v: with kExact rounded after each product and the sum, as the
// plain version rounds it; otherwise left to nvcc, which fuses one product
// into an FMA.
template <bool kExact>
__device__ __forceinline__ float lerp_sum(float x, float w, float y,
                                          float v) {
  if (kExact) return __fadd_rn(__fmul_rn(x, w), __fmul_rn(y, v));
  return x * w + y * v;
}

// kExact: see lerp_sum.  K1 and K2 need it (K2's gradient at R > 1024 keeps
// the TF slope at every t, which jumps at texel edges, so an ulp of
// intensity matters); K0 and K3 keep the fused form.
template <bool kGlobal, bool kExact = false>
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
  return make_float4(lerp_sum<kExact>(a.x, w, b.x, frac),
                     lerp_sum<kExact>(a.y, w, b.y, frac),
                     lerp_sum<kExact>(a.z, w, b.z, frac),
                     lerp_sum<kExact>(a.w, w, b.w, frac));
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

// Which d_intensity the backward keeps: ((tf[high] - tf[low]) . g) * (R-1)
// is the slope of the lerp, and the JAX march's two TF functions differ
// only in where they keep it.
enum TfGradMask {
  // frac > 0: the JAX march's TF for R <= 1024
  // (sampling.py::_apply_tf_dot_bwd); 0 at integer t and at the clipped ends.
  kTfGradFracPositive = 0,
  // Autograd of the gather-lerp, the JAX march's TF for R > 1024
  // (sampling.py::apply_tf_soa): every t, half at i == 0 (the tie of max).
  kTfGradEveryT = 1,
};

// Backward of tf_lerp for the output cotangent g: adds the two texels'
// d_tf (weights 1 - frac and frac, 4 channels each) into acc with
// atomicAdd (shared or global memory: acc holds R*4 floats) and returns
// d_intensity under kMask.  Zero terms are not added.
template <int kMask, bool kGlobal>
__device__ __forceinline__ float tf_lerp_bwd(const float4* tf, int R,
                                             float intensity, float4 g,
                                             float* acc) {
  const float t_raw = intensity * (float)(R - 1);
  const float t = fmaxf(t_raw, 0.0f);
  const float low_f = floorf(t);
  const float frac = t - low_f;
  const int low = (int)fminf(low_f, (float)(R - 1));
  const int high = min(low + 1, R - 1);
  const float w = 1.0f - frac;
  float* lo = acc + 4 * low;
  if (w != 0.0f) {
    if (g.x != 0.0f) atomicAdd(lo + 0, w * g.x);
    if (g.y != 0.0f) atomicAdd(lo + 1, w * g.y);
    if (g.z != 0.0f) atomicAdd(lo + 2, w * g.z);
    if (g.w != 0.0f) atomicAdd(lo + 3, w * g.w);
  }
  if (frac != 0.0f) {
    float* hi = acc + 4 * high;
    if (g.x != 0.0f) atomicAdd(hi + 0, frac * g.x);
    if (g.y != 0.0f) atomicAdd(hi + 1, frac * g.y);
    if (g.z != 0.0f) atomicAdd(hi + 2, frac * g.z);
    if (g.w != 0.0f) atomicAdd(hi + 3, frac * g.w);
  }
  float keep;
  if (kMask == kTfGradFracPositive) {
    keep = frac > 0.0f ? 1.0f : 0.0f;
  } else {
    keep = t_raw > 0.0f ? 1.0f : (t_raw == 0.0f ? 0.5f : 0.0f);
  }
  if (keep == 0.0f) return 0.0f;
  // Rounded step by step, unfused, in the plain version's order
  // (sampling.py::tf_lerp_bwd): d_intensity is its slope times R - 1, so an
  // FMA's different rounding would show as R - 1 ulps of the slope.
  const float4 a = tf_texel<kGlobal>(tf, low);
  const float4 b = tf_texel<kGlobal>(tf, high);
  float slope = __fmul_rn(b.x - a.x, g.x);
  slope = __fadd_rn(slope, __fmul_rn(b.y - a.y, g.y));
  slope = __fadd_rn(slope, __fmul_rn(b.z - a.z, g.z));
  slope = __fadd_rn(slope, __fmul_rn(b.w - a.w, g.w));
  return __fmul_rn(slope, (float)(R - 1)) * keep;
}

// Adds a block's shared-memory d_tf (R*4 floats) into the global one, one
// atomicAdd per nonzero texel-channel.  All threads of the block call it.
__device__ __forceinline__ void flush_tf_grad(const float* acc, int R,
                                             float* d_tf) {
  __syncthreads();
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 4 * R; i += nthreads) {
    if (acc[i] != 0.0f) atomicAdd(d_tf + i, acc[i]);
  }
}

// Zeroes a block's shared-memory d_tf accumulator and meets at a barrier.
__device__ __forceinline__ void zero_tf_grad(float* acc, int R) {
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 4 * R; i += nthreads) acc[i] = 0.0f;
  __syncthreads();
}
