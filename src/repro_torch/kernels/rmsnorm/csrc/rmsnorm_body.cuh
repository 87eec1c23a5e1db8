// The RMSNorm arithmetic of one row, computed by one warp.  Shared by the
// rms_norm_2d kernel (rmsnorm.cu) and the megastep kernel, which takes
// its inverse RMS (rms_inv_from_sumsq) for the trunk's normed products,
// summing each row's squares its own way.  Port of ``rms_norm_body`` in
// src/repro/kernels/rmsnorm/kernel.py:19, with its op order:
//   ms  = mean(float32(x)^2)                 (float32 sum, one division)
//   inv = T(rsqrt(ms + eps))                 (cast to x's dtype)
//   out = T(T(x * inv) * scale)              (each product rounded to T)
#pragma once

#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// inv = T(rsqrt(ss / d + eps)) from the float32 sum of squares of a row.
template <typename T>
__device__ __forceinline__ float rms_inv_from_sumsq(float ss, int d,
                                                    float eps) {
  const float ms = __fdiv_rn(ss, static_cast<float>(d));
  return to_f32(from_f32<T>(rsqrtf(__fadd_rn(ms, eps))));
}

// x, scale, out: one row of d elements (generic pointers: global or
// shared).  All 32 lanes of the calling warp must call it together.
template <typename T>
__device__ __forceinline__ void rms_norm_row_warp(const T* x, const T* scale,
                                                  T* out, int d, float eps) {
  const int lane = threadIdx.x & 31;
  float ss = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(x[i]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rms_inv_from_sumsq<T>(ss, d, eps);
  for (int i = lane; i < d; i += 32) {
    const float xi = to_f32(from_f32<T>(__fmul_rn(to_f32(x[i]), inv)));
    out[i] = from_f32<T>(__fmul_rn(xi, to_f32(scale[i])));
  }
}

}  // namespace repro
