// The RMSNorm arithmetic of a row: its inverse RMS from the row's sum of
// squares (rms_inv_from_sumsq) and the float32 / bfloat16 / float16
// conversions.
// Shared by the rms_norm_2d kernel (rmsnorm.cu, rmsnorm_rows.cuh) and the
// megastep kernel's normed products, each summing a row's squares its own
// way.  Port of ``rms_norm_body`` in
// src/repro/kernels/rmsnorm/kernel.py:19, with its op order:
//   ms  = mean(float32(x)^2)                 (float32 sum, one division)
//   inv = T(rsqrt(ms + eps))                 (cast to x's dtype)
//   out = T(T(x * inv) * scale)              (each product rounded to T)
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// inv = T(rsqrt(ss / d + eps)) from the float32 sum of squares of a row.
template <typename T>
__device__ __forceinline__ float rms_inv_from_sumsq(float ss, int d,
                                                    float eps) {
  const float ms = __fdiv_rn(ss, static_cast<float>(d));
  return to_f32(from_f32<T>(rsqrtf(__fadd_rn(ms, eps))));
}

}  // namespace repro
