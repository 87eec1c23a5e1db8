// The legacy fused DDIM update with external noise for Hopper (sm_90a),
// plain-C ABI.
//
// Replaces the Pallas TPU kernel ``ddim_step_2d`` of
// src/repro/kernels/ddim_step/kernel.py:43 (body ``_kernel``, :25):
//   a = c_x0 / sqrt_a_t,  b = c_dir - a * sqrt_1m_a_t,
//   out = a * x + b * eps + c_noise * noise
// over an (R, C) view, the coefficients cast to x's dtype first (the
// wrapper passes them already cast).  The rounding is the XLA:CPU one the
// plain version (../ref.py) documents: float32 contracts into
// fma(c_noise, noise, fma(a, x, b * eps)) with b = fma(-a, sqrt_1m_a_t,
// c_dir); bfloat16 rounds every op to bfloat16.  The explicit __f*_rn
// intrinsics keep nvcc's -fmad from contracting anything else.
//
// Bound on the H100: bytes.  Three reads and one write per element, a few
// operations each: 16 bytes per float32 element (8 per bfloat16) over
// 3.35 TB/s.
//
// Design (the simple one): one element per thread per iteration of a
// grid-stride loop, 256-thread blocks; neighbouring threads touch
// neighbouring addresses, so every load and store is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
ddim_step_f32(const float* __restrict__ x, const float* __restrict__ eps,
              const float* __restrict__ noise, float* __restrict__ out,
              long long n, float c_x0, float c_dir, float c_noise,
              float sqrt_a_t, float sqrt_1m_a_t) {
  const float a = __fdiv_rn(c_x0, sqrt_a_t);
  const float b = __fmaf_rn(-a, sqrt_1m_a_t, c_dir);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads)
    out[i] = __fmaf_rn(c_noise, noise[i],
                       __fmaf_rn(a, x[i], __fmul_rn(b, eps[i])));
}

__global__ void __launch_bounds__(kThreads)
ddim_step_bf16(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ eps,
               const __nv_bfloat16* __restrict__ noise,
               __nv_bfloat16* __restrict__ out, long long n, float c_x0,
               float c_dir, float c_noise, float sqrt_a_t,
               float sqrt_1m_a_t) {
  const float a = to_bf16(__fdiv_rn(c_x0, sqrt_a_t));
  const float b = to_bf16(__fsub_rn(c_dir, to_bf16(__fmul_rn(a, sqrt_1m_a_t))));
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float ax = to_bf16(__fmul_rn(a, __bfloat162float(x[i])));
    const float be = to_bf16(__fmul_rn(b, __bfloat162float(eps[i])));
    const float nz = to_bf16(__fmul_rn(c_noise, __bfloat162float(noise[i])));
    out[i] = __float2bfloat16_rn(__fadd_rn(to_bf16(__fadd_rn(ax, be)), nz));
  }
}

}  // namespace

extern "C" {

// x, eps, noise, out: n contiguous elements of one dtype (0 = float32,
// 1 = bfloat16); the five coefficients already cast to that dtype.
// Returns the cudaError_t of the launch (0 on success).
int repro_ddim_step_2d(const void* x, const void* eps, const void* noise,
                       void* out, int dtype, long long n, float c_x0,
                       float c_dir, float c_noise, float sqrt_a_t,
                       float sqrt_1m_a_t, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ddim_step_f32<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(eps),
        static_cast<const float*>(noise), static_cast<float*>(out), n, c_x0,
        c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t);
  } else if (dtype == 1) {
    ddim_step_bf16<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(eps),
        static_cast<const __nv_bfloat16*>(noise),
        static_cast<__nv_bfloat16*>(out), n, c_x0, c_dir, c_noise, sqrt_a_t,
        sqrt_1m_a_t);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
