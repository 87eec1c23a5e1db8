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
// c_dir); bfloat16 rounds every op to bfloat16; float16 takes the same
// contraction and rounds each contracted op once, straight to float16 (a =
// f16(c_x0 / sqrt_a_t), b = f16(fma(-a, sqrt_1m_a_t, c_dir)), out =
// f16(fma(c_noise, noise, f16(fma(a, x, f16(b * eps)))))): the fma in
// float64, then float32 rounded to odd, then float16 (f16_once).  The
// explicit __f*_rn intrinsics keep nvcc's -fmad from contracting anything
// else.
//
// A float32 x also takes eps and noise of any of the three types (JAX
// promotes them to float32): ddim_step_f32 reads each operand at its own
// type and widens it exactly, then runs the float32 arithmetic above.
//
// Bound on the H100: bytes.  Three reads and one write per element, a few
// operations each: 16 bytes per float32 element (8 per bfloat16) over
// 3.35 TB/s (8 per float16 element).
//
// Design (the simple one): one element per thread per iteration of a
// grid-stride loop, 256-thread blocks; neighbouring threads touch
// neighbouring addresses, so every load and store is coalesced.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float wide(__half v) { return __half2float(v); }

// A float32 x; eps of type TE and noise of type TN, each widened exactly.
template <typename TE, typename TN>
__global__ void __launch_bounds__(kThreads)
ddim_step_f32(const float* __restrict__ x, const TE* __restrict__ eps,
              const TN* __restrict__ noise, float* __restrict__ out,
              long long n, float c_x0, float c_dir, float c_noise,
              float sqrt_a_t, float sqrt_1m_a_t) {
  const float a = __fdiv_rn(c_x0, sqrt_a_t);
  const float b = __fmaf_rn(-a, sqrt_1m_a_t, c_dir);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads)
    out[i] = __fmaf_rn(c_noise, wide(noise[i]),
                       __fmaf_rn(a, x[i], __fmul_rn(b, wide(eps[i]))));
}

template <typename TE, typename TN>
void launch_f32(int blocks, cudaStream_t s, const void* x, const void* eps,
                const void* noise, void* out, long long n, float c_x0,
                float c_dir, float c_noise, float sqrt_a_t,
                float sqrt_1m_a_t) {
  ddim_step_f32<TE, TN><<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const TE*>(eps),
      static_cast<const TN*>(noise), static_cast<float*>(out), n, c_x0,
      c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t);
}

// The float32 launch over eps of type code ce and noise of type code cn
// (0 float32, 1 bfloat16, 2 float16).
template <typename TE>
void launch_f32_noise(int cn, int blocks, cudaStream_t s, const void* x,
                      const void* eps, const void* noise, void* out,
                      long long n, float c_x0, float c_dir, float c_noise,
                      float sqrt_a_t, float sqrt_1m_a_t) {
  if (cn == 0)
    launch_f32<TE, float>(blocks, s, x, eps, noise, out, n, c_x0, c_dir,
                          c_noise, sqrt_a_t, sqrt_1m_a_t);
  else if (cn == 1)
    launch_f32<TE, __nv_bfloat16>(blocks, s, x, eps, noise, out, n, c_x0,
                                  c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t);
  else
    launch_f32<TE, __half>(blocks, s, x, eps, noise, out, n, c_x0, c_dir,
                           c_noise, sqrt_a_t, sqrt_1m_a_t);
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

__device__ __forceinline__ float to_f16(float v) {
  return __half2float(__float2half_rn(v));
}

// a * b + c rounded once to float16: the float64 fma (exact for float16
// operands within 2^30 of each other), float32 rounded to odd (truncated,
// the last bit set where inexact: it keeps the bits float16 needs), then
// float16 to nearest even.
__device__ __forceinline__ __half f16_once(float a, float b, float c) {
  const double r = __fma_rn(static_cast<double>(a), static_cast<double>(b),
                            static_cast<double>(c));
  float t = __double2float_rz(r);
  if (static_cast<double>(t) != r) t = __uint_as_float(__float_as_uint(t) | 1u);
  return __float2half_rn(t);
}

__global__ void __launch_bounds__(kThreads)
ddim_step_f16(const __half* __restrict__ x, const __half* __restrict__ eps,
              const __half* __restrict__ noise, __half* __restrict__ out,
              long long n, float c_x0, float c_dir, float c_noise,
              float sqrt_a_t, float sqrt_1m_a_t) {
  const float a = to_f16(__fdiv_rn(c_x0, sqrt_a_t));
  const float b = __half2float(f16_once(-a, sqrt_1m_a_t, c_dir));
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float be = to_f16(__fmul_rn(b, __half2float(eps[i])));
    const float s = __half2float(f16_once(a, __half2float(x[i]), be));
    out[i] = f16_once(c_noise, __half2float(noise[i]), s);
  }
}

}  // namespace

extern "C" {

// x, out: n contiguous elements of type code dtype (0 = float32, 1 =
// bfloat16, 2 = float16); eps and noise: n elements of type codes
// eps_dtype and noise_dtype, each equal to dtype unless x is float32; the
// five coefficients already cast to x's type.  Returns the cudaError_t of
// the launch (0 on success).
int repro_ddim_step_2d(const void* x, const void* eps, const void* noise,
                       void* out, int dtype, int eps_dtype, int noise_dtype,
                       long long n, float c_x0, float c_dir, float c_noise,
                       float sqrt_a_t, float sqrt_1m_a_t, void* stream) {
  if (n < 1 || eps_dtype < 0 || eps_dtype > 2 || noise_dtype < 0 ||
      noise_dtype > 2 ||
      (dtype != 0 && (eps_dtype != dtype || noise_dtype != dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int nb = static_cast<int>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (eps_dtype == 0)
      launch_f32_noise<float>(noise_dtype, nb, s, x, eps, noise, out, n, c_x0,
                              c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t);
    else if (eps_dtype == 1)
      launch_f32_noise<__nv_bfloat16>(noise_dtype, nb, s, x, eps, noise, out,
                                      n, c_x0, c_dir, c_noise, sqrt_a_t,
                                      sqrt_1m_a_t);
    else
      launch_f32_noise<__half>(noise_dtype, nb, s, x, eps, noise, out, n,
                               c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t);
  } else if (dtype == 1) {
    ddim_step_bf16<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(eps),
        static_cast<const __nv_bfloat16*>(noise),
        static_cast<__nv_bfloat16*>(out), n, c_x0, c_dir, c_noise, sqrt_a_t,
        sqrt_1m_a_t);
  } else if (dtype == 2) {
    ddim_step_f16<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const __half*>(x), static_cast<const __half*>(eps),
        static_cast<const __half*>(noise), static_cast<__half*>(out), n, c_x0,
        c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
