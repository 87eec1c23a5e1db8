// Row-wise RMSNorm for Hopper (sm_90a), plain-C ABI.
//
// Replaces the Pallas TPU kernel ``rms_norm_2d`` of
// src/repro/kernels/rmsnorm/kernel.py:38 (body ``rms_norm_body``, :19):
// out[r] = (x[r] * T(rsqrt(mean(x[r]^2) + eps))) * scale, float32 sum of
// squares, for float32 and bfloat16 rows.
//
// Bound on the H100: one read of x and scale and one write of out, a few
// operations per element, so bytes bound it: (2 R d + d) x dtype size over
// 3.35 TB/s.
//
// Design (the simple one): one warp per row, 8 rows per 256-thread block;
// each lane strides over the row, the warp reduces the sum of squares with
// shuffles, then the same lanes scale the row.  The row body is
// rmsnorm_body.cuh, which the megastep kernel inlines too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rmsnorm/csrc/rmsnorm_body.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                T* __restrict__ out, int R, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= R) return;  // whole warps leave together
  const long long off = static_cast<long long>(row) * d;
  repro::rms_norm_row_warp<T>(x + off, scale, out + off, d, eps);
}

}  // namespace

extern "C" {

// x, out: (R, d) contiguous; scale: (d,), all of one dtype (0 = float32,
// 1 = bfloat16).  Returns the cudaError_t of the launch (0 on success).
int repro_rms_norm_2d(const void* x, const void* scale, void* out, int dtype,
                      int R, int d, float eps, void* stream) {
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rms_norm_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), R, d, eps);
  } else if (dtype == 1) {
    rms_norm_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(scale),
        static_cast<__nv_bfloat16*>(out), R, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
