// Row-wise RMSNorm for Hopper (sm_90a), plain-C ABI.
//
// Replaces the Pallas TPU kernel ``rms_norm_2d`` of
// src/repro/kernels/rmsnorm/kernel.py:38 (body ``rms_norm_body``, :19):
// out[r] = (x[r] * T(rsqrt(mean(x[r]^2) + eps))) * scale, float32 sum of
// squares, for float32, bfloat16 and float16 rows.
//
// Bound on the H100: one read of x and scale and one write of out, a few
// operations per element, so bytes bound it: (2 R d + d) x dtype size over
// 3.35 TB/s.  At the trunk's (256, 576) and the ops path's (2048, 576) the
// rows stay in the 50 MB L2 under graph replay, so what sets the time is
// latency: the launch, one round of loads, one reduction, one round of
// stores.
//
// Design (rmsnorm_rows.cuh has the body): one pass.  A warp holds a row
// in registers (up to 8 chunks per lane), loaded with 16-byte loads, all
// issued at once; it reduces four independent partial sums per lane and
// a warp shuffle, then scales from the registers and stores 16 bytes at a
// time.  Rule for the grid: two rows (two warps) per 64-thread block, so
// R = 256 runs 128 blocks and every row's loads are in flight together;
// at large R an SM holds as many 64-thread blocks as its registers allow,
// each with two rows of loads in flight.  Rows longer than a warp holds
// (d > 1,024 float32, 2,048 bfloat16 or float16) take up to 8 warps, one
// row per block, and add their warps' partial sums in warp order through
// shared memory (so d <= 8,192 float32, 16,384 bfloat16 or float16).
// Where d is not a multiple of the vector (4 float32, 8 bfloat16 or
// float16) or a pointer is not 16-byte aligned, the same kernel runs its
// scalar row path: the same structure with one element
// per chunk and 32 chunks per thread (d <= 8,192).
//
// Any longer row (JAX's kernel takes every d) runs the long-row kernel
// (rmsnorm_rows.cuh): 32 warps a row, a chunk loop for the sum of squares,
// then a second read of the row, from L2, to scale it.  That reads x twice
// where the one-pass path reads it once, so the bound above is met only
// as far as L2 serves the second read: the grid keeps at most
// kL2RowBytes of rows in flight (at least one row per SM).  A float32 x
// over a 16-bit scale (JAX promotes the product) reaches the kernel with
// the scale widened to float32 by the wrapper.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rmsnorm/csrc/rmsnorm_rows.cuh"

namespace {

using repro::rn::chunks_per_thread;
using repro::rn::kLongThreads;
using repro::rn::kMaxThreads;
using repro::rn::kRowsPerBlock;
using repro::rn::rms_norm_long_kernel;
using repro::rn::rms_norm_rows_kernel;

// Bytes of rows the long-row grid keeps in flight: half the H100's 50 MB
// L2, so that the second read of each row hits it.
constexpr long long kL2RowBytes = 24LL << 20;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Rows past the one-pass path: rms_norm_long_kernel, kLongThreads a row,
// as many rows in flight as fit kL2RowBytes (at least one per SM), up to
// the occupancy the kernel reaches.
template <typename T, bool VEC>
int launch_long(const void* x, const void* scale, void* out, int R, int d,
                float eps, cudaStream_t s, int* plan) {
  auto kern = rms_norm_long_kernel<T, VEC>;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kLongThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long fit = kL2RowBytes / (static_cast<long long>(d) * sizeof(T));
  if (fit < n_sm) fit = n_sm;
  long long blocks = static_cast<long long>(n_sm) * per_sm;
  if (blocks > fit) blocks = fit;
  if (blocks > R) blocks = R;
  plan[0] = static_cast<int>(blocks);
  plan[1] = kLongThreads;
  plan[2] = 1;
  plan[3] = VEC ? 1 : 0;
  plan[4] = 0;
  plan[5] = per_sm;
  plan[6] = 1;
  kern<<<static_cast<int>(blocks), kLongThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), R, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch(const void* x, const void* scale, void* out, int R, int d,
           float eps, cudaStream_t s, int* plan) {
  constexpr int N = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int nc = d / N;
  constexpr int per_warp = 32 * chunks_per_thread<VEC>();
  const int wpr = (nc + per_warp - 1) / per_warp;
  if (32 * wpr > kMaxThreads)
    return launch_long<T, VEC>(x, scale, out, R, d, eps, s, plan);
  const int rpb = wpr == 1 ? kRowsPerBlock : 1;
  const int threads = 32 * wpr * rpb;
  const int blocks = (R + rpb - 1) / rpb;
  const int bytes = wpr > 1 ? wpr * static_cast<int>(sizeof(float)) : 0;
  auto kern = rms_norm_rows_kernel<T, VEC>;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, threads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = blocks;
  plan[1] = threads;
  plan[2] = rpb;
  plan[3] = VEC ? 1 : 0;
  plan[4] = bytes;
  plan[5] = per_sm;
  plan[6] = 0;
  kern<<<blocks, threads, bytes, s>>>(static_cast<const T*>(x),
                                      static_cast<const T*>(scale),
                                      static_cast<T*>(out), R, d, eps, wpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int with_path(const void* x, const void* scale, void* out, int R, int d,
              float eps, cudaStream_t s, int* plan) {
  constexpr int N = 16 / static_cast<int>(sizeof(T));
  const bool vec =
      d % N == 0 && aligned16(x) && aligned16(scale) && aligned16(out);
  return vec ? launch<T, true>(x, scale, out, R, d, eps, s, plan)
             : launch<T, false>(x, scale, out, R, d, eps, s, plan);
}

}  // namespace

extern "C" {

// x, out: (R, d) contiguous; scale: (d,), all of one dtype (0 = float32,
// 1 = bfloat16, 2 = float16); any d >= 1.  plan (7 ints) receives
// blocks, threads per block, rows per block, the vector path (1) or the
// scalar one (0), dynamic shared bytes, blocks per SM (occupancy) and the
// long-row kernel (1) or the one-pass one (0).  Returns the
// cudaError_t of the launch (0 on success).
int repro_rms_norm_2d(const void* x, const void* scale, void* out, int dtype,
                      int R, int d, float eps, void* stream, int* plan) {
  if (R <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return with_path<float>(x, scale, out, R, d, eps, s, plan);
  if (dtype == 1)
    return with_path<__nv_bfloat16>(x, scale, out, R, d, eps, s, plan);
  if (dtype == 2) return with_path<__half>(x, scale, out, R, d, eps, s, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
