// Blockwise online-softmax attention for Hopper (sm_90a), plain-C ABI.
//
// Replaces the Pallas TPU kernel ``flash_attention`` of
// src/repro/kernels/flash_attention/kernel.py:118 (bodies ``_kernel`` and
// ``online_softmax_step``): q, k, v (BH, S, D) in float32 or bfloat16,
// float32 running max / denominator / accumulator, q scaled by 1/sqrt(D)
// before the dot, causal KV blocks above the diagonal skipped, output
// acc / max(l, 1e-20) in q's dtype.
//
// Bound on the H100: 4 BH S^2 D operations (q k^T and p v; half of the
// pairs when causal) against 4 BH S D elements moved.  At the megastep
// shape (36, 64, 64) bytes bound it; at prefill length (9, 2048, 64) the
// operations do: 73.6 us at the float32 rate of the SIMT units (67
// TFLOP/s), 30.7 us on the units this kernel uses (3 TF32 passes at 495
// TFLOP/s plus the softmax at the float32 rate).
//
// Design (flash_mma.cuh has the tile loop):
//   * both products on the tensor cores (mma.sync: 3xTF32 for float32,
//     bfloat16 with a hi + lo split of the float32 operand), scores,
//     running max / sum and accumulator in registers, row reductions by
//     quad shuffles;
//   * K and V tiles staged by 16-byte cp.async in a three-stage ring, two
//     tiles ahead of the products, one barrier per tile;
//   * 4 warps per block over 64 query rows; where that gives fewer blocks
//     than SMs, 32 or 16 rows, with 2 or 4 warps splitting the columns of
//     every KV tile and merging their softmax states at the end
//     ((9, 2048, 64) runs 288 blocks of 64 rows, (36, 64, 64) 144 blocks
//     of 16 rows); three stages stay under 108 KB, so two blocks fit on
//     an SM;
//   * under causal the q tiles launch heaviest first.
// The caller's block sizes do not reach the kernel: it tiles for the card
// (KV tiles of 64 rows, 32 for float32 at D 128).  D is 64 or 128; S a
// multiple of 64.  (The SIMT body online_softmax.cuh is the megastep
// kernel's; this kernel does not use it.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention/csrc/flash_mma.cuh"

namespace {

using repro::fa::flash_mma_kernel;
using repro::fa::kWarps;
using repro::fa::smem_bytes;
using repro::fa::Tiles;

constexpr int kSeqMultiple = 64;

template <typename T, int D, bool CAUSAL, int P>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, float scale, cudaStream_t s, int* plan) {
  constexpr int bytes = smem_bytes<T, D>();
  auto kern = flash_mma_kernel<T, D, CAUSAL, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, S / (16 * kWarps / P));
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      32 * kWarps, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = static_cast<int>(grid.x);
  plan[1] = static_cast<int>(grid.y);
  plan[2] = 32 * kWarps;
  plan[3] = bytes;
  plan[4] = per_sm;
  plan[5] = Tiles<T, D>::BK;
  plan[6] = P;
  kern<<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, scale);
  return static_cast<int>(cudaGetLastError());
}

// P, the warps that share a slice of 16 query rows: 1 (64 rows per
// block), unless that leaves SMs without a block; then 2 or 4.
template <typename T, int D, bool CAUSAL>
int with_split(const void* q, const void* k, const void* v, void* out,
               int BH, int S, float scale, cudaStream_t s, int* plan) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(BH) * (S / 64);
  if (tiles >= n_sm)
    return launch<T, D, CAUSAL, 1>(q, k, v, out, BH, S, scale, s, plan);
  if (2 * tiles >= n_sm)
    return launch<T, D, CAUSAL, 2>(q, k, v, out, BH, S, scale, s, plan);
  return launch<T, D, CAUSAL, 4>(q, k, v, out, BH, S, scale, s, plan);
}

template <typename T, int D>
int with_causal(bool causal, const void* q, const void* k, const void* v,
                void* out, int BH, int S, float scale, cudaStream_t s,
                int* plan) {
  return causal
             ? with_split<T, D, true>(q, k, v, out, BH, S, scale, s, plan)
             : with_split<T, D, false>(q, k, v, out, BH, S, scale, s, plan);
}

template <typename T>
int with_dim(int D, bool causal, const void* q, const void* k, const void* v,
             void* out, int BH, int S, float scale, cudaStream_t s,
             int* plan) {
  if (D == 64)
    return with_causal<T, 64>(causal, q, k, v, out, BH, S, scale, s, plan);
  if (D == 128)
    return with_causal<T, 128>(causal, q, k, v, out, BH, S, scale, s, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v, out: (BH, S, D) contiguous, 16-byte aligned, one dtype (0 =
// float32, 1 = bfloat16); D 64 or 128; S a multiple of 64.  plan (7 ints)
// receives grid x, grid y, threads per block, dynamic shared bytes, blocks
// per SM (occupancy), KV tile rows and P (warps per 16 query rows).
// Returns the cudaError_t of the launch (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int dtype, int BH, int S, int D,
                          int causal, float scale, void* stream, int* plan) {
  if (BH <= 0 || S <= 0 || S % kSeqMultiple)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return with_dim<float>(D, causal != 0, q, k, v, out, BH, S, scale, s,
                           plan);
  if (dtype == 1)
    return with_dim<__nv_bfloat16>(D, causal != 0, q, k, v, out, BH, S,
                                   scale, s, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
