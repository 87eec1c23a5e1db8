// Blockwise online-softmax attention for Hopper (sm_90a): the launcher
// behind the plain-C entry ``repro_flash_attention`` of the six sources
// flash_attention.cu (float32, head widths 32, 64, 96, 128),
// flash_attention_wide.cu (float32, 160, 192, 224, 256) and their
// bfloat16 and float16 twins flash_attention_{bf16,f16}{,_wide}.cu, built
// as six libraries so that nvcc compiles them in parallel.
//
// Replaces the Pallas TPU kernel ``flash_attention`` of
// src/repro/kernels/flash_attention/kernel.py:118 (bodies ``_kernel`` and
// ``online_softmax_step``): q, k, v (BH, S, d) in float32, bfloat16 or
// float16, float32 running max / denominator / accumulator, q scaled by
// 1/sqrt(d) before the dot, causal KV blocks above the diagonal skipped, output
// acc / max(l, 1e-20) in q's dtype.  Its domain: every S >= 1 and every
// head dim d from 1 to 256 (past 256, flash_xl.cuh).  A head dim runs at
// the least width D >= d of
// 32, 64, 96, 128, 160, 192, 224, 256 (D - d < 32), zero-padded inside
// the kernel; rows that are not whole 16-byte chunks at 16-byte aligned
// pointers are staged element by element.
//
// Bound on the H100: 4 BH S^2 d operations (q k^T and p v; half of the
// pairs when causal) against 4 BH S d elements moved.  At the megastep
// shape (36, 64, 64) bytes bound it; at prefill length (9, 2048, 64) the
// operations do: 73.6 us at the float32 rate of the SIMT units (67
// TFLOP/s), 30.7 us on the units this kernel uses (3 TF32 passes at 495
// TFLOP/s plus the softmax at the float32 rate).  The padding to D costs
// (D - d) / d more products.
//
// Design (flash_mma.cuh has the tile loop):
//   * both products on the tensor cores (mma.sync: 3xTF32 for float32,
//     bfloat16 or float16 with a hi + lo split of the float32 operand),
//     scores, running max / sum and accumulator in registers, row
//     reductions by quad shuffles;
//   * K and V tiles staged by 16-byte cp.async in a ring of three stages
//     (two at widths 224 and 256, where q also lives in shared memory),
//     one barrier per tile;
//   * 4 warps per block over 64 query rows; where that gives fewer blocks
//     than SMs, 32 or 16 rows, with 2 or 4 warps splitting the columns of
//     every KV tile and merging their softmax states at the end
//     ((9, 2048, 64) runs 288 blocks of 64 rows, (36, 64, 64) 144 blocks
//     of 16 rows); up to width 128 three stages stay under 108 KB, so two
//     blocks fit on an SM;
//   * under causal the q tiles launch heaviest first.
// The caller's block sizes do not reach the kernel: it tiles for the card
// (KV tiles of 64 rows; 32 for float32 past width 64).  (The SIMT body
// online_softmax.cuh is the megastep kernel's; this kernel does not use
// it.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "flash_attention/csrc/flash_mma.cuh"

namespace repro {
namespace fa {

constexpr int kExactQ = 4;  // plan flag: the instantiation QX ran

template <typename T, int D, bool CAUSAL, bool QX, int P>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int d, float scale, int flags, cudaStream_t s, int* plan) {
  constexpr int bytes = smem_bytes<T, D>();
  constexpr int rows = 16 * kWarps / P;
  auto kern = flash_mma_kernel<T, D, CAUSAL, P, QX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + rows - 1) / rows);
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
  plan[7] = D;
  plan[8] = stages<T, D>();
  plan[9] = flags | (QX ? kExactQ : 0);
  kern<<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, d, scale, flags);
  return static_cast<int>(cudaGetLastError());
}

// P, the warps that share a slice of 16 query rows: 1 (64 rows per
// block), unless that leaves SMs without a block; then 2 or 4.
template <typename T, int D, bool CAUSAL, bool QX>
int with_split(const void* q, const void* k, const void* v, void* out,
               int BH, int S, int d, float scale, int flags, cudaStream_t s,
               int* plan) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(BH) * ((S + 63) / 64);
  if (tiles >= n_sm)
    return launch<T, D, CAUSAL, QX, 1>(q, k, v, out, BH, S, d, scale, flags,
                                       s, plan);
  if (2 * tiles >= n_sm)
    return launch<T, D, CAUSAL, QX, 2>(q, k, v, out, BH, S, d, scale, flags,
                                       s, plan);
  return launch<T, D, CAUSAL, QX, 4>(q, k, v, out, BH, S, d, scale, flags, s,
                                     plan);
}

template <typename T, int D, bool QX>
int with_causal(bool causal, const void* q, const void* k, const void* v,
                void* out, int BH, int S, int d, float scale, int flags,
                cudaStream_t s, int* plan) {
  return causal ? with_split<T, D, true, QX>(q, k, v, out, BH, S, d, scale,
                                             flags, s, plan)
                : with_split<T, D, false, QX>(q, k, v, out, BH, S, d, scale,
                                              flags, s, plan);
}

// bfloat16 at d = D = 64 or 256: 1 / sqrt(d) is a power of two, q * scale
// is exact in bfloat16, and the kernel QX leaves out q's lo pass.  (Other
// powers of 4 run the two passes, the second adding zeros.)
template <typename T, int D>
constexpr bool has_exact_q() {
  return std::is_same<T, __nv_bfloat16>::value && (D == 64 || D == 256);
}

// The least width W >= d of the library's list.
template <typename T, int W, int... Rest>
int with_width(bool causal, const void* q, const void* k, const void* v,
               void* out, int BH, int S, int d, float scale, int flags,
               cudaStream_t s, int* plan) {
  if (d <= W) {
    if constexpr (has_exact_q<T, W>()) {
      if (d == W)
        return with_causal<T, W, true>(causal, q, k, v, out, BH, S, d, scale,
                                       flags, s, plan);
    }
    return with_causal<T, W, false>(causal, q, k, v, out, BH, S, d, scale,
                                    flags, s, plan);
  }
  if constexpr (sizeof...(Rest) > 0)
    return with_width<T, Rest...>(causal, q, k, v, out, BH, S, d, scale,
                                  flags, s, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The entry of a library holding widths W0 < W...: d in (W0 - 32, last].
template <typename T, int W0, int... W>
int entry(const void* q, const void* k, const void* v, void* out, int BH,
          int S, int d, int causal, float scale, void* stream, int* plan) {
  constexpr int widths[] = {W0, W...};
  if (BH <= 0 || S <= 0 || d <= W0 - 32 || d > widths[sizeof...(W)])
    return static_cast<int>(cudaErrorInvalidValue);
  int flags = 0;
  if ((d * sizeof(T)) % 16 == 0 && aligned16(q) && aligned16(k) &&
      aligned16(v))
    flags |= kVec;
  if (d % 2 == 0 &&
      reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0)
    flags |= kPair;
  return with_width<T, W0, W...>(causal != 0, q, k, v, out, BH, S, d, scale,
                                 flags, static_cast<cudaStream_t>(stream),
                                 plan);
}

}  // namespace fa
}  // namespace repro

// q, k, v, out: (BH, S, d) contiguous, one dtype; any S >= 1, d in the
// library's widths.  plan (10 ints) receives grid x, grid y, threads per
// block, dynamic shared bytes, blocks per SM (occupancy), KV tile rows, P
// (warps per 16 query rows), the width D, the ring's stages and the
// flags (1: 16-byte staging and paired q loads, 2: paired stores, 4: the
// bfloat16 kernel without q's lo pass).  Returns the cudaError_t of the
// launch (0 on success).
#define REPRO_FLASH_ENTRY(T, ...)                                           \
  extern "C" int repro_flash_attention(const void* q, const void* k,       \
                                       const void* v, void* out, int BH,   \
                                       int S, int d, int causal,           \
                                       float scale, void* stream,          \
                                       int* plan) {                        \
    return repro::fa::entry<T, __VA_ARGS__>(q, k, v, out, BH, S, d,         \
                                            causal, scale, stream, plan);  \
  }
