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
// operations do, at the float32 rate of 67 TFLOP/s (no tensor cores here).
//
// Design (the simple one): one block of 256 threads per (bh, q block); the
// TPU's sequential KV grid axis becomes a loop inside the block.  Each KV
// block is staged in shared memory as float32 and fed to the shared
// online_softmax_step body (online_softmax.cuh) with FFMA on the SIMT
// units.  No cp.async / TMA pipelining and no tensor cores: that is later
// work.  Head dim 64 only; block sizes 64 or 128, as the caller asks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_attention/csrc/online_softmax.cuh"
#include "rmsnorm/csrc/rmsnorm_body.cuh"

namespace {

using repro::kAttnThreads;

constexpr int kD = 64;

template <typename T>
__device__ __forceinline__ void load_rows(const T* g, float* s, int rows,
                                          int stride, float scale) {
  for (int i = threadIdx.x; i < rows * kD; i += kAttnThreads) {
    const int r = i / kD, c = i % kD;
    s[r * stride + c] = repro::to_f32(g[i]) * scale;
  }
}

template <int BQ, int BK>
constexpr int smem_floats() {
  return BQ * (kD + 1) + BK * (kD + 1) + BK * kD + BQ * (BK + 1);
}

template <typename T, int BQ, int BK, bool CAUSAL>
__global__ void __launch_bounds__(kAttnThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S,
             float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * (kD + 1);
  float* sV = sK + BK * (kD + 1);
  float* sP = sV + BK * kD;
  const int q_start = blockIdx.x * BQ;
  const long long base = static_cast<long long>(blockIdx.y) * S * kD;

  load_rows(q + base + static_cast<long long>(q_start) * kD, sQ, BQ,
            kD + 1, scale);
  repro::SoftmaxState<BQ, kD> st;
  st.init();
  for (int k_start = 0; k_start < S; k_start += BK) {
    if (CAUSAL && k_start > q_start + BQ - 1) break;  // above the diagonal
    __syncthreads();  // sQ is loaded; the last step is done with sK / sV
    load_rows(k + base + static_cast<long long>(k_start) * kD, sK, BK,
              kD + 1, 1.0f);
    load_rows(v + base + static_cast<long long>(k_start) * kD, sV, BK, kD,
              1.0f);
    __syncthreads();
    repro::online_softmax_step<BQ, BK, kD, CAUSAL>(sQ, sK, sV, sP, st,
                                                    q_start, k_start);
  }
  T* o = out + base + static_cast<long long>(q_start) * kD;
  repro::softmax_finish<BQ, kD>(st, [&](int row, int col, float val) {
    o[row * kD + col] = repro::from_f32<T>(val);
  });
}

template <typename T, int BQ, int BK, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, float scale, cudaStream_t s) {
  constexpr int bytes = smem_floats<BQ, BK>() * 4;
  auto kern = flash_kernel<T, BQ, BK, CAUSAL>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3(S / BQ, BH), kAttnThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BQ, int BK>
int with_causal(bool causal, const void* q, const void* k, const void* v,
                void* out, int BH, int S, float scale, cudaStream_t s) {
  return causal ? launch<T, BQ, BK, true>(q, k, v, out, BH, S, scale, s)
                : launch<T, BQ, BK, false>(q, k, v, out, BH, S, scale, s);
}

template <typename T>
int with_blocks(int bq, int bk, bool causal, const void* q, const void* k,
                const void* v, void* out, int BH, int S, float scale,
                cudaStream_t s) {
  if (bq == 64 && bk == 64)
    return with_causal<T, 64, 64>(causal, q, k, v, out, BH, S, scale, s);
  if (bq == 64 && bk == 128)
    return with_causal<T, 64, 128>(causal, q, k, v, out, BH, S, scale, s);
  if (bq == 128 && bk == 64)
    return with_causal<T, 128, 64>(causal, q, k, v, out, BH, S, scale, s);
  if (bq == 128 && bk == 128)
    return with_causal<T, 128, 128>(causal, q, k, v, out, BH, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v, out: (BH, S, 64) contiguous, one dtype (0 = float32,
// 1 = bfloat16); S a multiple of both block sizes (64 or 128 each).
// Returns the cudaError_t of the launch (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int dtype, int BH, int S, int D,
                          int block_q, int block_k, int causal, float scale,
                          void* stream) {
  if (D != kD || S % block_q || S % block_k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return with_blocks<float>(block_q, block_k, causal != 0, q, k, v, out,
                              BH, S, scale, s);
  if (dtype == 1)
    return with_blocks<__nv_bfloat16>(block_q, block_k, causal != 0, q, k,
                                      v, out, BH, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
