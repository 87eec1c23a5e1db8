// Flash attention past head dim 256 for Hopper (sm_90a): the kernel and
// the launcher behind the plain-C entry ``repro_flash_attention`` of
// flash_attention_xl.cu (float32), flash_attention_bf16_xl.cu and
// flash_attention_f16_xl.cu, three more libraries that build in parallel
// with the six of flash_launch.cuh.
//
// Replaces, for head dims d > 256, the Pallas TPU kernel
// ``flash_attention`` of src/repro/kernels/flash_attention/kernel.py:118
// (bodies ``_kernel`` and ``online_softmax_step``), whose domain has no
// head-dim limit: the arithmetic is flash_mma.cuh's (3xTF32 products for
// float32, a hi + lo split of the float32 operand for bfloat16 and
// float16, float32 running max / sum / accumulator, q scaled by 1/sqrt(d)
// before the dot, KV tiles above a warp's causal diagonal skipped, acc /
// max(l, 1e-20) in q's type).
//
// Why a kernel of its own: flash_mma.cuh keeps a row slice's accumulator
// in registers, D / 2 of them a thread, and its q and K / V tiles span the
// whole width; past 256 neither fits.  Here a block owns 64 query rows
// (4 warps of 16) and one output slice of kXlSlice = 256 columns of the
// head (grid (BH, ceil(S / 64), ceil(d / 256))).  For every KV tile it
// streams q k^T over the depth in chunks of kXlDepth = 64 columns (the q
// and K chunks by 16-byte cp.async in a ring of two slots, the next chunk
// in flight while the tensor cores take the current one), the scores
// summing in registers; then the online-softmax update and p v over the
// slice's 256 columns of V, staged beside the ring while the chunks
// stream.  Every slice recomputes the scores over all of d, so the
// operations are (slices + 1) / 2 times the one-pass count: 1.5 at d 512,
// 2.5 at 1,024.  The depth is zero-padded to whole chunks and the last
// slice's V columns past d to 256 (zeros add nothing), the last KV tile's
// rows past S are zero and masked to -1e30, q rows past S are not stored.
//
// Bound on the H100: operations, as flash_launch.cuh counts them (4 BH S^2
// d, half under causal).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "flash_attention/csrc/flash_launch.cuh"

namespace repro {
namespace fa {

constexpr int kXlSlice = 256;  // output columns of a block
constexpr int kXlDepth = 64;   // depth of a streamed q / K chunk
constexpr int kXlRows = 16 * kWarps;  // query rows of a block

// Strides in elements: float32 pair reads of q and K need 8 mod 32, the
// 16-bit 32-bit reads a row of 4 mod 16 words; V is read by flash_mma's p
// v (Tiles<T, 256>::VS).
template <typename T>
struct XlTiles {
  static constexpr int BK = Tiles<T, kXlSlice>::BK;  // KV rows of a tile
  static constexpr int CS = kXlDepth + 8;           // q and K chunk rows
  static constexpr int VS = Tiles<T, kXlSlice>::VS;
  static constexpr int SLOT = (kXlRows + BK) * CS;  // one q + K chunk
  static constexpr int V0 = 2 * SLOT;               // V after two slots
  static constexpr int ELEMS = V0 + BK * VS;
};

template <typename T>
__host__ __device__ constexpr int xl_smem_bytes() {
  return XlTiles<T>::ELEMS * static_cast<int>(sizeof(T));
}

// ROWS rows of COLS columns at dst (stride STRIDE) from src (row stride
// ld): element (r, e) is src[r * ld + e] for r < rows and e < cols, else
// zero.  vec: 16-byte cp.async (cols a multiple of a 16-byte chunk, src
// 16-byte aligned), else element copies.
template <typename T, int ROWS, int COLS, int STRIDE>
__device__ __forceinline__ void xl_stage(T* dst, const T* src, int rows,
                                         long long ld, int cols, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = COLS / E;
    for (int i = threadIdx.x; i < ROWS * CPR; i += kWarps * 32) {
      const int r = i / CPR, e = (i % CPR) * E;
      const bool ok = r < rows && e < cols;
      cp_async16_zfill(dst + r * STRIDE + e, ok ? src + (r * ld + e) : src,
                       ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kWarps * 32) {
      const int r = i / COLS, e = i % COLS;
      dst[r * STRIDE + e] = r < rows && e < cols ? src[r * ld + e] : zero<T>();
    }
  }
}

// s += (q * scale) K^T over one chunk, for the warp's 16 rows of q (sQ
// points at them) and the tile's BK rows of K: flash_mma's float32 score
// product (3xTF32) with q scaled as it is read.
template <int NJ>
__device__ __forceinline__ void xl_scores32(const float* sQ, const float* sK,
                                          float (&s)[NJ][4], float scale,
                                          int g, int c) {
  constexpr int CS = XlTiles<float>::CS;
  const float* k0 = sK + g * CS + 2 * c;
#pragma unroll
  for (int kk = 0; kk < kXlDepth / 8; ++kk) {
    const float2 x = *reinterpret_cast<const float2*>(sQ + g * CS + kk * 8 +
                                                      2 * c);
    const float2 y = *reinterpret_cast<const float2*>(
        sQ + (g + 8) * CS + kk * 8 + 2 * c);
    const float a[4] = {__fmul_rn(x.x, scale), __fmul_rn(y.x, scale),
                        __fmul_rn(x.y, scale), __fmul_rn(y.y, scale)};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32_fast(a[i], ab[i], as[i]);
    uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 kv =
          *reinterpret_cast<const float2*>(k0 + j * 8 * CS + kk * 8);
      split_tf32_fast(kv.x, bb[j][0], bs[j][0]);
      split_tf32_fast(kv.y, bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(s[j], as, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(s[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(s[j], ab, bb[j][0], bb[j][1]);
  }
}

// The 16-bit types' chunk: q * scale split into hi + lo of T as it is
// read, K exact in T; lo pass first, as flash_mma.
template <int NJ, typename T>
__device__ __forceinline__ void xl_scores16(const T* sQ, const T* sK,
                                          float (&s)[NJ][4], float scale,
                                          int g, int c) {
  constexpr int CS = XlTiles<T>::CS;
#pragma unroll
  for (int kk = 0; kk < kXlDepth / 16; ++kk) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows g, g + 8; columns +0, +8
      const T* qr = sQ + (g + 8 * (i & 1)) * CS + kk * 16 + 2 * c +
                    8 * (i >> 1);
      split16x2<T>(__fmul_rn(to_f32(qr[0]), scale),
                   __fmul_rn(to_f32(qr[1]), scale), h[i], l[i]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const T* kr = sK + (j * 8 + g) * CS + kk * 16 + 2 * c;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
      mma16<T>(s[j], l, b0, b1);
      mma16<T>(s[j], h, b0, b1);
    }
  }
}

// Grid (BH, ceil(S / 64), ceil(d / 256)), kWarps * 32 threads,
// xl_smem_bytes<T>() of dynamic shared memory; q, k, v, out (BH, S, d)
// with d > 256.  Under CAUSAL the q tiles run in reverse order (heaviest
// first).  flags: kVec, kPair (flash_mma.cuh).
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_xl_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int S, int d,
                float scale, int flags) {
  using L = XlTiles<T>;
  constexpr int BK = L::BK, NJ = BK / 8, CS = L::CS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* sV = smem + L::V0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int qt = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kXlRows, wq0 = q0 + warp * 16;
  const int o0 = blockIdx.z * kXlSlice;  // the block's output columns
  const bool vec = flags & kVec;
  const long long base = static_cast<long long>(blockIdx.x) * S * d;
  const T* qb = q + base + static_cast<long long>(q0) * d;
  const T* kb = k + base;
  const T* vb = v + base;
  const int last = min(q0 + kXlRows, S) - 1;  // the block's last real row
  const int n_kt = CAUSAL ? last / BK + 1 : (S + BK - 1) / BK;
  const int w_kt = wq0 >= S ? 0
                   : CAUSAL ? min(wq0 + 15, S - 1) / BK + 1
                            : n_kt;
  const int nc = (d + kXlDepth - 1) / kXlDepth;  // chunks of the depth

  // chunk i of the launch (tile i / nc, depth chunk i % nc) into slot i & 1
  auto stage_chunk = [&](int i) {
    const int t = i / nc, c0 = (i % nc) * kXlDepth;
    T* slot = smem + (i & 1) * L::SLOT;
    xl_stage<T, kXlRows, kXlDepth, CS>(slot, qb + c0, S - q0, d, d - c0,
                                       vec);
    xl_stage<T, BK, kXlDepth, CS>(
        slot + kXlRows * CS, kb + static_cast<long long>(t) * BK * d + c0,
        S - t * BK, d, d - c0, vec);
  };

  float acc[kXlSlice / 8][4];
#pragma unroll
  for (int j = 0; j < kXlSlice / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};

  stage_chunk(0);
  cp_async_commit();
  for (int t = 0; t < n_kt; ++t) {
    const bool live = t < w_kt;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    for (int ci = 0; ci < nc; ++ci) {
      const int i = t * nc + ci;
      cp_async_wait<0>();  // chunk i has landed (and V of tile t)
      __syncthreads();     // ... for every thread; chunk i - 1 and p v of
                           // tile t - 1 are done with
      if (i + 1 < n_kt * nc) stage_chunk(i + 1);
      if (ci == 0)
        xl_stage<T, BK, kXlSlice, L::VS>(
            sV, vb + static_cast<long long>(t) * BK * d + o0, S - t * BK, d,
            d - o0, vec);
      cp_async_commit();
      if (live) {
        const T* slot = smem + (i & 1) * L::SLOT;
        if constexpr (std::is_same<T, float>::value)
          xl_scores32<NJ>(slot + warp * 16 * CS, slot + kXlRows * CS, s,
                          scale, g, c);
        else
          xl_scores16<NJ>(slot + warp * 16 * CS, slot + kXlRows * CS, s,
                          scale, g, c);
      }
    }
    cp_async_wait<0>();  // V of tile t has landed
    __syncthreads();
    if (live) {
      const int k0 = t * BK;
      if ((CAUSAL && k0 + BK - 1 > wq0) || k0 + BK > S) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + 2 * c + (e & 1);
            if (col >= S || (CAUSAL && col > wq0 + g + 8 * (e >> 1)))
              s[j][e] = kMasked;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        alpha[h] = __expf(__fsub_rn(m[h], mx[h]));
        m[h] = mx[h];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(__fsub_rn(s[j][e], m[e >> 1]));
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
      Ops<T, kXlSlice, NJ, false>::pv(sV, s, acc, alpha, 0, g, c, lane);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);

  // rows past S and columns past d are not stored; pairs where d is even
  T* o = out + base + static_cast<long long>(wq0) * d + o0;
  const int dn = d - o0;  // the slice's columns inside d
  const bool pair = flags & kPair;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (wq0 + row >= S) continue;
    const float den = fmaxf(l[h], 1e-20f);
    T* orow = o + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < kXlSlice / 8; ++j) {
      const int col = j * 8 + 2 * c;
      if (col >= dn) continue;
      const float a = __fdiv_rn(acc[j][2 * h], den);
      const float b = __fdiv_rn(acc[j][2 * h + 1], den);
      if (pair) {
        store_pair(orow + col, a, b);
      } else {
        store_one(orow + col, a);
        if (col + 1 < dn) store_one(orow + col + 1, b);
      }
    }
  }
}

template <typename T, bool CAUSAL>
int xl_launch(const void* q, const void* k, const void* v, void* out, int BH,
              int S, int d, float scale, int flags, cudaStream_t s,
              int* plan) {
  constexpr int bytes = xl_smem_bytes<T>();
  auto kern = flash_xl_kernel<T, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kXlRows - 1) / kXlRows,
                  (d + kXlSlice - 1) / kXlSlice);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      32 * kWarps, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = static_cast<int>(grid.x);
  plan[1] = static_cast<int>(grid.y);
  plan[2] = 32 * kWarps;
  plan[3] = bytes;
  plan[4] = per_sm;
  plan[5] = XlTiles<T>::BK;
  plan[6] = 1;
  plan[7] = (d + kXlDepth - 1) / kXlDepth * kXlDepth;
  plan[8] = 2;
  plan[9] = flags;
  kern<<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, d, scale, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int xl_entry(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int d, int causal, float scale, void* stream, int* plan) {
  if (BH <= 0 || S <= 0 || d <= kXlSlice)
    return static_cast<int>(cudaErrorInvalidValue);
  int flags = 0;
  if ((d * sizeof(T)) % 16 == 0 && aligned16(q) && aligned16(k) &&
      aligned16(v))
    flags |= kVec;
  if (d % 2 == 0 &&
      reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0)
    flags |= kPair;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? xl_launch<T, true>(q, k, v, out, BH, S, d, scale, flags, s,
                                     plan)
                : xl_launch<T, false>(q, k, v, out, BH, S, d, scale, flags,
                                      s, plan);
}

}  // namespace fa
}  // namespace repro

// q, k, v, out: (BH, S, d) contiguous, one dtype; any S >= 1, d > 256.
// plan (10 ints) as flash_launch.cuh's: grid x, grid y (the slices are
// grid z, ceil(d / 256)), threads, dynamic shared bytes, blocks per SM, KV
// tile rows, 1 (no KV split), the padded depth, 2 (the ring's slots) and
// the flags.  Returns the cudaError_t of the launch (0 on success).
#define REPRO_FLASH_XL_ENTRY(T)                                             \
  extern "C" int repro_flash_attention(const void* q, const void* k,       \
                                       const void* v, void* out, int BH,   \
                                       int S, int d, int causal,           \
                                       float scale, void* stream,          \
                                       int* plan) {                        \
    return repro::fa::xl_entry<T>(q, k, v, out, BH, S, d, causal, scale,    \
                                  stream, plan);                           \
  }
