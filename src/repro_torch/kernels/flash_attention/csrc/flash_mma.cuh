// The tile loop of the tensor-core flash-attention kernel
// (flash_attention.cu).  A block is 4 warps: 4 / P slices of 16 query
// rows of one (batch, head), each slice shared by P warps that split the
// columns of every KV tile between them (P = 1, 2 or 4).  The block walks
// the KV tiles in ascending order.  Port of ``_kernel`` /
// ``online_softmax_step`` of src/repro/kernels/flash_attention/kernel.py
// (:80, :28).
//
// Per warp and its BK / P columns of a KV tile:
//   s   = (q * scale) k^T            tensor cores, in registers
//   s   = -1e30 where col > row      (causal, on a tile that crosses the
//                                     warp's diagonal only)
//   m'  = max(m, rowmax s)           quad shuffles (the 4 lanes of a row)
//   p   = exp(s - m'), a = exp(m - m'), l = a l + rowsum p
//   acc = a acc + p v                p v on the tensor cores into fresh
//                                     registers, p straight from the
//                                     score registers; then one FFMA
// then, for P > 1, the P partial states of a row merge through shared
// memory (m = max m_i, l = sum l_i exp(m_i - m), acc likewise), and
// out = acc / max(l, 1e-20).  No score tile goes through shared memory.
// (A warp whose columns are all masked so far for a row holds m = -1e30;
// its sums are wiped by alpha = 0 at the row's first real score, or get
// weight 0 in the merge.)
//
// The running accumulator never goes through the tensor core: each
// tile's p v is summed from zero there and added to acc by FFMA, in
// round-to-nearest.  (Summing every tile's p v into one tensor-core
// accumulator lost accuracy over long rows, as if its float32 additions
// did not round to nearest.)
//
// Products.  float32: 3xTF32 mma.sync m16n8k8, each operand split into a
// TF32 big part rna(x) and the remainder x - big, small.big + big.small +
// big.big (megastep/ref.py ``tf32x3_matmul`` is the CPU twin; the tensor
// core truncates the remainder to TF32 where the twin rounds it, a
// difference below 2^-21 of the product); one TF32 pass would not hold
// the float32 tolerance.  bfloat16: mma.sync m16n8k16 with float32
// accumulators; k and v are exact bfloat16, the float32 operands (q *
// scale and p) are split into bfloat16 hi + lo, two passes (one for q k^T
// at D 64, where q * scale is exact in bfloat16).
//
// Fragment layouts.  A thread (g, c) = (lane / 4, lane % 4) holds score
// elements (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1) of each
// 8-column n-tile.  For TF32 the k index inside an 8-wide k-step is
// permuted (logical c -> 2c, c + 4 -> 2c + 1, in both operands), so the
// score registers are the A fragment of p v with no shuffle, q and k are
// read as float2, and v's rows 2c, 2c + 1.  For bfloat16 the score
// registers of n-tiles 2i, 2i + 1 are exactly the A fragment of k-step i,
// and v's B fragments come from ldmatrix.trans.
//
// Shared memory: a ring of three stages, each a K tile (row stride KS)
// and a V tile (stride VS), filled by 16-byte cp.async two tiles ahead of
// the products, one barrier per tile.  The strides keep the fragment
// reads free of bank conflicts (float32: float2 k reads need KS = 8 mod
// 32, scalar v reads of rows 2c, 2c + 1 need VS = 4 mod 16; bfloat16:
// 32-bit k reads and ldmatrix rows need 4 mod 32 words).  Exponentials
// are __expf (ex2.approx; relative error ~2^-21, well inside the float32
// tolerance).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "flash_attention/csrc/mma_helpers.cuh"

namespace repro {
namespace fa {

constexpr float kMasked = -1e30f;  // the masked score, as the TPU kernel
constexpr int kWarps = 4;          // per block
constexpr int kStages = 3;         // K/V tiles in the cp.async ring

template <typename T, int D>
struct Tiles;
template <int D>
struct Tiles<float, D> {
  static constexpr int BK = 4096 / D;  // KV rows per stage: 64, 32 at D 128
  static constexpr int KS = D + 8;
  static constexpr int VS = D + 4;
};
template <int D>
struct Tiles<__nv_bfloat16, D> {
  static constexpr int BK = 64;
  static constexpr int KS = D + 8;
  static constexpr int VS = D + 8;
};

template <typename T, int D>
__host__ __device__ constexpr int stage_elems() {
  return Tiles<T, D>::BK * (Tiles<T, D>::KS + Tiles<T, D>::VS);
}

template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_elems<T, D>() * static_cast<int>(sizeof(T));
}

// ROWS contiguous rows of D elements -> shared rows of stride STRIDE.
template <typename T, int D, int ROWS, int STRIDE>
__device__ __forceinline__ void stage_tile(T* dst, const T* src) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = D / E;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kWarps * 32) {
    const int r = i / CPR, e = (i % CPR) * E;
    cp_async16(dst + r * STRIDE + e, src + r * D + e);
  }
}

// The products of one warp: NJ score n-tiles (8 columns each) starting at
// KV column ``col0`` of the staged tile.
template <typename T, int D, int NJ>
struct Ops;

template <int D, int NJ>
struct Ops<float, D, NJ> {
  using L = Tiles<float, D>;
  static constexpr int NB = NJ < 8 ? NJ : 8;  // n-tiles per pass-major batch
  float qf[D / 8][4];                         // q * scale, A fragments

  // q: row 0 of the warp's 16 rows.
  __device__ __forceinline__ void load_q(const float* q, float scale, int g,
                                         int c) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int d0 = kk * 8 + 2 * c;
      const float2 a = *reinterpret_cast<const float2*>(q + g * D + d0);
      const float2 b = *reinterpret_cast<const float2*>(q + (g + 8) * D + d0);
      qf[kk][0] = __fmul_rn(a.x, scale);
      qf[kk][1] = __fmul_rn(b.x, scale);
      qf[kk][2] = __fmul_rn(a.y, scale);
      qf[kk][3] = __fmul_rn(b.y, scale);
    }
  }

  __device__ __forceinline__ void scores(const float* sK, float (&s)[NJ][4],
                                         int col0, int g, int c) const {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    const float* k0 = sK + (col0 + g) * L::KS + 2 * c;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = qf[kk][i];
        // at D 128 the split of q stays inside the tile loop: hoisted, its
        // 128 registers spill
        if (D > 64) asm volatile("" : "+f"(a));
        split_tf32_fast(a, ab[i], as[i]);
      }
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += NB) {
        uint32_t bb[NB][2], bs[NB][2];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              k0 + (j0 + j) * 8 * L::KS + kk * 8);
          split_tf32_fast(kv.x, bb[j][0], bs[j][0]);
          split_tf32_fast(kv.y, bb[j][1], bs[j][1]);
        }
        // pass-major: consecutive mma.sync go to independent accumulators
#pragma unroll
        for (int j = 0; j < NB; ++j)
          mma_tf32(s[j0 + j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          mma_tf32(s[j0 + j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          mma_tf32(s[j0 + j], ab, bb[j][0], bb[j][1]);
      }
    }
  }

  // acc = alpha acc + p v over V rows col0 + [0, 8 NJ).
  static __device__ __forceinline__ void pv(const float* sV,
                                            const float (&p)[NJ][4],
                                            float (&acc)[D / 8][4],
                                            const float (&alpha)[2],
                                            int col0, int g, int c,
                                            int /*lane*/) {
#pragma unroll
    for (int j0 = 0; j0 < D / 8; j0 += 8) {  // 8 output n-tiles at a time
      float o[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        uint32_t ab[4], as[4];
        split_tf32_fast(p[kk][0], ab[0], as[0]);  // (g, 2c)
        split_tf32_fast(p[kk][2], ab[1], as[1]);  // (g + 8, 2c)
        split_tf32_fast(p[kk][1], ab[2], as[2]);  // (g, 2c + 1)
        split_tf32_fast(p[kk][3], ab[3], as[3]);  // (g + 8, 2c + 1)
        const float* v0 = sV + (col0 + kk * 8 + 2 * c) * L::VS + j0 * 8 + g;
        uint32_t bb[8][2], bs[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          split_tf32_fast(v0[j * 8], bb[j][0], bs[j][0]);
          split_tf32_fast(v0[L::VS + j * 8], bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(o[j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(o[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(o[j], ab, bb[j][0], bb[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j0 + j][e] = fmaf(acc[j0 + j][e], alpha[e >> 1], o[j][e]);
    }
  }
};

template <int D, int NJ>
struct Ops<__nv_bfloat16, D, NJ> {
  using L = Tiles<__nv_bfloat16, D>;
  static_assert(NJ % 2 == 0, "p v takes k-steps of two score n-tiles");
  // Where D is a power of 4, scale = 1 / sqrt(D) is a power of two and
  // q * scale is exact in bfloat16 (unless it falls below 2^-126, where
  // less than 2^-133 is lost): lo is zero and its pass is left out.
  static constexpr bool kSplitQ = (D & (D - 1)) || (D & 0xAAAAAAAA);
  // q * scale = hi + lo
  uint32_t qh[D / 16][4], ql[kSplitQ ? D / 16 : 1][4];

  __device__ __forceinline__ void load_q(const __nv_bfloat16* q, float scale,
                                         int g, int c) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows g, g + 8; columns +0, +8
        const int row = g + 8 * (i & 1), col = kk * 16 + 2 * c + 8 * (i >> 1);
        const __nv_bfloat162 x =
            *reinterpret_cast<const __nv_bfloat162*>(q + row * D + col);
        uint32_t lo;
        split_bf16x2(__fmul_rn(__low2float(x), scale),
                     __fmul_rn(__high2float(x), scale), qh[kk][i], lo);
        if constexpr (kSplitQ) ql[kk][i] = lo;
      }
    }
  }

  __device__ __forceinline__ void scores(const __nv_bfloat16* sK,
                                         float (&s)[NJ][4], int col0, int g,
                                         int c) const {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* kr =
            sK + (col0 + j * 8 + g) * L::KS + kk * 16 + 2 * c;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        if constexpr (kSplitQ) mma_bf16(s[j], ql[kk], b0, b1);
        mma_bf16(s[j], qh[kk], b0, b1);
      }
    }
  }

  static __device__ __forceinline__ void pv(const __nv_bfloat16* sV,
                                            const float (&p)[NJ][4],
                                            float (&acc)[D / 8][4],
                                            const float (&alpha)[2],
                                            int col0, int, int, int lane) {
    // lane i addresses row i % 8 of matrix i / 8: matrices (k rows 0-7,
    // 8-15) x (columns 0-7, 8-15) of a 16 x 16 block of v
    const __nv_bfloat16* vr =
        sV + (col0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::VS +
        8 * (lane >> 4);
#pragma unroll
    for (int j0 = 0; j0 < D / 8; j0 += 8) {  // 8 output n-tiles at a time
      float o[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        uint32_t ah[4], al[4];
        split_bf16x2(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
        split_bf16x2(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
        split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
        split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vr + kk * 16 * L::VS + j0 * 8 + jj * 16);
          mma_bf16(o[2 * jj], al, b[0], b[1]);
          mma_bf16(o[2 * jj + 1], al, b[2], b[3]);
          mma_bf16(o[2 * jj], ah, b[0], b[1]);
          mma_bf16(o[2 * jj + 1], ah, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j0 + j][e] = fmaf(acc[j0 + j][e], alpha[e >> 1], o[j][e]);
    }
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// Grid (BH, S / (64 / P)), kWarps * 32 threads, smem_bytes<T, D>() of
// dynamic shared memory.  Under CAUSAL the q tiles run in reverse order,
// so the heaviest (those with the most KV tiles) are dispatched first.
template <typename T, int D, bool CAUSAL, int P>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S,
                 float scale) {
  using L = Tiles<T, D>;
  constexpr int BK = L::BK, NJ = BK / 8 / P, STAGE = stage_elems<T, D>();
  constexpr int ROWS = 16 * kWarps / P;  // query rows of the block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wq = warp / P, wp = warp % P;  // row slice, column slice
  const int col0 = wp * NJ * 8;            // the warp's first tile column
  const int qt = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS, wq0 = q0 + wq * 16;
  const long long base = static_cast<long long>(blockIdx.x) * S * D;
  const T* kb = k + base;
  const T* vb = v + base;
  // KV tiles of the block, and of this warp (the block's later tiles lie
  // above the warp's diagonal: p = 0 and alpha = 1 there, so skipping
  // them changes nothing)
  const int n_kt = CAUSAL ? (q0 + ROWS - 1) / BK + 1 : S / BK;
  const int w_kt = CAUSAL ? (wq0 + 15) / BK + 1 : n_kt;

  // tiles 0 and 1 in flight, one commit group each
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_kt) {
      const long long off = static_cast<long long>(t) * BK * D;
      stage_tile<T, D, BK, L::KS>(smem + t * STAGE, kb + off);
      stage_tile<T, D, BK, L::VS>(smem + t * STAGE + BK * L::KS, vb + off);
    }
    cp_async_commit();
  }

  Ops<T, D, NJ> ops;
  ops.load_q(q + base + static_cast<long long>(wq0) * D, scale, g, c);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_kt; ++t) {
    const T* sK = smem + (t % kStages) * STAGE;
    const T* sV = sK + BK * L::KS;
    const bool live = t < w_kt;
    T* nK = smem + ((t + kStages - 1) % kStages) * STAGE;
    const bool next = t + kStages - 1 < n_kt;
    const long long nxt = static_cast<long long>(t + kStages - 1) * BK * D;

    cp_async_wait<kStages - 2>();  // tile t has landed (t + 1 may not)
    __syncthreads();  // ... for every thread, and tile t - 1 is done with,
    if (next) {       // so its stage takes tile t + 2
      stage_tile<T, D, BK, L::KS>(nK, kb + nxt);
      stage_tile<T, D, BK, L::VS>(nK + BK * L::KS, vb + nxt);
    }
    cp_async_commit();

    if (live) {
      float s[NJ][4];
      ops.scores(sK, s, col0, g, c);
      const int k0 = t * BK + col0;
      if (CAUSAL && k0 + NJ * 8 - 1 > wq0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + 2 * c + (e & 1) > wq0 + g + 8 * (e >> 1))
              s[j][e] = kMasked;
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
      // l stays a per-thread partial sum until the end (alpha is the same
      // for the 4 lanes of a row)
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
      Ops<T, D, NJ>::pv(sV, s, acc, alpha, col0, g, c, lane);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);

  if constexpr (P > 1) {
    // column slices 1..P-1 hand (m, l, acc) to slice 0 through shared
    // memory, in the thread's own fragment order
    constexpr int F = D / 2 + 4;  // acc, m, l: floats per thread
    float* buf = reinterpret_cast<float*>(smem_raw);
    __syncthreads();  // every warp is done with the tiles
    if (wp > 0) {
      float* mine = buf + (wq * (P - 1) + wp - 1) * F * 32 + lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32] = acc[j][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mine[(D / 2 + h) * 32] = m[h];
        mine[(D / 2 + 2 + h) * 32] = l[h];
      }
    }
    __syncthreads();
    if (wp > 0) return;
#pragma unroll
    for (int i = 1; i < P; ++i) {
      const float* o = buf + (wq * (P - 1) + i - 1) * F * 32 + lane;
      float a0[2], a1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mi = o[(D / 2 + h) * 32], li = o[(D / 2 + 2 + h) * 32];
        const float mn = fmaxf(m[h], mi);
        a0[h] = __expf(__fsub_rn(m[h], mn));
        a1[h] = __expf(__fsub_rn(mi, mn));
        l[h] = l[h] * a0[h] + li * a1[h];
        m[h] = mn;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] =
              acc[j][e] * a0[e >> 1] + o[(j * 4 + e) * 32] * a1[e >> 1];
    }
  }

  T* o = out + base + static_cast<long long>(wq0) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float den = fmaxf(l[h], 1e-20f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(o + (g + 8 * h) * D + j * 8 + 2 * c,
                 __fdiv_rn(acc[j][2 * h], den),
                 __fdiv_rn(acc[j][2 * h + 1], den));
  }
}

}  // namespace fa
}  // namespace repro
