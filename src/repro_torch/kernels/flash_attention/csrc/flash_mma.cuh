// The tile loop of the tensor-core flash-attention kernel
// (flash_launch.cuh).  A block is 4 warps: 4 / P slices of 16 query rows
// of one (batch, head), each slice shared by P warps that split the
// columns of every KV tile between them (P = 1, 2 or 4).  The block walks
// the KV tiles in ascending order.  Port of ``_kernel`` /
// ``online_softmax_step`` of src/repro/kernels/flash_attention/kernel.py
// (:80, :28).
//
// Per warp and its BK / P columns of a KV tile:
//   s   = (q * scale) k^T            tensor cores, in registers
//   s   = -1e30 where col > row      (causal) or col >= S, on a tile that
//                                     crosses the warp's diagonal or S
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
// weight 0 in the merge.  Column 0 is real for every row, so every row
// that is stored has a real maximum.)
//
// Any head dim d runs at a width D >= d (template; flash_launch.cuh names
// the widths): q, k and v are zero past column d in registers and shared
// memory, so the scores are those of width d, the scale is the caller's
// 1 / sqrt(d), and output columns past d are not stored.  Any S: the grid
// covers ceil(S / rows) q tiles and the loop ceil(S / BK) KV tiles; K / V
// rows past S are zero in the ring and their scores -1e30 (p = 0), q rows
// past S are zero and not stored.
//
// Staging.  K and V tiles go through a ring of ``stages<T, D>()`` stages
// (three, two where three and q do not fit), filled two tiles (one) ahead
// of the products, one barrier per tile.  Rows of 16-byte multiples at
// 16-byte aligned pointers go by 16-byte cp.async, the chunks past d or S
// zero-filled by the same instruction (no branch); other rows (float32 at
// d % 4 != 0, bfloat16 or float16 at d % 8 != 0) element by element through
// registers: the stage being filled is the one every warp finished at the
// barrier before, so the plain stores need no other ordering.
//
// q.  Up to width 128 each warp holds its 16 rows of q * scale as A
// fragments in registers.  Past 128 those and the accumulator would not
// fit (at 256 in float32, 128 + 128 registers a thread): the block stages
// q * scale (float32) or its 16-bit hi and lo once in shared memory
// beside the ring, and the warps read their fragments from there at every
// KV tile.
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
// the float32 tolerance.  bfloat16 and float16: mma.sync m16n8k16 with
// float32 accumulators; k and v are exact in their type, the float32
// operands (q * scale and p) are split into hi + lo of that type, two
// passes (float16's lo is subnormal where |x| < 2^-3: an absolute error
// under 2^-25, against an output tolerance of 2^-10), one for q k^T
// in the instantiations QX, for d = D = 64 or 256: the scale is a power of
// two there, so that q * scale is exact in bfloat16 and lo is zero; in
// float16 a product past the subnormal edge would not be, so float16
// always takes both passes).
//
// Fragment layouts.  A thread (g, c) = (lane / 4, lane % 4) holds score
// elements (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1) of each
// 8-column n-tile.  For TF32 the k index inside an 8-wide k-step is
// permuted (logical c -> 2c, c + 4 -> 2c + 1, in both operands), so the
// score registers are the A fragment of p v with no shuffle, q and k are
// read as pairs, and v's rows 2c, 2c + 1.  For 16-bit types the score
// registers of n-tiles 2i, 2i + 1 are exactly the A fragment of k-step i,
// and v's B fragments come from ldmatrix.trans.
//
// Strides keep the fragment reads free of bank conflicts at every width
// (a multiple of 32): float32 float2 k and q reads need KS = QS = 8 mod
// 32, scalar v reads of rows 2c, 2c + 1 need VS = 4 mod 16; 16-bit
// 32-bit k and q reads and ldmatrix rows need a row of 4 mod 16 words.
// Exponentials are __expf (ex2.approx; relative error ~2^-21, well inside
// the float32 tolerance).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

#include "flash_attention/csrc/mma_helpers.cuh"

namespace repro {
namespace fa {

constexpr float kMasked = -1e30f;  // the masked score, as the TPU kernel
constexpr int kWarps = 4;          // per block
constexpr int kMaxSmem = 232448;   // dynamic shared bytes a block may take

// Launch flags (flash_launch.cuh sets them per call).
constexpr int kVec = 1;   // K / V rows by 16-byte cp.async, q by pairs
constexpr int kPair = 2;  // output stored in pairs (d even)

template <typename T, int D>
struct Tiles;
template <int D>
struct Tiles<float, D> {
  static constexpr int BK = D <= 64 ? 64 : 32;  // KV rows per stage
  static constexpr int KS = D + 8;
  static constexpr int VS = D + 4;
  static constexpr int QS = D + 8;
  static constexpr int Q_ELEMS = 16 * kWarps * QS;  // q * scale
};
template <int D>
struct Tiles<__nv_bfloat16, D> {
  static constexpr int BK = 64;
  static constexpr int KS = D + 8;
  static constexpr int VS = D + 8;
  static constexpr int QS = D + 8;
  static constexpr int Q_ELEMS = 2 * 16 * kWarps * QS;  // hi, then lo
};
template <int D>
struct Tiles<__half, D> : Tiles<__nv_bfloat16, D> {};

// The 16-bit types' tensor-core product and float32 split (bfloat16 or
// float16 operands, float32 accumulators).
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(d, a, b0, b1);
  else
    mma_bf16(d, a, b0, b1);
}

template <typename T>
__device__ __forceinline__ void split16x2(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo) {
  if constexpr (std::is_same<T, __half>::value)
    split_f16x2(x0, x1, hi, lo);
  else
    split_bf16x2(x0, x1, hi, lo);
}

template <int D>
__host__ __device__ constexpr bool q_in_smem() {
  return D > 128;
}

template <typename T, int D>
__host__ __device__ constexpr int stage_elems() {
  return Tiles<T, D>::BK * (Tiles<T, D>::KS + Tiles<T, D>::VS);
}

template <typename T, int D>
__host__ __device__ constexpr int q_elems() {
  return q_in_smem<D>() ? Tiles<T, D>::Q_ELEMS : 0;
}

template <typename T, int D>
__host__ __device__ constexpr int stages() {
  return (3 * stage_elems<T, D>() + q_elems<T, D>()) *
                     static_cast<int>(sizeof(T)) <=
                 kMaxSmem
             ? 3
             : 2;
}

template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  return (stages<T, D>() * stage_elems<T, D>() + q_elems<T, D>()) *
         static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
template <>
__device__ __forceinline__ __half zero<__half>() {
  return __float2half_rn(0.0f);
}

// Element (r, col) of the rows at q (d elements each), as float32: zero
// past ``rows`` rows or d columns.
template <typename T>
__device__ __forceinline__ float q_at(const T* q, int r, int col, int rows,
                                      int d) {
  return r < rows && col < d ? to_f32(q[static_cast<long long>(r) * d + col])
                             : 0.0f;
}

// (r, col) and (r, col + 1) of the rows at q as float32, zero past
// ``rows`` rows or d columns; one paired load where rows are whole 16-byte
// chunks (col is even, so both lie inside d or neither).
__device__ __forceinline__ float2 q_pair(const float* q, int r, int col,
                                         int rows, int d, bool vec) {
  if (!vec)
    return make_float2(q_at(q, r, col, rows, d), q_at(q, r, col + 1, rows, d));
  return r < rows && col < d ? *reinterpret_cast<const float2*>(q + r * d + col)
                             : make_float2(0.0f, 0.0f);
}
__device__ __forceinline__ float2 q_pair(const __nv_bfloat16* q, int r,
                                         int col, int rows, int d, bool vec) {
  if (!vec)
    return make_float2(q_at(q, r, col, rows, d), q_at(q, r, col + 1, rows, d));
  if (r >= rows || col >= d) return make_float2(0.0f, 0.0f);
  const __nv_bfloat162 x =
      *reinterpret_cast<const __nv_bfloat162*>(q + r * d + col);
  return make_float2(__low2float(x), __high2float(x));
}
__device__ __forceinline__ float2 q_pair(const __half* q, int r, int col,
                                         int rows, int d, bool vec) {
  if (!vec)
    return make_float2(q_at(q, r, col, rows, d), q_at(q, r, col + 1, rows, d));
  if (r >= rows || col >= d) return make_float2(0.0f, 0.0f);
  const __half2 x = *reinterpret_cast<const __half2*>(q + r * d + col);
  return make_float2(__low2float(x), __high2float(x));
}

// v rounded to the 16-bit type T, as T.
__device__ __forceinline__ void to16(__nv_bfloat16& o, float v) {
  o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void to16(__half& o, float v) {
  o = __float2half_rn(v);
}

// ROWS shared rows of width D and stride STRIDE from the ``rows`` valid
// rows of d elements at src: columns past d and rows past ``rows`` zero.
template <typename T, int D, int ROWS, int STRIDE>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int rows,
                                           int d, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
    constexpr int CPR = D / E;
    for (int i = threadIdx.x; i < ROWS * CPR; i += kWarps * 32) {
      const int r = i / CPR, e = (i % CPR) * E;
      const bool ok = r < rows && e < d;
      cp_async16_zfill(dst + r * STRIDE + e, ok ? src + (r * d + e) : src,
                       ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += kWarps * 32) {
      const int r = i / D, e = i % D;
      dst[r * STRIDE + e] = r < rows && e < d ? src[r * d + e] : zero<T>();
    }
  }
}

// The block's ``nrows`` query rows from q (``rows`` of them valid), times
// scale, into shared memory (widths past 128): float32 as it is, a 16-bit
// type as hi = rn(x) and lo = rn(x - hi) in two arrays (lo left out where
// QX).
template <int D, bool QX>
__device__ __forceinline__ void stage_q(float* sq, const float* q, int rows,
                                        int nrows, int d, float scale) {
  for (int i = threadIdx.x; i < nrows * D; i += kWarps * 32) {
    const int r = i / D, col = i % D;
    sq[r * Tiles<float, D>::QS + col] =
        __fmul_rn(q_at(q, r, col, rows, d), scale);
  }
}
template <int D, bool QX, typename T>
__device__ __forceinline__ void stage_q(T* sq, const T* q, int rows,
                                        int nrows, int d, float scale) {
  constexpr int QS = Tiles<T, D>::QS;
  T* lo = sq + 16 * kWarps * QS;
  for (int i = threadIdx.x; i < nrows * D; i += kWarps * 32) {
    const int r = i / D, col = i % D;
    const float x = __fmul_rn(q_at(q, r, col, rows, d), scale);
    T h;
    to16(h, x);
    sq[r * QS + col] = h;
    if constexpr (!QX) to16(lo[r * QS + col], __fsub_rn(x, to_f32(h)));
  }
}

// The products of one warp: NJ score n-tiles (8 columns each) starting at
// KV column ``col0`` of the staged tile; p v over NO output n-tiles at a
// time.  QX: q * scale is exact in bfloat16 (float32 ignores it).
template <typename T, int D, int NJ, bool QX>
struct Ops;

template <int D, int NJ, bool QX>
struct Ops<float, D, NJ, QX> {
  using L = Tiles<float, D>;
  static constexpr bool kSmemQ = q_in_smem<D>();
  static constexpr int NB = NJ < 8 ? NJ : 8;  // n-tiles per pass-major batch
  static constexpr int NO = D % 64 == 0 && D <= 128 ? 8 : 4;
  float qf[kSmemQ ? 1 : D / 8][4];  // q * scale, A fragments
  const float* sq = nullptr;        // or the warp's rows in shared memory

  // q: the warp's first row; rows: its valid rows (may be <= 0).
  __device__ __forceinline__ void load_q(const float* q, int rows, int d,
                                         float scale, bool vec, int g,
                                         int c) {
    if constexpr (!kSmemQ) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int d0 = kk * 8 + 2 * c;
        const float2 a = q_pair(q, g, d0, rows, d, vec);
        const float2 b = q_pair(q, g + 8, d0, rows, d, vec);
        qf[kk][0] = __fmul_rn(a.x, scale);
        qf[kk][1] = __fmul_rn(b.x, scale);
        qf[kk][2] = __fmul_rn(a.y, scale);
        qf[kk][3] = __fmul_rn(b.y, scale);
      }
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
      float a[4];
      if constexpr (kSmemQ) {
        const float* r0 = sq + g * L::QS + kk * 8 + 2 * c;
        const float2 x = *reinterpret_cast<const float2*>(r0);
        const float2 y = *reinterpret_cast<const float2*>(r0 + 8 * L::QS);
        a[0] = x.x;
        a[1] = y.x;
        a[2] = x.y;
        a[3] = y.y;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = qf[kk][i];
          // past D 64 the split of q stays inside the tile loop: hoisted,
          // its registers spill
          if (D > 64) asm volatile("" : "+f"(a[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32_fast(a[i], ab[i], as[i]);
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
    for (int j0 = 0; j0 < D / 8; j0 += NO) {  // NO output n-tiles at a time
      float o[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j)
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
        uint32_t bb[NO][2], bs[NO][2];
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          split_tf32_fast(v0[j * 8], bb[j][0], bs[j][0]);
          split_tf32_fast(v0[L::VS + j * 8], bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NO; ++j) mma_tf32(o[j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < NO; ++j) mma_tf32(o[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < NO; ++j) mma_tf32(o[j], ab, bb[j][0], bb[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j0 + j][e] = fmaf(acc[j0 + j][e], alpha[e >> 1], o[j][e]);
    }
  }
};

// bfloat16 and float16 (T): the same fragments, the type's mma.sync and
// hi + lo split.
template <typename T, int D, int NJ, bool QX>
struct Ops16 {
  using L = Tiles<T, D>;
  static_assert(NJ % 2 == 0, "p v takes k-steps of two score n-tiles");
  static constexpr bool kSmemQ = q_in_smem<D>();
  static constexpr int NO = D % 64 == 0 && D <= 128 ? 8 : 4;
  static constexpr int NQ = kSmemQ ? 1 : D / 16;
  // q * scale = hi + lo, A fragments (or the warp's rows of hi; lo at
  // 16 kWarps rows past them); lo is zero where QX and is left out
  uint32_t qh[NQ][4], ql[QX ? 1 : NQ][4];
  const T* sq = nullptr;

  __device__ __forceinline__ void load_q(const T* q, int rows,
                                         int d, float scale, bool vec,
                                         int g, int c) {
    if constexpr (!kSmemQ) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // rows g, g + 8; columns +0, +8
          const int row = g + 8 * (i & 1);
          const float2 x =
              q_pair(q, row, kk * 16 + 2 * c + 8 * (i >> 1), rows, d, vec);
          uint32_t lo;
          split16x2<T>(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                       qh[kk][i], lo);
          if constexpr (!QX) ql[kk][i] = lo;
        }
      }
    }
  }

  __device__ __forceinline__ void scores(const T* sK, float (&s)[NJ][4],
                                         int col0, int g, int c) const {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t h[4], l[4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kSmemQ) {
          const int off =
              (g + 8 * (i & 1)) * L::QS + kk * 16 + 2 * c + 8 * (i >> 1);
          h[i] = *reinterpret_cast<const uint32_t*>(sq + off);
          if constexpr (!QX)
            l[i] = *reinterpret_cast<const uint32_t*>(
                sq + 16 * kWarps * L::QS + off);
        } else {
          h[i] = qh[kk][i];
          if constexpr (!QX) l[i] = ql[kk][i];
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const T* kr = sK + (col0 + j * 8 + g) * L::KS + kk * 16 + 2 * c;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        if constexpr (!QX) mma16<T>(s[j], l, b0, b1);
        mma16<T>(s[j], h, b0, b1);
      }
    }
  }

  static __device__ __forceinline__ void pv(const T* sV,
                                            const float (&p)[NJ][4],
                                            float (&acc)[D / 8][4],
                                            const float (&alpha)[2],
                                            int col0, int, int, int lane) {
    // lane i addresses row i % 8 of matrix i / 8: matrices (k rows 0-7,
    // 8-15) x (columns 0-7, 8-15) of a 16 x 16 block of v
    const T* vr = sV + (col0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::VS +
                  8 * (lane >> 4);
#pragma unroll
    for (int j0 = 0; j0 < D / 8; j0 += NO) {  // NO output n-tiles at a time
      float o[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        uint32_t ah[4], al[4];
        split16x2<T>(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
        split16x2<T>(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
        split16x2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
        split16x2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int jj = 0; jj < NO / 2; ++jj) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vr + kk * 16 * L::VS + j0 * 8 + jj * 16);
          mma16<T>(o[2 * jj], al, b[0], b[1]);
          mma16<T>(o[2 * jj + 1], al, b[2], b[3]);
          mma16<T>(o[2 * jj], ah, b[0], b[1]);
          mma16<T>(o[2 * jj + 1], ah, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j0 + j][e] = fmaf(acc[j0 + j][e], alpha[e >> 1], o[j][e]);
    }
  }
};

template <int D, int NJ, bool QX>
struct Ops<__nv_bfloat16, D, NJ, QX> : Ops16<__nv_bfloat16, D, NJ, QX> {};
template <int D, int NJ, bool QX>
struct Ops<__half, D, NJ, QX> : Ops16<__half, D, NJ, QX> {};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store_one(float* o, float a) { *o = a; }
__device__ __forceinline__ void store_one(__nv_bfloat16* o, float a) {
  *o = __float2bfloat16_rn(a);
}
__device__ __forceinline__ void store_one(__half* o, float a) {
  *o = __float2half_rn(a);
}
__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* o, float a, float b) {
  *reinterpret_cast<__half2*>(o) = __floats2half2_rn(a, b);
}

// Grid (BH, ceil(S / (64 / P))), kWarps * 32 threads, smem_bytes<T, D>()
// of dynamic shared memory; q, k, v, out (BH, S, d) with d <= D.  Under
// CAUSAL the q tiles run in reverse order, so the heaviest (those with
// the most KV tiles) are dispatched first.  flags: kVec, kPair.
template <typename T, int D, bool CAUSAL, int P, bool QX>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int d,
                 float scale, int flags) {
  using L = Tiles<T, D>;
  constexpr int BK = L::BK, NJ = BK / 8 / P, STAGE = stage_elems<T, D>();
  constexpr int ST = stages<T, D>();
  constexpr int ROWS = 16 * kWarps / P;  // query rows of the block
  static_assert(NJ >= 1, "every warp takes at least one n-tile of a KV tile");
  static_assert((kWarps / P) * (P - 1) * (D / 2 + 4) * 32 * 4 <=
                    smem_bytes<T, D>(),
                "the merge buffer fits the block's shared memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wq = warp / P, wp = warp % P;  // row slice, column slice
  const int col0 = wp * NJ * 8;            // the warp's first tile column
  const int qt = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS, wq0 = q0 + wq * 16;
  const bool vec = flags & kVec;
  const long long base = static_cast<long long>(blockIdx.x) * S * d;
  const T* kb = k + base;
  const T* vb = v + base;
  // KV tiles of the block, and of this warp (the block's later tiles lie
  // above the warp's diagonal: p = 0 and alpha = 1 there, so skipping
  // them changes nothing; a warp whose rows all lie past S computes none)
  const int last = min(q0 + ROWS, S) - 1;  // the block's last real row
  const int n_kt = CAUSAL ? last / BK + 1 : (S + BK - 1) / BK;
  const int w_kt = wq0 >= S ? 0
                   : CAUSAL ? min(wq0 + 15, S - 1) / BK + 1
                            : n_kt;

  // tiles 0 .. ST - 2 in flight, one commit group each
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_kt) {
      const long long off = static_cast<long long>(t) * BK * d;
      const int rows = min(BK, S - t * BK);
      stage_tile<T, D, BK, L::KS>(smem + t * STAGE, kb + off, rows, d, vec);
      stage_tile<T, D, BK, L::VS>(smem + t * STAGE + BK * L::KS, vb + off,
                                  rows, d, vec);
    }
    cp_async_commit();
  }

  Ops<T, D, NJ, QX> ops;
  if constexpr (q_in_smem<D>()) {
    // ordered before the first tile's products by the loop's barrier
    stage_q<D, QX>(smem + ST * STAGE,
                   q + base + static_cast<long long>(q0) * d, S - q0, ROWS,
                   d, scale);
    ops.sq = smem + ST * STAGE + wq * 16 * L::QS;
  }
  ops.load_q(q + base + static_cast<long long>(wq0) * d, S - wq0, d, scale,
             vec, g, c);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_kt; ++t) {
    const T* sK = smem + (t % ST) * STAGE;
    const T* sV = sK + BK * L::KS;
    const bool live = t < w_kt;
    const int tn = t + ST - 1;  // the tile staged during this one
    T* nK = smem + (tn % ST) * STAGE;

    cp_async_wait<ST - 2>();  // tile t has landed (later ones may not)
    __syncthreads();  // ... for every thread, and tile t - 1 is done with,
    if (tn < n_kt) {  // so its stage takes tile tn
      const long long nxt = static_cast<long long>(tn) * BK * d;
      const int rows = min(BK, S - tn * BK);
      stage_tile<T, D, BK, L::KS>(nK, kb + nxt, rows, d, vec);
      stage_tile<T, D, BK, L::VS>(nK + BK * L::KS, vb + nxt, rows, d, vec);
    }
    cp_async_commit();

    if (live) {
      float s[NJ][4];
      ops.scores(sK, s, col0, g, c);
      const int k0 = t * BK + col0;
      if ((CAUSAL && k0 + NJ * 8 - 1 > wq0) || k0 + NJ * 8 > S) {
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
      // l stays a per-thread partial sum until the end (alpha is the same
      // for the 4 lanes of a row)
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
      Ops<T, D, NJ, QX>::pv(sV, s, acc, alpha, col0, g, c, lane);
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
    __syncthreads();  // every warp is done with the tiles and q
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

  // rows past S and columns past d are not stored; pairs where d is even
  T* o = out + base + static_cast<long long>(wq0) * d;
  const bool pair = flags & kPair;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (wq0 + row >= S) continue;
    const float den = fmaxf(l[h], 1e-20f);
    T* orow = o + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * c;
      if (col >= d) continue;
      const float a = __fdiv_rn(acc[j][2 * h], den);
      const float b = __fdiv_rn(acc[j][2 * h + 1], den);
      if (pair) {
        store_pair(orow + col, a, b);
      } else {
        store_one(orow + col, a);
        if (col + 1 < d) store_one(orow + col + 1, b);
      }
    }
  }
}

}  // namespace fa
}  // namespace repro
