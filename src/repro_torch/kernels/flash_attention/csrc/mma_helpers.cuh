// Tensor-core and async-copy primitives shared by the flash-attention
// kernel (flash_mma.cuh) and the megakernels (megastep_body.cuh).
//
// namespace repro: cp_async16 (untyped pointers, so bfloat16 tiles use it
// too) and its zero-filling twin, the commit / wait pair, to_tf32 and
// mma_tf32, the one copy that both kernels include (CPU twin of the TF32
// rounding: megastep/ref.py ``tf32_round`` / ``tf32x3_matmul``).  namespace repro::fa: the flash
// kernel's own split_tf32_fast (the remainder left unrounded) and its
// bfloat16 and float16 mma, ldmatrix and split helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

namespace repro {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}

// 16 bytes, of which the first ``bytes`` (0 or 16) are read from src and
// the rest zero-filled: one branch-free copy for a padded or ragged tile.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, keep the top
// 19 bits) as two integer ops: the same bits for every finite x, at the
// full ALU rate (the cvt goes through the slower conversion pipe).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

namespace fa {

// x = big + small with big = rna(x) and small = x - big left as float32:
// the tensor core reads the top 19 bits of a TF32 operand, so small is
// truncated to TF32 where it is used (as CUTLASS's fast 3xTF32 does).
// megastep_body.cuh's split_tf32 rounds small with to_tf32 too; two
// integer ops more per operand, a difference below 2^-21 of x.
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& big,
                                                uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// d += a b, bfloat16 operands, float32 accumulators (m16n8k16).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, float16 operands, float32 accumulators (m16n8k16).
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8 x 8 16-bit (bfloat16 or float16) matrices from
// shared memory; lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// x = hi + lo in bfloat16 (hi = rn(x), lo = rn(x - hi)) for a pair of
// float32 values, each packed as one bfloat16x2 register (x0 in the low
// half); one paired conversion per register.
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(x0, __low2float(h)), __fsub_rn(x1, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The same split in float16 (hi = rn(x), lo = rn(x - hi)): 22 significant
// bits, but lo is subnormal where |x| < 2^-3 (and hi where |x| < 2^-14),
// which keeps the error of the pair under 2^-25 absolute there.
__device__ __forceinline__ void split_f16x2(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const __half2 l = __floats2half2_rn(__fsub_rn(x0, __low2float(h)),
                                      __fsub_rn(x1, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace fa
}  // namespace repro
