// One-pass row RMSNorm (the body of rmsnorm.cu's kernel).
//
// A row is read once: each of its threads loads up to 8 (or 32) chunks
// (a 16-byte vector of 4 float32 or 8 bfloat16 or float16 on the vector
// path, one element on the scalar path) into registers, all loads issued
// before the first is used, and the row's scale beside them.  The float32 sum
// of squares runs as four independent partial sums per thread, then a
// warp shuffle (and, for rows longer than a warp holds, one partial per
// warp through shared memory, summed in warp order).  The inverse RMS
// comes from rms_inv_from_sumsq (rmsnorm_body.cuh), so the op order is
// that of the TPU kernel: T(rsqrt(ms + eps)), then T(T(x inv) scale),
// computed from the registers and stored as whole chunks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

#include "rmsnorm/csrc/rmsnorm_body.cuh"

namespace repro {
namespace rn {

constexpr int kRowsPerBlock = 2;  // rows of a block when a warp holds a row
constexpr int kMaxThreads = 256;  // so a row of 8 warps, at most
constexpr int kLongThreads = 1024;  // a row of the long-row kernel

// Chunks of its row one thread holds: 8 vectors (32 registers), or 32
// single elements.
template <bool VEC>
__host__ __device__ constexpr int chunks_per_thread() {
  return VEC ? 8 : 32;
}

template <typename T, bool VEC>
struct Chunk;

template <>
struct Chunk<float, true> {
  using Raw = float4;
  static constexpr int N = 4;
  Raw v;
  __device__ __forceinline__ float get(int e) const { return (&v.x)[e]; }
  __device__ __forceinline__ void set(int e, float f) { (&v.x)[e] = f; }
};

template <>
struct Chunk<__nv_bfloat16, true> {
  using Raw = uint4;
  static constexpr int N = 8;
  Raw v;
  __device__ __forceinline__ float get(int e) const {
    const uint32_t w = (&v.x)[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
  __device__ __forceinline__ void set(int e, float f) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(f));
    uint32_t& w = (&v.x)[e >> 1];
    w = (e & 1) ? ((w & 0xFFFFu) | (b << 16)) : ((w & 0xFFFF0000u) | b);
  }
};

template <>
struct Chunk<__half, true> {
  using Raw = uint4;
  static constexpr int N = 8;
  Raw v;
  __device__ __forceinline__ float get(int e) const {
    const uint32_t w = (&v.x)[e >> 1];
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((e & 1) ? w >> 16 : w & 0xFFFFu)));
  }
  __device__ __forceinline__ void set(int e, float f) {
    const uint32_t b = __half_as_ushort(__float2half_rn(f));
    uint32_t& w = (&v.x)[e >> 1];
    w = (e & 1) ? ((w & 0xFFFFu) | (b << 16)) : ((w & 0xFFFF0000u) | b);
  }
};

template <typename T>
struct Chunk<T, false> {
  using Raw = T;
  static constexpr int N = 1;
  Raw v;
  __device__ __forceinline__ float get(int) const { return to_f32(v); }
  __device__ __forceinline__ void set(int, float f) { v = from_f32<T>(f); }
};

// Block: kRowsPerBlock rows of one warp each (wpr == 1), or one row of
// wpr warps; dynamic shared memory of one float per warp when wpr > 1.
// Each row has nc = d / N chunks; a thread takes chunks t, t + 32 wpr, ...
// (neighbouring lanes on neighbouring 16-byte chunks).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     T* __restrict__ out, int R, int d, float eps, int wpr) {
  using C = Chunk<T, VEC>;
  using Raw = typename C::Raw;
  extern __shared__ float s_part[];
  const int tpr = 32 * wpr;
  const int rib = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + rib;
  const bool live = row < R;
  const int nc = d / C::N;
  const long long off = static_cast<long long>(row) * d;
  const Raw* xr = reinterpret_cast<const Raw*>(x + off);
  const Raw* sr = reinterpret_cast<const Raw*>(scale);
  Raw* orow = reinterpret_cast<Raw*>(out + off);

  constexpr int kChunks = chunks_per_thread<VEC>();
  C xv[kChunks], sv[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ci = i * tpr + t;
    if (live && ci < nc) {
      xv[i].v = xr[ci];
      sv[i].v = sr[ci];
    }
  }
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (live && i * tpr + t < nc) {
#pragma unroll
      for (int e = 0; e < C::N; ++e) {
        const float f = xv[i].get(e);
        float& p = part[(i * C::N + e) & 3];
        p = __fadd_rn(p, __fmul_rn(f, f));
      }
    }
  }
  float ss =
      __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if (wpr > 1) {  // the block is one row: every thread is live
    if ((t & 31) == 0) s_part[t >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int w = 0; w < wpr; ++w) ss = __fadd_rn(ss, s_part[w]);
  }
  const float inv = rms_inv_from_sumsq<T>(ss, d, eps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ci = i * tpr + t;
    if (live && ci < nc) {
      C o{};
#pragma unroll
      for (int e = 0; e < C::N; ++e) {
        const float xi =
            to_f32(from_f32<T>(__fmul_rn(xv[i].get(e), inv)));
        o.set(e, __fmul_rn(xi, sv[i].get(e)));
      }
      orow[ci] = o.v;
    }
  }
}

// Rows longer than 8 warps' registers hold (d > 8,192 float32, 16,384
// bfloat16 or float16 on the vector path, d > 8,192 on the scalar one):
// one block of kLongThreads per row, the grid striding over the rows.  A
// row is read twice: its sum of squares first, four chunks a thread in
// flight (64 KB a block on the vector path, enough to keep HBM busy with
// one row per SM) and four independent partial sums a thread (then a warp
// shuffle and the warps' partials in warp order through shared memory),
// then again, from L2 where it still is, to scale and store.  The
// launcher keeps the rows in flight within kL2RowBytes.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kLongThreads)
rms_norm_long_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     T* __restrict__ out, int R, int d, float eps) {
  using C = Chunk<T, VEC>;
  using Raw = typename C::Raw;
  constexpr int kW = kLongThreads / 32;
  __shared__ float s_part[kW];
  const int t = threadIdx.x, nc = d / C::N;
  const Raw* sr = reinterpret_cast<const Raw*>(scale);
  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const long long off = static_cast<long long>(row) * d;
    const Raw* xr = reinterpret_cast<const Raw*>(x + off);
    Raw* orow = reinterpret_cast<Raw*>(out + off);
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int ci = t;
    for (; ci + 3 * kLongThreads < nc; ci += 4 * kLongThreads) {
      C v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u].v = xr[ci + u * kLongThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < C::N; ++e) {
          const float f = v[u].get(e);
          float& p = part[(u * C::N + e) & 3];
          p = __fadd_rn(p, __fmul_rn(f, f));
        }
    }
    for (; ci < nc; ci += kLongThreads) {
      C v;
      v.v = xr[ci];
#pragma unroll
      for (int e = 0; e < C::N; ++e) {
        const float f = v.get(e);
        part[e & 3] = __fadd_rn(part[e & 3], __fmul_rn(f, f));
      }
    }
    float ss =
        __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    if ((t & 31) == 0) s_part[t >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int w = 0; w < kW; ++w) ss = __fadd_rn(ss, s_part[w]);
    const float inv = rms_inv_from_sumsq<T>(ss, d, eps);
    for (ci = t; ci < nc; ci += kLongThreads) {
      C xv, sv, o{};
      xv.v = xr[ci];
      sv.v = sr[ci];
#pragma unroll
      for (int e = 0; e < C::N; ++e) {
        const float xi = to_f32(from_f32<T>(__fmul_rn(xv.get(e), inv)));
        o.set(e, __fmul_rn(xi, sv.get(e)));
      }
      orow[ci] = o.v;
    }
    __syncthreads();  // s_part is rewritten for the next row
  }
}

}  // namespace rn
}  // namespace repro
