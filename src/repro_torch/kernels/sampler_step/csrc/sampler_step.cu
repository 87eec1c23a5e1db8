// Fused DDIM sampler step (paper Eq. 12) for Hopper (sm_90a), plain-C ABI.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/sampler_step/
// kernel.py:
//   step_kernel      <- sampler_step_2d       (_det_kernel / _stoch_kernel,
//                       _update, _tile_noise, sw_random_bits)
//   step_rows_kernel <- sampler_step_rows_2d  (_row_det_kernel /
//                       _row_stoch_kernel, _row_update, sw_random_bits_rows)
//
// Per element, all math in float32:
//   x0  = (x - sqrt(1-a_t) eps) / sqrt(a_t)       [clip / want_x0]
//   x0  = clip(x0, +-clip); eps = (x - sqrt(a_t) x0) / sqrt(1-a_t)  [clip]
//   out = c_x0 x0 + c_dir eps + c_noise z           (no clip: a x + b eps)
// The multiply-adds are written as the explicit __fmaf_rn / __fmul_rn /
// __fadd_rn / __fdiv_rn that XLA:CPU's contraction of the reference gives
// (see ref.py), so nvcc's default -fmad=true cannot contract differently.
// The deterministic part (``update``) is in step_update.cuh, which the
// megastep kernel includes too.  Build without --use_fast_math: logf / cosf / sqrtf must be the accurate
// ones.  The deterministic specializations contain no PRNG code.
//
// Noise: the reference's software stream, bit for bit — murmur3 fmix32
// over a counter keyed on (seed, row-tile id) [scalar kernel] or on the
// row seed [per-row kernel], two draws per element, Box-Muller.  The TPU
// hardware-PRNG branch has no counterpart here.
//
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s): the step is an elementwise
// pass, memory-bound.  Bytes moved = (2 reads + 1 write, +1 write for the
// x0 preview) x N elements x dtype size (+ R x 36 bytes of row coefficients
// and seeds for the per-row kernel), over 3.35 TB/s.  Even the stochastic
// path's operations per element (counted in chip_smoke.py, OPS_STEP +
// OPS_NOISE) stay below the bytes bound at 67 TFLOP/s.
//
// Design (the simple one): one thread per 4 consecutive elements of the
// (R, 256) tile layout, loaded and stored as one vector (16 bytes for
// float32, 8 for bfloat16); one launch per step on the caller's stream.
// No shared memory, no persistence: making it faster (fusing with the
// eps model's last layer, CUDA graphs over the step loop) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sampler_step/csrc/step_update.cuh"

namespace {

using repro::Coefs;
using repro::update;

constexpr int kTileC = 256;
constexpr int kCoefCols = 8;
constexpr int kVec = 4;
constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kTidMul = 0x632BE59Bu;
constexpr uint32_t kSalt1 = 0x85157AF5u;  // (1 * 0x85157AF5) mod 2^32
constexpr uint32_t kSalt2 = 0x0A2AF5EAu;  // (2 * 0x85157AF5) mod 2^32
constexpr float kInv2p24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = 6.283185307179586f;         // float32(2 pi)

// ------------------------------------------------------------ vector I/O
__device__ __forceinline__ void load4(const float* p, float v[kVec]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[kVec]) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 a = p2[0], b = p2[1];
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* p, const float v[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[kVec]) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v[0], v[1]);
  p2[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// ------------------------------------------------------------------ PRNG
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t stream_bits(uint32_t ctr, uint32_t key) {
  return fmix32((ctr ^ key) * kGolden + key);
}

__device__ __forceinline__ float bits_to_normal(uint32_t b1, uint32_t b2) {
  const float u1 = __fmul_rn(__fadd_rn(static_cast<float>(b1 >> 8), 0.5f),
                             kInv2p24);
  const float u2 = __fmul_rn(static_cast<float>(b2 >> 8), kInv2p24);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(kTwoPi, u2)));
}

// Scalar coefficients: every row at the same trajectory position.
template <typename T, typename E, bool CLIP, bool STOCH>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* __restrict__ x, const E* __restrict__ eps,
            T* __restrict__ out, int n_vec, int tile_rows, Coefs c,
            float clip, uint32_t seed) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const int base = v * kVec;
  float xs[kVec], es[kVec], os[kVec], x0;
  load4(x + base, xs);
  load4(eps + base, es);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    os[k] = update<CLIP, false>(xs[k], es[k], c, clip, &x0);
  if constexpr (STOCH) {
    const int row = base / kTileC;
    const int col = base % kTileC;
    const uint32_t tid = static_cast<uint32_t>(row / tile_rows);
    const uint32_t mixed = seed ^ (tid * kTidMul);
    const uint32_t key1 = fmix32(mixed ^ kSalt1);
    const uint32_t key2 = fmix32(mixed ^ kSalt2);
    const uint32_t ctr0 = static_cast<uint32_t>((row % tile_rows) * kTileC + col);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float z = bits_to_normal(stream_bits(ctr0 + k, key1),
                                     stream_bits(ctr0 + k, key2));
      os[k] = __fmaf_rn(c.c_noise, z, os[k]);
    }
  }
  store4(out + base, os);
}

// Per-row coefficients and seeds: one launch advances rows at different
// trajectory positions (the continuous-batching tick).
template <typename T, typename E, bool CLIP, bool STOCH, bool WANT_X0>
__global__ void __launch_bounds__(kThreads)
step_rows_kernel(const T* __restrict__ x, const E* __restrict__ eps,
                 const float* __restrict__ row_coefs,
                 const int32_t* __restrict__ row_seeds, T* __restrict__ out,
                 T* __restrict__ x0_out, int n_vec, float clip) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const int base = v * kVec;
  const int row = base / kTileC;
  const float* rc = row_coefs + row * kCoefCols;
  const Coefs c{rc[0], rc[1], rc[2], rc[3], rc[4]};
  float xs[kVec], es[kVec], os[kVec], x0s[kVec];
  load4(x + base, xs);
  load4(eps + base, es);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    os[k] = update<CLIP, WANT_X0>(xs[k], es[k], c, clip, &x0s[k]);
  if constexpr (STOCH) {
    const uint32_t s = static_cast<uint32_t>(row_seeds[row]);
    const uint32_t key1 = fmix32(s ^ kSalt1);
    const uint32_t key2 = fmix32(s ^ kSalt2);
    const uint32_t ctr0 = static_cast<uint32_t>(base % kTileC);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float z = bits_to_normal(stream_bits(ctr0 + k, key1),
                                     stream_bits(ctr0 + k, key2));
      os[k] = __fmaf_rn(c.c_noise, z, os[k]);
    }
  }
  store4(out + base, os);
  if constexpr (WANT_X0) store4(x0_out + base, x0s);
}

// ------------------------------------------------------------- dispatch
template <typename F>
void with_bool(bool b, F f) {
  if (b) f(std::true_type{}); else f(std::false_type{});
}

template <typename T>
struct Tag {
  using type = T;
};

template <typename F>
int with_dtypes(int x_dtype, int eps_dtype, F f) {
  // dtype codes: 0 = float32, 1 = bfloat16
  using F32 = Tag<float>;
  using BF16 = Tag<__nv_bfloat16>;
  if (x_dtype == 0 && eps_dtype == 0) f(F32{}, F32{});
  else if (x_dtype == 0 && eps_dtype == 1) f(F32{}, BF16{});
  else if (x_dtype == 1 && eps_dtype == 0) f(BF16{}, F32{});
  else if (x_dtype == 1 && eps_dtype == 1) f(BF16{}, BF16{});
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// x, eps, out: (R, 256) contiguous, 16-byte aligned.  Returns the
// cudaError_t of the launch (0 on success).
int repro_sampler_step_2d(const void* x, const void* eps, void* out,
                          int x_dtype, int eps_dtype, int R, int tile_rows,
                          float c_x0, float c_dir, float c_noise,
                          float sqrt_a_t, float sqrt_1m_a_t, int has_clip,
                          float clip, int stochastic, int seed,
                          void* stream) {
  const int n_vec = R * kTileC / kVec;
  const int blocks = (n_vec + kThreads - 1) / kThreads;
  const Coefs c{c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = with_dtypes(x_dtype, eps_dtype, [&](auto tx, auto te) {
    using T = typename decltype(tx)::type;
    using E = typename decltype(te)::type;
    with_bool(has_clip != 0, [&](auto clip_c) {
      with_bool(stochastic != 0, [&](auto stoch_c) {
        step_kernel<T, E, decltype(clip_c)::value, decltype(stoch_c)::value>
            <<<blocks, kThreads, 0, s>>>(
                static_cast<const T*>(x), static_cast<const E*>(eps),
                static_cast<T*>(out), n_vec, tile_rows, c, clip,
                static_cast<uint32_t>(seed));
      });
    });
  });
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// x, eps, out, x0_out: (R, 256); row_coefs: (R, 8) float32; row_seeds:
// (R,) int32 (may be null when !stochastic); x0_out null when !want_x0.
int repro_sampler_step_rows_2d(const void* x, const void* eps,
                               const void* row_coefs, const void* row_seeds,
                               void* out, void* x0_out, int x_dtype,
                               int eps_dtype, int R, int has_clip, float clip,
                               int stochastic, int want_x0, void* stream) {
  const int n_vec = R * kTileC / kVec;
  const int blocks = (n_vec + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = with_dtypes(x_dtype, eps_dtype, [&](auto tx, auto te) {
    using T = typename decltype(tx)::type;
    using E = typename decltype(te)::type;
    with_bool(has_clip != 0, [&](auto clip_c) {
      with_bool(stochastic != 0, [&](auto stoch_c) {
        with_bool(want_x0 != 0, [&](auto x0_c) {
          step_rows_kernel<T, E, decltype(clip_c)::value,
                           decltype(stoch_c)::value, decltype(x0_c)::value>
              <<<blocks, kThreads, 0, s>>>(
                  static_cast<const T*>(x), static_cast<const E*>(eps),
                  static_cast<const float*>(row_coefs),
                  static_cast<const int32_t*>(row_seeds),
                  static_cast<T*>(out), static_cast<T*>(x0_out), n_vec, clip);
        });
      });
    });
  });
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
