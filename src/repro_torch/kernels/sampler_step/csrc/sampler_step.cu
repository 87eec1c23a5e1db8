// Fused DDIM sampler step (paper Eq. 12) for Hopper (sm_90a), plain-C ABI.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/sampler_step/
// kernel.py:
//   step_kernel      <- sampler_step_2d       (_det_kernel / _stoch_kernel,
//                       _update, _tile_noise, sw_random_bits)
//   step_rows_kernel <- sampler_step_rows_2d  (_row_det_kernel /
//                       _row_stoch_kernel, _row_update, sw_random_bits_rows)
//
// x and eps are float32, bfloat16 or float16, each loaded with its own type
// and widened (JAX's astype), the output stored in x's type.  Per element,
// all math in float32:
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
// Design.  At the main path's sizes (R = 96 or 128 rows, under 0.5 MB) the
// bytes take ~0.1 us and a launch ~1 us: the time is the fixed cost of one
// launch plus one round trip to memory, and the kernel keeps to that.
//  * Deterministic steps: one thread per 4 consecutive elements of the
//    (R, 256) tile layout, loaded and stored as one vector (16 bytes for
//    float32, 8 for bfloat16 or float16), in 256-thread blocks.
//  * Stochastic steps: one thread per element (96 blocks of 256 at R = 96),
//    so that each thread's dependent chain (2 fmix32 draws, the accurate
//    logf / cosf / sqrtf) is one normal long instead of four; the noise is
//    drawn while the loads are in flight.
// The arithmetic, and its order, are the same either way: both are bitwise
// equal to the plain version.  Measured slower on an H100 (PERF.md) and
// not used: 64-thread blocks, and programmatic dependent launch, whose grid
// still waits for the PyTorch op ahead of it on the main path.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sampler_step/csrc/step_update.cuh"

namespace {

using repro::Coefs;
using repro::update;

constexpr int kTileC = 256;
constexpr int kCoefCols = 8;
constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kTidMul = 0x632BE59Bu;
constexpr uint32_t kSalt1 = 0x85157AF5u;  // (1 * 0x85157AF5) mod 2^32
constexpr uint32_t kSalt2 = 0x0A2AF5EAu;  // (2 * 0x85157AF5) mod 2^32
constexpr float kInv2p24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = 6.283185307179586f;         // float32(2 pi)

// ------------------------------------------------------------ vector I/O
// Elements per thread: 4 (one vector) for deterministic steps, 1 for
// stochastic ones.
__host__ __device__ constexpr int elems_per_thread(bool stochastic) {
  return stochastic ? 1 : 4;
}

// V = 4: one 16-byte (float32) or 8-byte (bfloat16, float16) vector; V =
// 1: one element.  The 16-bit roundings are the same either way.
template <int V>
__device__ __forceinline__ void load_v(const float* p, float v[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float v[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
    const __nv_bfloat162 a = p2[0], b = p2[1];
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void load_v(const __half* p, float v[V]) {
  if constexpr (V == 4) {
    const __half2* p2 = reinterpret_cast<const __half2*>(p);
    const __half2 a = p2[0], b = p2[1];
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
    v[0] = __half2float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float v[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float v[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
    p2[0] = __floats2bfloat162_rn(v[0], v[1]);
    p2[1] = __floats2bfloat162_rn(v[2], v[3]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// float16 overflows to inf at the store, as JAX's astype does: no clamp.
template <int V>
__device__ __forceinline__ void store_v(__half* p, const float v[V]) {
  if constexpr (V == 4) {
    __half2* p2 = reinterpret_cast<__half2*>(p);
    p2[0] = __floats2half2_rn(v[0], v[1]);
    p2[1] = __floats2half2_rn(v[2], v[3]);
  } else {
    *p = __float2half_rn(v[0]);
  }
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
  constexpr int V = elems_per_thread(STOCH);
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const int base = v * V;
  float xs[V], es[V], os[V], x0;
  load_v<V>(x + base, xs);
  load_v<V>(eps + base, es);
#pragma unroll
  for (int k = 0; k < V; ++k)
    os[k] = update<CLIP, false>(xs[k], es[k], c, clip, &x0);
  if constexpr (STOCH) {
    // drawn while the loads are in flight (the noise reads no memory)
    const int row = base / kTileC;
    const int col = base % kTileC;
    const uint32_t tid = static_cast<uint32_t>(row / tile_rows);
    const uint32_t mixed = seed ^ (tid * kTidMul);
    const uint32_t key1 = fmix32(mixed ^ kSalt1);
    const uint32_t key2 = fmix32(mixed ^ kSalt2);
    const uint32_t ctr0 = static_cast<uint32_t>((row % tile_rows) * kTileC + col);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float z = bits_to_normal(stream_bits(ctr0 + k, key1),
                                     stream_bits(ctr0 + k, key2));
      os[k] = __fmaf_rn(c.c_noise, z, os[k]);
    }
  }
  store_v<V>(out + base, os);
}

// Per-row coefficients and seeds: one launch advances rows at different
// trajectory positions (the continuous-batching tick).
template <typename T, typename E, bool CLIP, bool STOCH, bool WANT_X0>
__global__ void __launch_bounds__(kThreads)
step_rows_kernel(const T* __restrict__ x, const E* __restrict__ eps,
                 const float* __restrict__ row_coefs,
                 const int32_t* __restrict__ row_seeds, T* __restrict__ out,
                 T* __restrict__ x0_out, int n_vec, float clip) {
  constexpr int V = elems_per_thread(STOCH);
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const int base = v * V;
  const int row = base / kTileC;
  const float* rc = row_coefs + row * kCoefCols;
  const Coefs c{rc[0], rc[1], rc[2], rc[3], rc[4]};
  float xs[V], es[V], os[V], x0s[V];
  load_v<V>(x + base, xs);
  load_v<V>(eps + base, es);
#pragma unroll
  for (int k = 0; k < V; ++k)
    os[k] = update<CLIP, WANT_X0>(xs[k], es[k], c, clip, &x0s[k]);
  if constexpr (STOCH) {
    const uint32_t s = static_cast<uint32_t>(row_seeds[row]);
    const uint32_t key1 = fmix32(s ^ kSalt1);
    const uint32_t key2 = fmix32(s ^ kSalt2);
    const uint32_t ctr0 = static_cast<uint32_t>(base % kTileC);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float z = bits_to_normal(stream_bits(ctr0 + k, key1),
                                     stream_bits(ctr0 + k, key2));
      os[k] = __fmaf_rn(c.c_noise, z, os[k]);
    }
  }
  store_v<V>(out + base, os);
  if constexpr (WANT_X0) store_v<V>(x0_out + base, x0s);
}

// The yardstick of the fixed cost per launch (no TPU counterpart).
__global__ void empty_kernel() {}

// ------------------------------------------------------------- dispatch
// Blocks of kThreads that one step over n elements launches.
int blocks_for(int n, bool stochastic) {
  const int n_threads = n / elems_per_thread(stochastic);
  return (n_threads + kThreads - 1) / kThreads;
}

template <typename F>
void with_bool(bool b, F f) {
  if (b) f(std::true_type{}); else f(std::false_type{});
}

template <typename T>
struct Tag {
  using type = T;
};

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16
template <typename F>
bool with_dtype(int code, F f) {
  if (code == 0) f(Tag<float>{});
  else if (code == 1) f(Tag<__nv_bfloat16>{});
  else if (code == 2) f(Tag<__half>{});
  else return false;
  return true;
}

// f(tx, te) for x's and eps's types, each loaded with its own type (JAX's
// astype of each input); cudaErrorInvalidValue for an unknown code.
template <typename F>
int with_dtypes(int x_dtype, int eps_dtype, F f) {
  if (eps_dtype < 0 || eps_dtype > 2 ||
      !with_dtype(x_dtype, [&](auto tx) {
        with_dtype(eps_dtype, [&](auto te) { f(tx, te); });
      }))
    return static_cast<int>(cudaErrorInvalidValue);
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
  const int blocks = blocks_for(R * kTileC, stochastic != 0);
  const Coefs c{c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = with_dtypes(x_dtype, eps_dtype, [&](auto tx, auto te) {
    using T = typename decltype(tx)::type;
    using E = typename decltype(te)::type;
    with_bool(has_clip != 0, [&](auto clip_c) {
      with_bool(stochastic != 0, [&](auto stoch_c) {
        constexpr bool STOCH = decltype(stoch_c)::value;
        step_kernel<T, E, decltype(clip_c)::value, STOCH>
            <<<blocks, kThreads, 0, s>>>(
                static_cast<const T*>(x), static_cast<const E*>(eps),
                static_cast<T*>(out), R * kTileC / elems_per_thread(STOCH),
                tile_rows, c, clip, static_cast<uint32_t>(seed));
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
  const int blocks = blocks_for(R * kTileC, stochastic != 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = with_dtypes(x_dtype, eps_dtype, [&](auto tx, auto te) {
    using T = typename decltype(tx)::type;
    using E = typename decltype(te)::type;
    with_bool(has_clip != 0, [&](auto clip_c) {
      with_bool(stochastic != 0, [&](auto stoch_c) {
        with_bool(want_x0 != 0, [&](auto x0_c) {
          constexpr bool STOCH = decltype(stoch_c)::value;
          step_rows_kernel<T, E, decltype(clip_c)::value, STOCH,
                           decltype(x0_c)::value>
              <<<blocks, kThreads, 0, s>>>(
                  static_cast<const T*>(x), static_cast<const E*>(eps),
                  static_cast<const float*>(row_coefs),
                  static_cast<const int32_t*>(row_seeds),
                  static_cast<T*>(out), static_cast<T*>(x0_out),
                  R * kTileC / elems_per_thread(STOCH), clip);
        });
      });
    });
  });
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel over ``blocks`` blocks of kThreads, launched as the step
// kernels are: the fixed cost per launch that they are measured against.
int repro_empty_kernel(int blocks, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
