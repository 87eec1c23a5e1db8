// The sampler megakernels for Hopper (sm_90a), plain-C ABI: K consecutive
// plan steps, each the whole dense diffusion-LM eps trunk followed by the
// Eq. 12 update, in ONE launch (repro_megastep); or one continuous-batching
// scheduler tick, the trunk with a timestep per slot followed by the
// per-row update (repro_megastep_rows).  Both are one kernel template.
//
// Replaces the Pallas TPU kernels ``megastep_call`` (B3) and
// ``megastep_rows_call`` (B4) of src/repro/kernels/megastep/kernel.py:232
// and :269 (bodies ``_mega_kernel`` / ``_mega_rows_kernel``, ``eps_exact``
// / ``eps_flash``).  Per step and sample (all float32):
//   temb = silu(sinusoid(t) @ time_w1) @ time_w2
//   h    = x @ w_in + temb
//   n_layers x [ xn = rmsnorm(h); q, k, v = xn @ wq, wk, wv; rope(q, k);
//                h += attention(q, k, v) @ wo;
//                xn = rmsnorm(h); h += (silu(xn @ w_gate) * (xn @ w_up)) @ w_down ]
//   eps  = rmsnorm(h) @ w_out;   x = update(x, eps, coefs[k])
// The sinusoid (cos / sin of t * freq) and the RoPE cos / sin table are
// computed by the wrapper with the plain functions and passed in, as the
// TPU kernel takes them as hoisted constants (kernel.py:188-229).
// attention is 'exact' (q k^T / sqrt(D), softmax, then p v — models/
// attention._grouped_attention) or 'flash' (q pre-scaled, the shared
// online_softmax_step body over KV blocks of 64, acc / max(l, 1e-20) —
// kernel.py:83-130).  The norms are the shared rmsnorm body, the update the
// shared step body (step_update.cuh).  There is no PRNG code: mega plans are
// deterministic.
//
// Bound on the H100: operations.  One step at smollm width (d 576, 9 / 3
// heads of 64, d_ff 1536, 2 layers), batch 4, 64 tokens is ~3.7 GFLOP
// (2 x 256 tokens x 7.11 M eps-path weights, plus attention), so an
// 8-step launch is ~30 GFLOP, ~0.44 ms at 67 TFLOP/s float32; reading the
// 29.3 MB of weights once takes ~9 us at 3.35 TB/s.  A scheduler tick is
// one such step, ~56 us at 67 TFLOP/s.
//
// Design (the simple one): one block of 256 threads per sample.  Every op
// of the trunk is per sample (lockstep t, per-token products, attention
// inside the sequence), and sample b's latent is rows [b S L / 256,
// (b+1) S L / 256) of the tile view, so no block waits for another and the
// K-step loop runs inside the block.  The state (S x L) and eps live in
// shared memory for the whole launch: read once, written once.  The
// activations (about 1 MB per sample at smollm width) do not fit in shared
// memory; they live in a workspace the wrapper allocates and stay in L2.
// Products are shared-memory-tiled FFMA (64 x 64 output tiles, 4 x 4 per
// thread, depth 32): float32 as the reference, no TF32.  At batch 4 this
// fills 4 of 132 SMs; splitting a sample over a cluster or the grid, and
// tensor cores, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention/csrc/online_softmax.cuh"
#include "rmsnorm/csrc/rmsnorm_body.cuh"
#include "sampler_step/csrc/step_update.cuh"

// Device pointers of the eps-path weights (stacked (n_layers, ...) leaves,
// (in, out) layouts as the JAX pytree) and the trunk's widths.  The layout
// is mirrored by ctypes in ../kernel.py.
struct ReproMegaWeights {
  const float* w_in;       // (L, d)
  const float* time_w1;    // (T, T)
  const float* time_w2;    // (T, d)
  const float* out_norm;   // (d,)
  const float* w_out;      // (d, L)
  const float* attn_norm;  // (n, d)
  const float* mlp_norm;   // (n, d)
  const float* wq;         // (n, d, H*64)
  const float* wk;         // (n, d, Hkv*64)
  const float* wv;         // (n, d, Hkv*64)
  const float* wo;         // (n, H*64, d)
  const float* w_gate;     // (n, d, d_ff)
  const float* w_up;       // (n, d, d_ff)
  const float* w_down;     // (n, d_ff, d)
  int n_layers, d_model, n_heads, n_kv_heads, d_ff, time_dim, latent;
  float norm_eps;
};

namespace {

using repro::kAttnThreads;

constexpr int kThreads = kAttnThreads;  // 256
constexpr int kSeq = 64;                // tokens per sample: M of every product
constexpr int kHD = 64;                 // head dim
constexpr int kTK = 32;                 // depth of a product tile
constexpr int kTN = 64;                 // width of a product tile
constexpr int kAS = kSeq + 4;           // row stride of the k-major A tile
constexpr int kTileC = 256;             // width of the tile view
constexpr int kRowCoefs = 8;            // columns of a per-row coefficient row
constexpr int kMatmulFloats = kTK * kAS + kTK * kTN;
constexpr int kAttnFloats =
    3 * kSeq * (kHD + 1) + kSeq * kHD;  // sQ, sK, sP (+1 pads) and sV
constexpr int kUnionFloats =
    kMatmulFloats > kAttnFloats ? kMatmulFloats : kAttnFloats;

struct Workspace {
  float *h, *xn, *q, *k, *v, *ao, *ff, *th, *tv;
};

__host__ __device__ inline long long workspace_floats(
    const ReproMegaWeights& w) {
  const long long d = w.d_model, hq = w.n_heads * kHD,
                  hkv = w.n_kv_heads * kHD;
  return kSeq * (2 * d + 2 * hq + 2 * hkv + w.d_ff) + w.time_dim + d;
}

__device__ inline Workspace carve(float* base, const ReproMegaWeights& w) {
  const int d = w.d_model, hq = w.n_heads * kHD, hkv = w.n_kv_heads * kHD;
  Workspace s;
  s.h = base;
  s.xn = s.h + kSeq * d;
  s.q = s.xn + kSeq * d;
  s.k = s.q + kSeq * hq;
  s.v = s.k + kSeq * hkv;
  s.ao = s.v + kSeq * hkv;
  s.ff = s.ao + kSeq * hq;
  s.th = s.ff + kSeq * w.d_ff;
  s.tv = s.th + w.time_dim;
  return s;
}

__device__ __forceinline__ float silu(float g) {
  return __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
}

enum Epilogue { kStore, kAddRow, kAccum, kSwiGLU };

// C (64 x N) op= A (64 x Kd) @ B (Kd x N), row-major, B a weight matrix in
// (in, out) layout.  kStore: C = AB; kAddRow: C = AB + aux[n];
// kAccum: C = C + AB; kSwiGLU: C = silu(C) * AB.  A and C are generic
// pointers (workspace or shared memory).  Needs N % 4 == 0, Kd % 32 == 0,
// 16-byte aligned rows.  Ends with a block barrier.
template <int EPI>
__device__ void block_matmul(const float* A, int lda,
                             const float* __restrict__ B, int ldb, float* C,
                             int ldc, int N, int Kd, const float* aux,
                             float* smem) {
  float* sA = smem;              // [kTK][kAS]: the A tile, k-major
  float* sB = smem + kTK * kAS;  // [kTK][kTN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int n0 = 0; n0 < N; n0 += kTN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < Kd; k0 += kTK) {
      // rows on consecutive lanes: the transposed stores hit distinct banks
      for (int i = tid; i < kSeq * (kTK / 4); i += kThreads) {
        const int m = i % kSeq, q4 = i / kSeq;
        const float4 a =
            *reinterpret_cast<const float4*>(A + m * lda + k0 + 4 * q4);
        sA[(4 * q4 + 0) * kAS + m] = a.x;
        sA[(4 * q4 + 1) * kAS + m] = a.y;
        sA[(4 * q4 + 2) * kAS + m] = a.z;
        sA[(4 * q4 + 3) * kAS + m] = a.w;
      }
      for (int i = tid; i < kTK * (kTN / 4); i += kThreads) {
        const int kk = i / (kTN / 4), n4 = i % (kTN / 4);
        const int n = n0 + 4 * n4;
        float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n < N)
          b = __ldg(reinterpret_cast<const float4*>(
              B + static_cast<long long>(k0 + kk) * ldb + n));
        *reinterpret_cast<float4*>(sB + kk * kTN + 4 * n4) = b;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(sA + kk * kAS +
                                                          4 * ty);
        const float4 b = *reinterpret_cast<const float4*>(sB + kk * kTN +
                                                          4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    const int n = n0 + 4 * tx;
    if (n < N) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* c = C + (4 * ty + i) * ldc + n;
        float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (EPI == kAddRow) {
          o.x = __fadd_rn(o.x, aux[n]);
          o.y = __fadd_rn(o.y, aux[n + 1]);
          o.z = __fadd_rn(o.z, aux[n + 2]);
          o.w = __fadd_rn(o.w, aux[n + 3]);
        } else if (EPI == kAccum) {
          const float4 p = *reinterpret_cast<const float4*>(c);
          o.x = __fadd_rn(p.x, o.x);
          o.y = __fadd_rn(p.y, o.y);
          o.z = __fadd_rn(p.z, o.z);
          o.w = __fadd_rn(p.w, o.w);
        } else if (EPI == kSwiGLU) {
          const float4 g = *reinterpret_cast<const float4*>(c);
          o.x = __fmul_rn(silu(g.x), o.x);
          o.y = __fmul_rn(silu(g.y), o.y);
          o.z = __fmul_rn(silu(g.z), o.z);
          o.w = __fmul_rn(silu(g.w), o.w);
        }
        *reinterpret_cast<float4*>(c) = o;
      }
    }
  }
  __syncthreads();
}

// xn[r] = rmsnorm(h[r], scale) for the 64 rows, one warp per row.
__device__ void norm_rows(const float* h, const float* scale, float* xn,
                          int d, float eps) {
  for (int r = threadIdx.x / 32; r < kSeq; r += kThreads / 32)
    repro::rms_norm_row_warp<float>(h + r * d, scale, xn + r * d, d, eps);
  __syncthreads();
}

// Rotary embedding in place on q (64 x H*64) and k (64 x Hkv*64): the head
// dim splits into halves, [x1 c - x2 s, x2 c + x1 s].
__device__ void rope_rows(float* q, float* k, int H, int Hkv,
                          const float* cos_t, const float* sin_t) {
  constexpr int half = kHD / 2;
  const int heads = H + Hkv;
  for (int i = threadIdx.x; i < kSeq * heads * half; i += kThreads) {
    const int s = i / (heads * half), hh = (i / half) % heads, j = i % half;
    float* row = hh < H ? q + (s * H + hh) * kHD
                        : k + (s * Hkv + hh - H) * kHD;
    const float x1 = row[j], x2 = row[j + half];
    const float c = cos_t[s * half + j], sn = sin_t[s * half + j];
    row[j] = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn));
    row[j + half] = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn));
  }
  __syncthreads();
}

// out (64 x 64, row stride ldo) = attention of one head over the sequence.
template <bool FLASH>
__device__ void attention_head(const float* q, int ldq, const float* k,
                               const float* v, int ldkv, float* out, int ldo,
                               float* smem) {
  constexpr int QS = kHD + 1, PS = kSeq + 1;
  float* sQ = smem;
  float* sK = sQ + kSeq * QS;
  float* sP = sK + kSeq * QS;
  float* sV = sP + kSeq * PS;
  // FLASH multiplies q by the softmax scale 1/sqrt(64) before the dot, as
  // streaming_attention_body; 'exact' divides the scores after it.
  const float q_scale = FLASH ? 0.125f : 1.0f;
  for (int i = threadIdx.x; i < kSeq * kHD; i += kThreads) {
    const int r = i / kHD, c = i % kHD;
    sQ[r * QS + c] = __fmul_rn(q[r * ldq + c], q_scale);
    sK[r * QS + c] = k[r * ldkv + c];
    sV[r * kHD + c] = v[r * ldkv + c];
  }
  __syncthreads();
  auto store = [&](int row, int col, float val) { out[row * ldo + col] = val; };
  if (FLASH) {
    repro::SoftmaxState<kSeq, kHD> st;
    st.init();
    repro::online_softmax_step<kSeq, kSeq, kHD, false>(sQ, sK, sV, sP, st, 0,
                                                       0);
    repro::softmax_finish<kSeq, kHD>(st, store);
  } else {
    constexpr int RQ = kSeq / 16, RK = kSeq / 16, RD = kHD / 16;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float s[RQ][RK];
    repro::qk_scores<kSeq, kSeq, kHD>(sQ, sK, s);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = repro::kNegBig;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = __fdiv_rn(s[i][j], 8.0f);  // / sqrt(64)
        mx = fmaxf(mx, s[i][j]);
      }
      mx = repro::half_warp_max(mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      sum = repro::half_warp_sum(sum);
#pragma unroll
      for (int j = 0; j < RK; ++j)
        sP[(ty * RQ + i) * PS + tx + 16 * j] = __fdiv_rn(s[i][j], sum);
    }
    __syncwarp();
    float pv[RQ][RD];
    repro::pv_product<kSeq, kSeq, kHD>(sP, sV, pv);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int r = 0; r < RD; ++r) store(ty * RQ + i, tx + 16 * r, pv[i][r]);
  }
  __syncthreads();  // smem is reused by the next head
}

// ROWS is the scheduler tick (B4): one step (K = 1), block b reads its own
// slot's embedding temb[b], and state element i of slot b takes coefficient
// row b * rows_per_slot + i / 256 of the (R, 8) per-row block.
template <bool CLIP, bool FLASH, bool ROWS>
__global__ void __launch_bounds__(kThreads)
megastep_kernel(const float* __restrict__ x, float* __restrict__ out,
                ReproMegaWeights w, const float* __restrict__ temb,
                const float* __restrict__ rope_cos,
                const float* __restrict__ rope_sin,
                const float* __restrict__ coefs, int K, float clip,
                float* ws_base) {
  extern __shared__ float smem[];
  const int n_state = kSeq * w.latent;
  float* sx = smem;                // the sample's state, whole launch
  float* se = sx + n_state;        // its eps, per step
  float* su = se + n_state;        // product / attention tiles
  const int d = w.d_model, L = w.latent, T = w.time_dim, dff = w.d_ff;
  const int H = w.n_heads, Hkv = w.n_kv_heads, G = H / Hkv;
  const int hq = H * kHD, hkv = Hkv * kHD;
  const Workspace ws =
      carve(ws_base + blockIdx.x * workspace_floats(w), w);
  const float* xb = x + static_cast<long long>(blockIdx.x) * n_state;

  for (int i = threadIdx.x; i < n_state; i += kThreads) sx[i] = xb[i];
  __syncthreads();

  const int steps = ROWS ? 1 : K;
  for (int step = 0; step < steps; ++step) {
    // time conditioning: th = silu(temb @ time_w1), tv = th @ time_w2
    const float* te =
        temb + static_cast<long long>(ROWS ? blockIdx.x : step) * T;
    for (int j = threadIdx.x; j < T; j += kThreads) {
      float a = 0.0f;
      for (int i = 0; i < T; ++i) a = fmaf(te[i], __ldg(w.time_w1 + i * T + j), a);
      ws.th[j] = silu(a);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < d; j += kThreads) {
      float a = 0.0f;
      for (int i = 0; i < T; ++i) a = fmaf(ws.th[i], __ldg(w.time_w2 + i * d + j), a);
      ws.tv[j] = a;
    }
    __syncthreads();
    block_matmul<kAddRow>(sx, L, w.w_in, d, ws.h, d, d, L, ws.tv, su);

    for (int layer = 0; layer < w.n_layers; ++layer) {
      const long long dd = d;
      const float* wq = w.wq + layer * dd * hq;
      const float* wk = w.wk + layer * dd * hkv;
      const float* wv = w.wv + layer * dd * hkv;
      const float* wo = w.wo + layer * static_cast<long long>(hq) * d;
      const float* wg = w.w_gate + layer * dd * dff;
      const float* wu = w.w_up + layer * dd * dff;
      const float* wdn = w.w_down + layer * static_cast<long long>(dff) * d;

      norm_rows(ws.h, w.attn_norm + layer * d, ws.xn, d, w.norm_eps);
      block_matmul<kStore>(ws.xn, d, wq, hq, ws.q, hq, hq, d, nullptr, su);
      block_matmul<kStore>(ws.xn, d, wk, hkv, ws.k, hkv, hkv, d, nullptr, su);
      block_matmul<kStore>(ws.xn, d, wv, hkv, ws.v, hkv, hkv, d, nullptr, su);
      rope_rows(ws.q, ws.k, H, Hkv, rope_cos, rope_sin);
      for (int h = 0; h < H; ++h)  // q head h reads kv head h / G
        attention_head<FLASH>(ws.q + h * kHD, hq, ws.k + (h / G) * kHD,
                              ws.v + (h / G) * kHD, hkv, ws.ao + h * kHD, hq,
                              su);
      block_matmul<kAccum>(ws.ao, hq, wo, d, ws.h, d, d, hq, nullptr, su);

      norm_rows(ws.h, w.mlp_norm + layer * d, ws.xn, d, w.norm_eps);
      block_matmul<kStore>(ws.xn, d, wg, dff, ws.ff, dff, dff, d, nullptr, su);
      block_matmul<kSwiGLU>(ws.xn, d, wu, dff, ws.ff, dff, dff, d, nullptr,
                            su);
      block_matmul<kAccum>(ws.ff, dff, wdn, d, ws.h, d, d, dff, nullptr, su);
    }
    norm_rows(ws.h, w.out_norm, ws.xn, d, w.norm_eps);
    block_matmul<kStore>(ws.xn, d, w.w_out, L, se, L, L, d, nullptr, su);

    if (ROWS) {
      const float* cb = coefs + static_cast<long long>(blockIdx.x) *
                                    (n_state / kTileC) * kRowCoefs;
      for (int i = threadIdx.x; i < n_state; i += kThreads) {
        const float* cr = cb + (i / kTileC) * kRowCoefs;
        const repro::Coefs c{cr[0], cr[1], cr[2], cr[3], cr[4]};
        float x0;
        sx[i] = repro::update<CLIP, false>(sx[i], se[i], c, clip, &x0);
      }
    } else {
      const repro::Coefs c{coefs[step * 5 + 0], coefs[step * 5 + 1],
                           coefs[step * 5 + 2], coefs[step * 5 + 3],
                           coefs[step * 5 + 4]};
      for (int i = threadIdx.x; i < n_state; i += kThreads) {
        float x0;
        sx[i] = repro::update<CLIP, false>(sx[i], se[i], c, clip, &x0);
      }
    }
    __syncthreads();
  }

  float* ob = out + static_cast<long long>(blockIdx.x) * n_state;
  for (int i = threadIdx.x; i < n_state; i += kThreads) ob[i] = sx[i];
}

bool widths_ok(const ReproMegaWeights& w) {
  return w.n_layers >= 0 && w.n_heads > 0 && w.n_kv_heads > 0 &&
         w.n_heads % w.n_kv_heads == 0 && w.d_model % kTK == 0 &&
         w.d_ff % kTK == 0 && w.latent % kTK == 0 && w.latent <= 128 &&
         w.time_dim % 4 == 0 && (kSeq * w.latent) % kTileC == 0;
}

template <bool CLIP, bool FLASH, bool ROWS>
int launch(const float* x, float* out, const ReproMegaWeights& w,
           const float* temb, const float* rope_cos, const float* rope_sin,
           const float* coefs, int K, int batch, float clip, float* ws,
           cudaStream_t s) {
  const int bytes = (2 * kSeq * w.latent + kUnionFloats) * 4;
  auto kern = megastep_kernel<CLIP, FLASH, ROWS>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<batch, kThreads, bytes, s>>>(x, out, w, temb, rope_cos, rope_sin,
                                      coefs, K, clip, ws);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROWS>
int dispatch(const void* x, void* out, const ReproMegaWeights* w,
             const void* temb, const void* rope_cos, const void* rope_sin,
             const void* coefs, int K, int batch, int has_clip, float clip,
             int flash, void* ws, void* stream) {
  if (!widths_ok(*w) || K < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const float* tf = static_cast<const float*>(temb);
  const float* cf = static_cast<const float*>(rope_cos);
  const float* sf = static_cast<const float*>(rope_sin);
  const float* kf = static_cast<const float*>(coefs);
  float* wf = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_clip)
    return flash ? launch<true, true, ROWS>(xf, of, *w, tf, cf, sf, kf, K,
                                            batch, clip, wf, s)
                 : launch<true, false, ROWS>(xf, of, *w, tf, cf, sf, kf, K,
                                             batch, clip, wf, s);
  return flash ? launch<false, true, ROWS>(xf, of, *w, tf, cf, sf, kf, K,
                                           batch, clip, wf, s)
               : launch<false, false, ROWS>(xf, of, *w, tf, cf, sf, kf, K,
                                            batch, clip, wf, s);
}

}  // namespace

extern "C" {

// Workspace floats one sample needs (the wrapper allocates batch of them).
long long repro_megastep_workspace_floats(const ReproMegaWeights* w) {
  return workspace_floats(*w);
}

// x, out: (batch * 64 * latent / 256, 256) float32 tile view, sample b at
// flat offset b * 64 * latent; temb: (K, time_dim) sinusoidal embeddings of
// the K timesteps; rope_cos / rope_sin: (64, 32); coefs: (K, 5) rows
// [c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t]; ws: batch x
// repro_megastep_workspace_floats floats.  All device pointers, float32,
// 16-byte aligned.  Returns the cudaError_t of the launch (0 on success).
int repro_megastep(const void* x, void* out, const ReproMegaWeights* w,
                   const void* temb, const void* rope_cos,
                   const void* rope_sin, const void* coefs, int K, int batch,
                   int has_clip, float clip, int flash, void* ws,
                   void* stream) {
  return dispatch<false>(x, out, w, temb, rope_cos, rope_sin, coefs, K, batch,
                         has_clip, clip, flash, ws, stream);
}

// One scheduler tick (B4, replaces megastep_rows_call of
// src/repro/kernels/megastep/kernel.py:269): as repro_megastep with K = 1,
// but temb is (batch, time_dim), one embedding per slot, and coefs is the
// (R, 8) per-row block (sampler_step ops.expand_slot_coefs), R = batch * 64
// * latent / 256.
int repro_megastep_rows(const void* x, void* out, const ReproMegaWeights* w,
                        const void* temb, const void* rope_cos,
                        const void* rope_sin, const void* row_coefs,
                        int batch, int has_clip, float clip, int flash,
                        void* ws, void* stream) {
  return dispatch<true>(x, out, w, temb, rope_cos, rope_sin, row_coefs, 1,
                        batch, has_clip, clip, flash, ws, stream);
}

}  // extern "C"
