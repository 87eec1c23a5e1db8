// The streaming-softmax recurrence of flash attention, as a block-level
// device body: the megastep kernel's 'flash' trunk (the flash_attention
// kernel has its own tensor-core body, flash_mma.cuh).  Port of
// ``online_softmax_step`` (src/repro/kernels/flash_attention/kernel.py:28)
// and of the normalisation at the end of ``streaming_attention_body`` (:55).
//
// All operands are float32 tiles in shared memory:
//   sQ  (BQ, D) row stride D + 1, already multiplied by the softmax scale
//   sK  (BK, D) row stride D + 1
//   sV  (BK, D) row stride D
//   sP  (BQ, BK) row stride BK + 1, scratch for the probabilities
// The +1 pads keep the 16 lanes of a row group on distinct banks.
//
// Thread layout (256 threads as a 16 x 16 grid): thread (ty, tx) =
// (tid / 16, tid % 16) owns score rows ty*RQ + i (i < RQ = BQ/16), score
// columns tx + 16 j (j < BK/16) and output columns tx + 16 r (r < D/16).
// The 16 threads of one row group form one half-warp, so the row max and
// sum are shuffles inside 16 lanes, and the P rows a half-warp writes are
// read back only by that half-warp: __syncwarp() orders them.
#pragma once

namespace repro {

constexpr float kNegBig = -1e30f;  // the masked score, as the TPU kernel
constexpr int kAttnThreads = 256;

template <int BQ, int D>
struct SoftmaxState {
  static constexpr int RQ = BQ / 16;
  static constexpr int RD = D / 16;
  float m[RQ];
  float l[RQ];
  float acc[RQ][RD];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      m[i] = kNegBig;
      l[i] = 0.0f;
#pragma unroll
      for (int r = 0; r < RD; ++r) acc[i][r] = 0.0f;
    }
  }
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[i][j] = sum_d sQ[row i, d] sK[col j, d] for the thread's tile.
template <int BQ, int BK, int D>
__device__ __forceinline__ void qk_scores(const float* sQ, const float* sK,
                                          float (&s)[BQ / 16][BK / 16]) {
  constexpr int RQ = BQ / 16, RK = BK / 16, QS = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RQ], b[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) a[i] = sQ[(ty * RQ + i) * QS + d];
#pragma unroll
    for (int j = 0; j < RK; ++j) b[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// pv[i][r] = sum_c sP[row i, c] sV[c, col r] for the thread's tile.
template <int BQ, int BK, int D>
__device__ __forceinline__ void pv_product(const float* sP, const float* sV,
                                           float (&pv)[BQ / 16][D / 16]) {
  constexpr int RQ = BQ / 16, RD = D / 16, PS = BK + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int r = 0; r < RD; ++r) pv[i][r] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    float v[RD];
#pragma unroll
    for (int r = 0; r < RD; ++r) v[r] = sV[c * D + tx + 16 * r];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float p = sP[(ty * RQ + i) * PS + c];
#pragma unroll
      for (int r = 0; r < RD; ++r) pv[i][r] = fmaf(p, v[r], pv[i][r]);
    }
  }
}

// One KV block: s = q k^T (masked above the diagonal when CAUSAL, and
// from column k_valid on: a ragged last block, whose V rows there the
// caller zero-fills), m' = max(m, rowmax s), p = exp(s - m'),
// alpha = exp(m - m'), l' = alpha l + rowsum p, acc' = acc alpha + p v.
// Every thread of the block calls it; the caller synchronises the block
// before (tiles loaded) and before it overwrites sK / sV.
template <int BQ, int BK, int D, bool CAUSAL>
__device__ __forceinline__ void online_softmax_step(
    const float* sQ, const float* sK, const float* sV, float* sP,
    SoftmaxState<BQ, D>& st, int q_start, int k_start, int k_valid) {
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16, PS = BK + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float s[RQ][RK];
  qk_scores<BQ, BK, D>(sQ, sK, s);

  float alpha[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = ty * RQ + i;
    float mx = kNegBig;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      if ((CAUSAL && q_start + row < k_start + tx + 16 * j) ||
          (k_valid < BK && tx + 16 * j >= k_valid))
        s[i][j] = kNegBig;
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(st.m[i], half_warp_max(mx));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const float p = expf(s[i][j] - m_new);
      sP[row * PS + tx + 16 * j] = p;
      sum += p;
    }
    alpha[i] = expf(st.m[i] - m_new);
    st.l[i] = alpha[i] * st.l[i] + half_warp_sum(sum);
    st.m[i] = m_new;
  }
  __syncwarp();

  float pv[RQ][RD];
  pv_product<BQ, BK, D>(sP, sV, pv);
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int r = 0; r < RD; ++r)
      st.acc[i][r] = st.acc[i][r] * alpha[i] + pv[i][r];
  __syncwarp();  // the next step overwrites this half-warp's P rows
}

// out[row, col] = acc / max(l, 1e-20) for the thread's rows and columns;
// ``store(row, col, value)`` writes one element.
template <int BQ, int D, typename Store>
__device__ __forceinline__ void softmax_finish(const SoftmaxState<BQ, D>& st,
                                               Store store) {
  constexpr int RQ = BQ / 16, RD = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float denom = fmaxf(st.l[i], 1e-20f);
#pragma unroll
    for (int r = 0; r < RD; ++r)
      store(ty * RQ + i, tx + 16 * r, __fdiv_rn(st.acc[i][r], denom));
  }
}

}  // namespace repro
