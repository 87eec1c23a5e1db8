// The sampler megakernels for Hopper (sm_90a), plain-C ABI: K consecutive
// plan steps, each the whole dense diffusion-LM eps trunk followed by the
// Eq. 12 update, in ONE launch (repro_megastep); or one continuous-batching
// scheduler tick, the trunk with a timestep per slot followed by the
// per-row update (repro_megastep_rows).  Both are one kernel template.
// This body is compiled once per weight type: megastep.cu (float32
// weights) and megastep_bf16.cu (bfloat16 weights) define
// REPRO_MEGA_WEIGHT and include it, so the two libraries build in
// parallel, 8 kernels each.
//
// Replaces the Pallas TPU kernels ``megastep_call`` (B3) and
// ``megastep_rows_call`` (B4) of src/repro/kernels/megastep/kernel.py:232
// and :269 (bodies ``_mega_kernel`` / ``_mega_rows_kernel``, ``eps_exact``
// / ``eps_flash``).  Per step and sample (float32 here; bfloat16 below):
//   temb = silu(sinusoid(t) @ time_w1) @ time_w2
//   h    = x @ w_in + temb
//   n_layers x [ xn = rmsnorm(h); q, k, v = xn @ wq, wk, wv; rope(q, k);
//                h += attention(q, k, v) @ wo;
//                xn = rmsnorm(h); h += (silu(xn @ w_gate) * (xn @ w_up)) @ w_down ]
//   eps  = rmsnorm(h) @ w_out;   x = update(x, eps, coefs[k])
// The sinusoid (cos / sin of t * freq) and the RoPE cos / sin table are
// computed by the wrapper with the plain functions and passed in, as the
// TPU kernel takes them as hoisted constants (kernel.py:188-229).
// attention is 'exact' (q k^T / sqrt(D), a whole-row softmax, then p v —
// models/attention._grouped_attention) or 'flash' (q pre-scaled by
// 1/sqrt(D), the shared online_softmax_step body over the K/V blocks, acc /
// max(l, 1e-20) — kernel.py:83-130).  The norms' inverse RMS is the shared
// rmsnorm body's (rms_inv_from_sumsq), the update the shared step body
// (step_update.cuh).  There is no PRNG code: mega plans are deterministic.
//
// Geometry (the float32 domain of the TPU kernel): any seq_len S that is a
// multiple of 64 (a 64-row product tile never straddles two samples, so a
// tile's slot is m0 / S), head dim D in {16, 32, 64, 128} (a runtime value:
// only the attention phase is instantiated per D, so the build stays at 8
// kernels), and widths whose products the 64 x 32 tiles cut exactly
// (widths_ok).  sqrt(D) and 1/sqrt(D) are the float32 values JAX's exact
// and flash trunks use, computed by the launcher.
//
// bfloat16 (the TPU kernel's dtype rules, kernel.py:152-155, :171-174).
// The state is float32 or bfloat16 (a runtime switch): a bfloat16 state is
// widened into a float32 copy in the workspace as the launch starts, and
// every step's update is rounded to bfloat16 before it is stored.  The
// weights are all float32 or all bfloat16 (REPRO_MEGA_WEIGHT): bfloat16
// weight slices are copied as they are (cp.async, half of each stage's B
// area) and widened as the product reads its fragments (same ring, same
// shared memory, same 2 blocks per SM).  The trunk computes in the
// promotion of the two types, as jnp does: float32 unless both are
// bfloat16.  Then (``round_trunk``) every value that JAX's op sequence
// makes in bfloat16 is rounded there: each product's output (summed in
// float32), the norms' inverse RMS, x * inv and * scale (so the norm is
// applied to the A fragments before the product, from a row sum of
// squares taken first, and not in the epilogue), the time MLP's silu, the
// RoPE products and sums (on bfloat16 cos / sin), exact attention's
// scores and probabilities (divided by the bfloat16 sqrt(D)), the
// attention output, SwiGLU's silu and product, the residual adds and eps.
// Every A operand then holds bfloat16 values and every B operand too,
// which are exact in TF32: one mma.sync pass per product is exact, and
// the two 3xTF32 correction passes are skipped (bfloat16 weights also
// skip the pass of B's remainder, which is 0, under a float32 trunk).
//
// Bound on the H100: operations.  One step at smollm width (d 576, 9 / 3
// heads of 64, d_ff 1536, 2 layers), batch 4, 64 tokens is ~3.7 GFLOP
// (2 x 256 tokens x 7.11 M eps-path weights, plus attention), so an
// 8-step launch is ~30 GFLOP, ~0.44 ms at 67 TFLOP/s float32; reading the
// 29.3 MB of weights once takes ~9 us at 3.35 TB/s.  A scheduler tick is
// one such step, ~56 us at 67 TFLOP/s.
//
// Grid, phases, barriers.  One persistent cooperative launch
// (cudaLaunchKernelEx with cudaLaunchAttributeCooperative, which also
// captures into a CUDA graph) of 256-thread blocks, as many per SM as the
// occupancy query admits for the real shared memory, capped at
// kMaxBlocksPerSM: 264 blocks (2 per SM) on an H100, whatever the batch.  A
// refused launch is returned as its error; nothing falls back.  Every
// block runs the step loop; each step is a chain of phases separated by
// cooperative_groups::this_grid().sync().  A phase cuts its work into
// items over the whole batch (M = batch x S token rows); item i goes to
// the block of rank i mod grid, ranks ordering blocks by (slot on their
// SM, SM id) so that the first items of a phase land on distinct SMs:
//   time  th = silu(temb @ time_w1) for every embedding of the launch (K
//         for B3, one per slot for B4): once per launch
//   w_in  h = x @ w_in + th @ time_w2: 64 x 32 output tiles; the block
//         computes its 32 columns of th @ time_w2 itself
//   per layer:
//   qkv   [q k v] = rmsnorm(h) @ [wq wk wv] (one product, N = H*D +
//         2 Hkv*D)
//   attn  one item per (sample, q head, block of 32 query rows) on kv head
//         h / G, looping over the sample's K/V blocks of 64 rows (32 at D =
//         128, so that the tiles fit the product ring's shared memory and
//         two blocks stay resident per SM); RoPE is applied to q and k as
//         they are loaded, at their own positions.  'flash' runs the
//         online-softmax recurrence over the blocks; 'exact' takes two
//         passes, the rows' max and sum first, then p = exp(s - max) / sum
//         and p v block by block (one pass where S is one block: then it is
//         the plain row softmax)
//   wo    h += attn @ wo, split-K
//   mlp   ff = silu(rmsnorm(h) @ w_gate) * (rmsnorm(h) @ w_up), both
//         products in one item
//   down  h += ff @ w_down, split-K
//   out   eps = rmsnorm(h) @ w_out, split-K, with the Eq. 12 update fused
//         into the epilogue: a 64 x 32 tile of eps is a run of the
//         sample's state elements, so element i of sample b takes its
//         coefficients (B4: row b * rows_per_slot + i / 256) and x in place
// That is 2 + 5 n_layers grid barriers per step (12 at 2 layers), one more
// per launch for the time MLP and one fewer after the last step.  A
// normed product computes rmsnorm(h) @ W as inv[row] * ((h * scale) @ W):
// the A fragments are multiplied by the norm's scale as they are read,
// each row's sum of squares is taken from the A slices as they stream
// through shared memory, and the epilogue multiplies by the inverse RMS
// (rms_inv_from_sumsq, rmsnorm_body.cuh), so no phase rereads h for its
// norm.  Split-K partials (and, for normed products, partial sums of
// squares) go to the workspace; the last item of a tile to arrive (an
// atomic counter elects it: no thread waits) sums them in split order 0,
// 1, ... and applies the epilogue, so no sum depends on timing and two
// launches on the same inputs are bitwise equal.
//
// Products: 64 x 32 output tiles, 8 warps of 16 x 16, depth slices of 32
// staged by cp.async.cg in a 4-stage ring in dynamic shared memory, so the
// copies of slices i + 1 .. i + 3 overlap the product of slice i.  They run
// on the tensor cores as 3xTF32: each float32 operand splits into a TF32
// big part (round to nearest, ties away: the bits of cvt.rna.tf32.f32,
// computed with two integer ops) and the TF32 rounding of the remainder,
// and mma.sync.m16n8k8 (float32 accumulators) sums small.big + big.small +
// big.big: float32-level products (plain twin: ref.tf32x3_matmul).  The
// time MLP and attention stay float32 FFMA.  On the H100 the products are
// bound by the mma.sync work, not by the copies (bound_probe.py compiles
// out either and times the phases): wgmma is the next step.
//
// Memory ordering.  Activations (h, qkv, attn, ff, th, the split-K
// partials and, from the second step, the state in ``out``) live in one
// workspace for the whole batch, allocated by the wrapper, and stay in
// the 50 MB L2.  Another block writes them inside the same launch, so they
// are read only through L2 (cp.async.cg, __ldcg), never through __ldg,
// ld.global.nc or an L1-caching cp.async.ca, whose lines may be stale
// after a grid barrier.  __ldg reads only weights and inputs that the
// launch never writes.  The state x must not alias out.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "flash_attention/csrc/mma_helpers.cuh"
#include "flash_attention/csrc/online_softmax.cuh"
#include "rmsnorm/csrc/rmsnorm_body.cuh"
#include "sampler_step/csrc/step_update.cuh"

#ifndef REPRO_MEGA_WEIGHT
#error "define REPRO_MEGA_WEIGHT (float or __nv_bfloat16) first"
#endif

// Device pointers of the eps-path weights (stacked (n_layers, ...) leaves,
// (in, out) layouts as the JAX pytree), all of this library's weight type,
// and the trunk's widths.  The layout is mirrored by ctypes in
// ../kernel.py; ``dtype`` names the weight type (0 float32, 1 bfloat16),
// and a launch refuses weights of the other library's type.
struct ReproMegaWeights {
  const REPRO_MEGA_WEIGHT* w_in;       // (L, d)
  const REPRO_MEGA_WEIGHT* time_w1;    // (T, T)
  const REPRO_MEGA_WEIGHT* time_w2;    // (T, d)
  const REPRO_MEGA_WEIGHT* out_norm;   // (d,)
  const REPRO_MEGA_WEIGHT* w_out;      // (d, L)
  const REPRO_MEGA_WEIGHT* attn_norm;  // (n, d)
  const REPRO_MEGA_WEIGHT* mlp_norm;   // (n, d)
  const REPRO_MEGA_WEIGHT* wq;         // (n, d, H*D)
  const REPRO_MEGA_WEIGHT* wk;         // (n, d, Hkv*D)
  const REPRO_MEGA_WEIGHT* wv;         // (n, d, Hkv*D)
  const REPRO_MEGA_WEIGHT* wo;         // (n, H*D, d)
  const REPRO_MEGA_WEIGHT* w_gate;     // (n, d, d_ff)
  const REPRO_MEGA_WEIGHT* w_up;       // (n, d, d_ff)
  const REPRO_MEGA_WEIGHT* w_down;     // (n, d_ff, d)
  int n_layers, d_model, n_heads, n_kv_heads, d_ff, time_dim, latent,
      head_dim;
  float norm_eps;
  int dtype;
};

namespace {

namespace cg = cooperative_groups;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::kAttnThreads;
using repro::mma_tf32;
using repro::to_tf32;
using WT = REPRO_MEGA_WEIGHT;  // the weights' type
constexpr bool kBf16W = std::is_same<WT, __nv_bfloat16>::value;
static_assert(kBf16W || std::is_same<WT, float>::value,
              "weights are float32 or bfloat16");
constexpr int kWeightCode = kBf16W ? 1 : 0;

constexpr int kThreads = kAttnThreads;  // 256: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSeqMultiple = 64;        // seq_len granule (= kBM)
constexpr int kBQ = 32;                 // query rows of an attention item
constexpr int kBM = 64;                 // rows of a product tile
constexpr int kBN = 32;                 // columns of a product tile
constexpr int kBK = 32;                 // depth of a staged slice
constexpr int kStages = 4;              // cp.async ring
constexpr int kAS = kBK + 4;            // A slice row stride: conflict-free
constexpr int kBS = kBN + 8;            // B slice row stride: conflict-free
constexpr int kAStage = kBM * kAS;
constexpr int kBStage = kBK * kBS;
// bfloat16 weights stay bfloat16 in the ring, in the first half of each B
// area, rows of kBSh (conflict-free fragment reads, 16-byte rows)
constexpr int kBSh = kBN + 8;
static_assert(kBK * kBSh * 2 <= kBStage * 4, "bfloat16 B fits its area");
constexpr int kStageFloats = kAStage + 2 * kBStage;  // A, B (and B2)
constexpr int kGemmFloats = kStages * kStageFloats;

// The attention tiles of head dim HD in the union area: sQ (kBQ, HD), sK
// (BK, HD) with +1 pads, sP (kBQ, BK) +1, sV (BK, HD) 16-byte aligned.
template <int HD>
struct AttnTiles {
  static constexpr int BK = HD == 128 ? 32 : 64;  // K/V rows of a block
  static constexpr int QS = HD + 1, PS = BK + 1;
  static constexpr int kQ = 0, kK = kQ + kBQ * QS, kP = kK + BK * QS;
  static constexpr int kV = (kP + kBQ * PS + 3) / 4 * 4;
  static constexpr int kFloats = kV + BK * HD;
};
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kAttnFloats =
    cmax(cmax(AttnTiles<16>::kFloats, AttnTiles<32>::kFloats),
         cmax(AttnTiles<64>::kFloats, AttnTiles<128>::kFloats));
static_assert(kAttnFloats <= kGemmFloats,
              "the attention tiles must not grow shared memory past the "
              "product ring: two blocks per SM");
constexpr int kUnionFloats =
    kGemmFloats > kAttnFloats ? kGemmFloats : kAttnFloats;
// + the tile's row sums of squares, the partial dots of a 32-column row,
// its sums, and the block's rank (an int)
constexpr int kRankSlot = kUnionFloats + kBM + kWarps * 32 + 32;
constexpr int kSmemFloats = kRankSlot + 4;
constexpr int kSmemBytes = kSmemFloats * 4;
constexpr int kMaxBlocksPerSM = 2;
constexpr int kMinSlicesPerSplit = 2;
constexpr int kTileC = 256;             // width of the tile view
constexpr int kRowCoefs = 8;            // columns of a per-row coefficient row
constexpr int kMaxDevices = 16;

// Everything a launch reads: the weights, the inputs, the workspace and
// the split-K factors of the plan.
struct Params {
  ReproMegaWeights w;
  const float* x;             // a float32 state (null for bfloat16)
  float* out;
  const __nv_bfloat16* xb;    // a bfloat16 state (null for float32)
  __nv_bfloat16* outb;
  int state_bf16;             // the state is bfloat16
  int round_trunk;            // the trunk is bfloat16 (bfloat16 state and
                              // weights): round as JAX's ops do
  const float* temb;
  const float* rope_cos;
  const float* rope_sin;
  const float* coefs;
  int K, batch, seq, n_emb, n_cnt;
  float clip;
  float attn_div;  // sqrt(D) in float32: 'exact' divides the scores by it
  float q_scale;   // 1/sqrt(D) in float32: 'flash' multiplies q by it
  float *h, *qkv, *ao, *ff, *th, *part, *ssq;
  float* xs;  // a bfloat16 state widened to float32, updated every step
  int* cnt;
  int* sm_of;  // the SM of each block
  int split_wo, split_dn, split_out;
  unsigned long long* trace;  // null, or one stamp per phase boundary
};

struct Plan {
  int grid, per_sm, split_wo, split_dn, split_out;
};

struct Layout {
  long long h, qkv, ao, ff, th, part, ssq, xs, cnt, n_cnt, sm_of, total;
};

long long round4(long long n) { return (n + 3) / 4 * 4; }

// Split-K for the phases with too few output tiles to occupy the grid
// (the residual products wo, w_down and w_out), as far as the grid has
// blocks and every item keeps at least kMinSlicesPerSplit slices.
int split_for(int tiles, int slices, int grid) {
  int s = grid / tiles;
  if (s > slices / kMinSlicesPerSplit) s = slices / kMinSlicesPerSplit;
  return s < 1 ? 1 : s;
}

Plan make_plan(const ReproMegaWeights& w, int batch, int seq, int per_sm,
               int sms) {
  Plan p;
  p.per_sm = per_sm;
  p.grid = per_sm * sms;
  const int mt = batch * seq / kBM;
  p.split_wo =
      split_for(mt * w.d_model / kBN, w.n_heads * w.head_dim / kBK, p.grid);
  p.split_dn = split_for(mt * w.d_model / kBN, w.d_ff / kBK, p.grid);
  p.split_out = split_for(mt * w.latent / kBN, w.d_model / kBK, p.grid);
  return p;
}

// Workspace offsets in floats (each a multiple of 4: 16-byte aligned).
Layout layout(const ReproMegaWeights& w, int batch, int seq, int n_emb,
              const Plan& p) {
  const long long M = static_cast<long long>(batch) * seq,
                  d = w.d_model, hq = w.n_heads * w.head_dim,
                  hkv = w.n_kv_heads * w.head_dim, L = w.latent;
  long long part = p.split_wo * M * d;
  if (p.split_dn * M * d > part) part = p.split_dn * M * d;
  if (p.split_out * M * L > part) part = p.split_out * M * L;
  Layout l;
  long long o = 0;
  l.h = o;
  o += M * d;
  l.qkv = o;
  o += M * (hq + 2 * hkv);
  l.ao = o;
  o += M * hq;
  l.ff = o;
  o += M * w.d_ff;
  l.th = o;
  o += round4(static_cast<long long>(n_emb) * w.time_dim);
  l.part = o;  // split-K partial tiles
  o += part;
  l.ssq = o;  // row sums of squares of the split w_out items
  o += p.split_out * (M / kBM) * (L / kBN) * kBM;
  l.xs = o;  // the state in float32 (bfloat16 states)
  o += M * L;
  l.cnt = o;  // arrival counters of split tiles
  l.n_cnt = M / kBM * ((d > L ? d : L) / kBN);
  o += round4(l.n_cnt);
  l.sm_of = o;
  o += round4(p.grid);
  l.total = o;
  return l;
}

// ------------------------------------------------------------ primitives
__device__ __forceinline__ float silu(float g) {
  return __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
}

// v rounded to the nearest bfloat16 (ties to even), as a float32: the bits
// of __float2bfloat16_rn for every finite v, as integer ops at the full
// ALU rate (the cvt goes through the slower conversion pipe).
__device__ __forceinline__ float bf16_round(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// v as the trunk's type holds it: rounded to bfloat16 in a bfloat16 trunk
// (only the bfloat16-weight library has one), else v.
__device__ __forceinline__ float rt(const Params& p, float v) {
  if constexpr (kBf16W) return p.round_trunk ? bf16_round(v) : v;
  return v;
}

// Weight i, widened to float32.
__device__ __forceinline__ float wload(const WT* w, long long i) {
  return repro::to_f32(__ldg(w + i));
}

// x = big + small, both TF32: big = rna(x), small = rna(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

// ------------------------------------------------------------ block ranks
// A phase gives item i to the block of rank i mod grid.  Ranks order the
// blocks by (slot on their SM, SM), so the first ``SM count`` items of a
// phase land on distinct SMs (the hardware may place consecutive blocks
// on one SM).  Which block runs an item does not change its arithmetic.
__device__ __forceinline__ int block_rank(const float* smem) {
  return *reinterpret_cast<const int*>(smem + kRankSlot);
}

// After a grid barrier that follows the writes of p.sm_of: the rank of
// this block among (slot, SM) keys, slot = the number of lower-numbered
// blocks on the same SM.  Uses the union area of shared memory.
__device__ __noinline__ void compute_rank(const Params& p, float* smem) {
  int* sm = reinterpret_cast<int*>(smem);
  __shared__ int s_count;
  const int grid = gridDim.x;
  for (int j = threadIdx.x; j < grid; j += kThreads) sm[j] = __ldcg(p.sm_of + j);
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  auto key = [&](int j) {
    int slot = 0;
    for (int i = 0; i < j; ++i) slot += sm[i] == sm[j];
    return static_cast<long long>(slot) << 32 | static_cast<unsigned>(sm[j]);
  };
  const long long mine = key(blockIdx.x);
  int below = 0;
  for (int j = threadIdx.x; j < grid; j += kThreads) below += key(j) < mine;
  atomicAdd(&s_count, below);  // an integer count: order-free
  __syncthreads();
  if (threadIdx.x == 0) *reinterpret_cast<int*>(smem + kRankSlot) = s_count;
  __syncthreads();
}

// ---------------------------------------------------------- product tiles
// One 64 x 32 output tile (two with DUAL: the same A against B0 and B1)
// over depth slices [sl0, sl1) of 32.  A points at row m0, column 0 of a
// row-major activation (lda); B0 / B1 at row 0, column n0 of a row-major
// (K, N) weight (ldb).  NORM computes rmsnorm(A) @ B as
// inv[row] * ((A * scale[k]) @ B): the fragments of A are multiplied by
// the norm's scale as they are read, each row's sum of squares is taken
// from the slices as they stream through shared memory, and the epilogue
// multiplies by the inverse RMS (equal in exact arithmetic to scaling A).
// In a bfloat16 trunk NORM takes the norm's own op order instead: the
// rows' inverse RMS first (row_inv_bf16), then each A element as
// bfloat16(bfloat16(a * inv) * scale), and no epilogue factor.
struct Tile {
  const float* A;
  const WT* B0;
  const WT* B1;
  int lda, ldb, sl0, sl1;
  const WT* scale;
};

// The copies of slice sl into stage st by cp.async: A, and B as stored
// (bfloat16 weights stay bfloat16 and are widened as the fragments are
// read: the same ring, the same copies in flight).
template <bool DUAL>
__device__ __forceinline__ void load_slice(float* st, const Tile& t,
                                           int sl) {
  const int tid = threadIdx.x, k = sl * kBK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 64 rows x 8 chunks of 16 bytes
    const int c = tid + i * kThreads, r = c >> 3, q = c & 7;
    cp_async16(st + r * kAS + 4 * q,
               t.A + static_cast<long long>(r) * t.lda + k + 4 * q);
  }
  if constexpr (kBf16W) {  // 32 rows x 4 chunks of 8 per B: B1 on tid 128+
    const int c = tid & 127, r = c >> 2, q = c & 3;
    const bool second = DUAL && tid >= 128;
    if (DUAL || tid < 128)
      cp_async16(reinterpret_cast<uint16_t*>(st + kAStage +
                                             (second ? kBStage : 0)) +
                     r * kBSh + 8 * q,
                 (second ? t.B1 : t.B0) +
                     static_cast<long long>(k + r) * t.ldb + 8 * q);
  } else {
    const int r = tid >> 3, q = tid & 7;  // 32 rows x 8 chunks
    const long long off = static_cast<long long>(k + r) * t.ldb + 4 * q;
    cp_async16(st + kAStage + r * kBS + 4 * q, t.B0 + off);
    if (DUAL) cp_async16(st + kAStage + kBStage + r * kBS + 4 * q, t.B1 + off);
  }
}

// Warp (wm, wn) = (warp % 4, warp / 4) owns rows 16 wm + [0, 16) and
// columns 16 wn + [0, 16): two m16n8 fragments per B.  ``bf16`` (a
// bfloat16 trunk): every A and B value is a bfloat16, exact in TF32, so
// one pass (big.big) is the product; NORM then normalises the fragments
// by the rows' inverse RMS inv0 (row g) and inv1 (row g + 8).  bfloat16
// weights have no remainder (the small.big pass of B is 0 and skipped).
template <bool NORM, bool DUAL, bool BF16>
__device__ __forceinline__ void mma_slice_as(const float* st, const Tile& t,
                                             int sl, float inv0, float inv1,
                                             float (&acc)[DUAL ? 2 : 1][2][4]) {
  constexpr bool bf16 = BF16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp & 3, wn = warp >> 2;
  const float* sA = st + (wm * 16 + g) * kAS;
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const int kc = kk * 8 + q;
    float a[4] = {sA[kc], sA[8 * kAS + kc], sA[kc + 4], sA[8 * kAS + kc + 4]};
    if (NORM) {
      const float s0 = wload(t.scale, sl * kBK + kc);
      const float s1 = wload(t.scale, sl * kBK + kc + 4);
      if (bf16) {  // bfloat16(bfloat16(a * inv) * scale), as rms_norm
        a[0] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(a[0], inv0)), s0));
        a[1] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(a[1], inv1)), s0));
        a[2] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(a[2], inv0)), s1));
        a[3] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(a[3], inv1)), s1));
      } else {
        a[0] = __fmul_rn(a[0], s0);
        a[1] = __fmul_rn(a[1], s0);
        a[2] = __fmul_rn(a[2], s1);
        a[3] = __fmul_rn(a[3], s1);
      }
    }
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (bf16) {
        ab[i] = __float_as_uint(a[i]);
        as[i] = 0u;
      } else {
        split_tf32(a[i], ab[i], as[i]);
      }
    }
    constexpr int NF = (DUAL ? 2 : 1) * 2;  // accumulators of this warp
    uint32_t bb[NF][2], bs[NF][2];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* sB = st + kAStage + (f / 2) * kBStage;
      const int n = wn * 16 + (f % 2) * 8 + g;
      if constexpr (kBf16W) {  // a bfloat16's bits are its float32's top half
        const uint16_t* sBh = reinterpret_cast<const uint16_t*>(sB);
        bb[f][0] = static_cast<uint32_t>(sBh[kc * kBSh + n]) << 16;
        bb[f][1] = static_cast<uint32_t>(sBh[(kc + 4) * kBSh + n]) << 16;
      } else {
        split_tf32(sB[kc * kBS + n], bb[f][0], bs[f][0]);
        split_tf32(sB[(kc + 4) * kBS + n], bb[f][1], bs[f][1]);
      }
    }
    // pass-major: consecutive mma.sync go to independent accumulators
    if (!bf16) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        mma_tf32(acc[f / 2][f % 2], as, bb[f][0], bb[f][1]);
    }
    if constexpr (!kBf16W) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        mma_tf32(acc[f / 2][f % 2], ab, bs[f][0], bs[f][1]);
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
      mma_tf32(acc[f / 2][f % 2], ab, bb[f][0], bb[f][1]);
  }
}

// The slice's product, its loop specialised to the trunk's type (one
// uniform branch per slice, none inside the unrolled loop).
template <bool NORM, bool DUAL>
__device__ __forceinline__ void mma_slice(const float* st, const Tile& t,
                                          int sl, bool bf16, float inv0,
                                          float inv1,
                                          float (&acc)[DUAL ? 2 : 1][2][4]) {
  if constexpr (kBf16W)
    if (bf16) {
      mma_slice_as<NORM, DUAL, true>(st, t, sl, inv0, inv1, acc);
      return;
    }
  mma_slice_as<NORM, DUAL, false>(st, t, sl, inv0, inv1, acc);
}

// The inverse RMS of the tile's kBM rows of A (depth Kd) in a bfloat16
// trunk, rounded to bfloat16 (rms_inv_from_sumsq), into inv[kBM]: four
// threads per row sum its squares in float32.  Ends before a barrier the
// caller makes.
__device__ __forceinline__ void row_inv_bf16(const Tile& t, int Kd, float eps,
                                             float* inv) {
  static_assert(kThreads == 4 * kBM, "row_inv_bf16: 4 threads per row");
  const int r = threadIdx.x >> 2, qq = threadIdx.x & 3;
  const float* row = t.A + static_cast<long long>(r) * t.lda;
  float ss = 0.0f;
#pragma unroll 8
  for (int c = 4 * qq; c < Kd; c += 16) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(row + c));
    ss = __fadd_rn(ss, __fmul_rn(v.x, v.x));
    ss = __fadd_rn(ss, __fmul_rn(v.y, v.y));
    ss = __fadd_rn(ss, __fmul_rn(v.z, v.z));
    ss = __fadd_rn(ss, __fmul_rn(v.w, v.w));
  }
  ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 1));
  ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 2));
  if (qq == 0) inv[r] = repro::rms_inv_from_sumsq<__nv_bfloat16>(ss, Kd, eps);
}

// ss += the squares of this thread's 8 elements of the slice's A tile:
// row tid / 4, columns 8 (tid % 4) + [0, 8).
__device__ __forceinline__ void slice_sumsq(const float* st, float& ss) {
  const float4* a = reinterpret_cast<const float4*>(
      st + (threadIdx.x >> 2) * kAS + 8 * (threadIdx.x & 3));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 v = a[i];
    ss = __fadd_rn(ss, __fmul_rn(v.x, v.x));
    ss = __fadd_rn(ss, __fmul_rn(v.y, v.y));
    ss = __fadd_rn(ss, __fmul_rn(v.z, v.z));
    ss = __fadd_rn(ss, __fmul_rn(v.w, v.w));
  }
}

// One product phase: M = batch x S rows by N columns, depth Kd, each
// tile cut into ``split`` items along the depth.  tile_of(m0, n0) gives
// the operands of a tile; pre(m0, n0) runs before its product (all
// threads; the block synchronises after it); epi(m, n, v) takes output
// pair (m, n), (m, n + 1) of the finished tile (v[nb] from B0 / B1).
template <bool NORM, bool DUAL, typename TileOf, typename Pre, typename Epi>
__device__ __forceinline__ void gemm_phase(const Params& p, float* smem,
                                           int N, int Kd, int split,
                                           TileOf tile_of, Pre pre, Epi epi) {
  static_assert(kThreads == 4 * kBM, "slice_sumsq: 4 threads per row");
  const int M = p.batch * p.seq, n_nt = N / kBN, tiles = M / kBM * n_nt;
  const int nsl = Kd / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp & 3, wn = warp >> 2;
  // the tile's row sums of squares (the inverse RMS in a bfloat16 trunk)
  float* sSS = smem + kUnionFloats;
  const bool bf16 = kBf16W && p.round_trunk;
  const bool stream_ss = NORM && !bf16;  // the norm folded into the epilogue
  __shared__ int s_last;
  for (int item = block_rank(smem); item < tiles * split;
       item += gridDim.x) {
    const int tile = item % tiles, s = item / tiles;
    const int m0 = tile / n_nt * kBM, n0 = tile % n_nt * kBN;
    Tile t = tile_of(m0, n0);
    t.sl0 = s * nsl / split;
    t.sl1 = (s + 1) * nsl / split;
    pre(m0, n0);
    __syncthreads();

    float acc[DUAL ? 2 : 1][2][4];
#pragma unroll
    for (int nb = 0; nb < (DUAL ? 2 : 1); ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][j][e] = 0.0f;
    float ss = 0.0f;

    const int n_sl = t.sl1 - t.sl0;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_sl) load_slice<DUAL>(smem + i * kStageFloats, t, t.sl0 + i);
      cp_async_commit();
    }
    // a bfloat16 trunk's norm: the rows' inverse RMS, while the first
    // slices' copies are in flight
    float inv0 = 1.0f, inv1 = 1.0f;
    if (NORM && bf16) {
      row_inv_bf16(t, Kd, p.w.norm_eps, sSS);
      __syncthreads();
      inv0 = sSS[wm * 16 + g];
      inv1 = sSS[wm * 16 + g + 8];
    }
    for (int i = 0; i < n_sl; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slice i landed; slice i - 1 is no longer read
      const int nx = i + kStages - 1;
      if (nx < n_sl)
        load_slice<DUAL>(smem + (nx % kStages) * kStageFloats, t, t.sl0 + nx);
      cp_async_commit();
      const float* st = smem + (i % kStages) * kStageFloats;
      if (stream_ss) slice_sumsq(st, ss);
      mma_slice<NORM, DUAL>(st, t, t.sl0 + i, bf16, inv0, inv1, acc);
    }
    cp_async_wait<0>();
    if (stream_ss) {  // the row's quarters, added pairwise: one per row
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 1));
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 2));
      if ((threadIdx.x & 3) == 0) sSS[threadIdx.x >> 2] = ss;
    }
    __syncthreads();
    // this thread's output rows: wm * 16 + g and + 8
    float ss_rows[2] = {0.0f, 0.0f};
    if (stream_ss) {
      ss_rows[0] = sSS[wm * 16 + g];
      ss_rows[1] = sSS[wm * 16 + g + 8];
    }

    // fragment element e of acc[.][j]: row g + 8 (e / 2), column 2 q + e % 2
    bool mine = true;
    if (split > 1) {  // DUAL phases are never split
      float* part = p.part + static_cast<long long>(s) * M * N;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = m0 + wm * 16 + g + 8 * hr,
                    n = n0 + wn * 16 + j * 8 + 2 * q;
          *reinterpret_cast<float2*>(part + static_cast<long long>(m) * N +
                                     n) =
              make_float2(acc[0][j][2 * hr], acc[0][j][2 * hr + 1]);
        }
      if (stream_ss && threadIdx.x < kBM)
        p.ssq[(static_cast<long long>(s) * tiles + tile) * kBM + threadIdx.x] =
            sSS[threadIdx.x];
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        s_last = atomicAdd(p.cnt + tile, 1) == split - 1;
        if (s_last) p.cnt[tile] = 0;  // for the next split phase
      }
      __syncthreads();
      mine = s_last;
      if (mine) {  // sum the partials in split order 0, 1, ...
        __threadfence();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const long long off =
                static_cast<long long>(m0 + wm * 16 + g + 8 * hr) * N + n0 +
                wn * 16 + j * 8 + 2 * q;
            float2 v = __ldcg(reinterpret_cast<const float2*>(p.part + off));
            for (int s2 = 1; s2 < split; ++s2) {
              const float2 u = __ldcg(reinterpret_cast<const float2*>(
                  p.part + static_cast<long long>(s2) * M * N + off));
              v.x = __fadd_rn(v.x, u.x);
              v.y = __fadd_rn(v.y, u.y);
            }
            acc[0][j][2 * hr] = v.x;
            acc[0][j][2 * hr + 1] = v.y;
          }
        if (stream_ss)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float* sp = p.ssq + static_cast<long long>(tile) * kBM +
                              wm * 16 + g + 8 * hr;
            float t_ss = __ldcg(sp);
            for (int s2 = 1; s2 < split; ++s2)
              t_ss = __fadd_rn(t_ss, __ldcg(sp + static_cast<long long>(s2) *
                                                     tiles * kBM));
            ss_rows[hr] = t_ss;
          }
      }
    }
    if (mine) {
      float inv[2] = {1.0f, 1.0f};
      if (stream_ss)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          inv[hr] = repro::rms_inv_from_sumsq<float>(ss_rows[hr], Kd,
                                                     p.w.norm_eps);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float2 v[DUAL ? 2 : 1];
#pragma unroll
          for (int nb = 0; nb < (DUAL ? 2 : 1); ++nb) {
            v[nb] = make_float2(acc[nb][j][2 * hr], acc[nb][j][2 * hr + 1]);
            if (stream_ss) {
              v[nb].x = __fmul_rn(v[nb].x, inv[hr]);
              v[nb].y = __fmul_rn(v[nb].y, inv[hr]);
            }
          }
          epi(m0 + wm * 16 + g + 8 * hr, n0 + wn * 16 + j * 8 + 2 * q, v);
        }
    }
    __syncthreads();  // the ring and sSS are reused by the next item
  }
}

// out[j] = sum_i in[i] w[i, c0 + j] for the 32 columns j of one row, by
// the whole block: warp w sums i = w, w + 8, ...; the eight partial sums
// are added in warp order.  Returns the sum on lanes of warp 0 (j =
// lane), 0 elsewhere; ends with a block barrier.  ``in`` is read through
// L2 (it may be an activation of this launch).
__device__ __forceinline__ float block_row_dot(const float* in, int n_in,
                                               const WT* __restrict__ w,
                                               int ldw, int c0, int n_out,
                                               float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = c0 + lane;
  float a = 0.0f;
  if (c < n_out)
#pragma unroll 8
    for (int i = warp; i < n_in; i += kWarps)
      a = fmaf(__ldcg(in + i), wload(w, static_cast<long long>(i) * ldw + c),
               a);
  red[warp * 32 + lane] = a;
  __syncthreads();
  float sum = 0.0f;
  if (warp == 0) {
    sum = red[lane];
    for (int k = 1; k < kWarps; ++k) sum = __fadd_rn(sum, red[k * 32 + lane]);
  }
  __syncthreads();
  return sum;
}

// ----------------------------------------------------------------- phases
// th[e] = silu(temb[e] @ time_w1) for every embedding of the launch; also
// clears the split-K counters and widens a bfloat16 state into xs.
__device__ __noinline__ void phase_time(const Params& p, float* smem) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < p.n_cnt; i += kThreads) p.cnt[i] = 0;
  if (p.state_bf16) {
    const long long n = static_cast<long long>(p.batch) * p.seq * p.w.latent;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         i < n; i += static_cast<long long>(gridDim.x) * kThreads)
      p.xs[i] = __bfloat162float(__ldg(p.xb + i));
  }
  const int T = p.w.time_dim, groups = (T + 31) / 32;
  float* red = smem + kUnionFloats + kBM;
  for (int item = blockIdx.x; item < p.n_emb * groups; item += gridDim.x) {
    const int e = item / groups, c0 = item % groups * 32;
    const float a = block_row_dot(p.temb + static_cast<long long>(e) * T, T,
                                  p.w.time_w1, T, c0, T, red);
    if (threadIdx.x < 32 && c0 + threadIdx.x < T)
      p.th[static_cast<long long>(e) * T + c0 + threadIdx.x] =
          rt(p, silu(rt(p, a)));
  }
}

// h = state @ w_in + th[e] @ time_w2; e is the step (B3) or, with
// per_slot, the tile's sample (B4).  The state is x at step 0, then out
// (a bfloat16 state: always its float32 copy xs).
__device__ __noinline__ void phase_w_in(const Params& p, float* smem,
                                        int step, bool per_slot) {
  const int d = p.w.d_model, L = p.w.latent, T = p.w.time_dim;
  const float* state = p.state_bf16 ? p.xs : step == 0 ? p.x : p.out;
  float* red = smem + kUnionFloats + kBM;
  float* tv = red + kWarps * 32;
  gemm_phase<false, false>(
      p, smem, d, L, 1,
      [&](int m0, int n0) {
        return Tile{state + static_cast<long long>(m0) * L, p.w.w_in + n0,
                    nullptr, L, d, 0, 0, nullptr};
      },
      [&](int m0, int n0) {
        const int e = per_slot ? m0 / p.seq : step;
        const float a = block_row_dot(p.th + static_cast<long long>(e) * T,
                                      T, p.w.time_w2, d, n0, d, red);
        if (threadIdx.x < 32) tv[threadIdx.x] = rt(p, a);
      },
      [&](int m, int n, const float2 (&v)[1]) {
        *reinterpret_cast<float2*>(p.h + static_cast<long long>(m) * d + n) =
            make_float2(rt(p, __fadd_rn(rt(p, v[0].x), tv[n % kBN])),
                        rt(p, __fadd_rn(rt(p, v[0].y), tv[n % kBN + 1])));
      });
}

struct NoPre {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// [q k v] = rmsnorm(h, attn_norm) @ [wq wk wv] into the (M, H*D + 2
// Hkv*D) qkv buffer.
__device__ __noinline__ void phase_qkv(const Params& p, float* smem,
                                       int layer) {
  const int d = p.w.d_model, hq = p.w.n_heads * p.w.head_dim,
            hkv = p.w.n_kv_heads * p.w.head_dim, nq = hq + 2 * hkv;
  const long long dd = d;
  const WT* wq = p.w.wq + layer * dd * hq;
  const WT* wk = p.w.wk + layer * dd * hkv;
  const WT* wv = p.w.wv + layer * dd * hkv;
  const WT* scale = p.w.attn_norm + layer * dd;
  gemm_phase<true, false>(
      p, smem, nq, d, 1,
      [&](int m0, int n0) {
        const float* A = p.h + static_cast<long long>(m0) * d;
        if (n0 < hq) return Tile{A, wq + n0, nullptr, d, hq, 0, 0, scale};
        if (n0 < hq + hkv)
          return Tile{A, wk + (n0 - hq), nullptr, d, hkv, 0, 0, scale};
        return Tile{A, wv + (n0 - hq - hkv), nullptr, d, hkv, 0, 0, scale};
      },
      NoPre{},
      [&](int m, int n, const float2 (&v)[1]) {
        *reinterpret_cast<float2*>(p.qkv + static_cast<long long>(m) * nq +
                                   n) = make_float2(rt(p, v[0].x),
                                                    rt(p, v[0].y));
      });
}

// h += a @ w (a: (M, Kd) activations), split-K: the attention output
// projection and the MLP's down projection.
__device__ __forceinline__ void residual_phase(const Params& p, float* smem,
                                               const float* a, int Kd,
                                               const WT* w, int split) {
  const int d = p.w.d_model;
  gemm_phase<false, false>(
      p, smem, d, Kd, split,
      [&](int m0, int n0) {
        return Tile{a + static_cast<long long>(m0) * Kd, w + n0, nullptr, Kd,
                    d, 0, 0, nullptr};
      },
      NoPre{},
      [&](int m, int n, const float2 (&v)[1]) {
        float2* hp =
            reinterpret_cast<float2*>(p.h + static_cast<long long>(m) * d + n);
        const float2 o = __ldcg(hp);
        *hp = make_float2(rt(p, __fadd_rn(o.x, rt(p, v[0].x))),
                          rt(p, __fadd_rn(o.y, rt(p, v[0].y))));
      });
}

__device__ __noinline__ void phase_wo(const Params& p, float* smem,
                                      int layer) {
  const int hq = p.w.n_heads * p.w.head_dim;
  residual_phase(p, smem, p.ao, hq,
                 p.w.wo + layer * static_cast<long long>(hq) * p.w.d_model,
                 p.split_wo);
}

__device__ __noinline__ void phase_down(const Params& p, float* smem,
                                        int layer) {
  const int dff = p.w.d_ff;
  residual_phase(p, smem, p.ff, dff,
                 p.w.w_down + layer * static_cast<long long>(dff) * p.w.d_model,
                 p.split_dn);
}

// ff = silu(xn @ w_gate) * (xn @ w_up), xn = rmsnorm(h, mlp_norm).
__device__ __noinline__ void phase_mlp(const Params& p, float* smem,
                                       int layer) {
  const int d = p.w.d_model, dff = p.w.d_ff;
  const long long dd = d;
  const WT* wg = p.w.w_gate + layer * dd * dff;
  const WT* wu = p.w.w_up + layer * dd * dff;
  const WT* scale = p.w.mlp_norm + layer * dd;
  gemm_phase<true, true>(
      p, smem, dff, d, 1,
      [&](int m0, int n0) {
        return Tile{p.h + static_cast<long long>(m0) * d, wg + n0, wu + n0, d,
                    dff, 0, 0, scale};
      },
      NoPre{},
      [&](int m, int n, const float2 (&v)[2]) {
        *reinterpret_cast<float2*>(p.ff + static_cast<long long>(m) * dff +
                                   n) =
            make_float2(
                rt(p, __fmul_rn(rt(p, silu(rt(p, v[0].x))), rt(p, v[1].x))),
                rt(p, __fmul_rn(rt(p, silu(rt(p, v[0].y))), rt(p, v[1].y))));
      });
}

// Rows [r0, r0 + n) of one head of the (M, nq) qkv buffer (src points at
// row r0), RoPE applied with the table's rows r0.. (the head dim splits into
// halves, [x1 c - x2 s, x2 c + x1 s], each product and sum rounded in a
// bfloat16 trunk, whose tables the launcher rounds) and multiplied by
// ``scale`` in float32, into dst with row stride HD + 1.
template <int HD>
__device__ __forceinline__ void load_roped(float* dst, const float* src,
                                           int nq, const Params& p, int r0,
                                           int n, float scale) {
  constexpr int half = HD / 2, QS = HD + 1, C4 = half / 4;
  for (int i = threadIdx.x; i < n * C4; i += kThreads) {
    const int r = i / C4, j = i % C4 * 4;
    const float4 c4 = __ldg(reinterpret_cast<const float4*>(
        p.rope_cos + (r0 + r) * half + j));
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(
        p.rope_sin + (r0 + r) * half + j));
    const float4 a = __ldcg(reinterpret_cast<const float4*>(src + r * nq + j));
    const float4 b =
        __ldcg(reinterpret_cast<const float4*>(src + r * nq + j + half));
    const float cs[4] = {c4.x, c4.y, c4.z, c4.w},
                sn[4] = {s4.x, s4.y, s4.z, s4.w};
    const float x1[4] = {a.x, a.y, a.z, a.w}, x2[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float* d = dst + r * QS + j + u;
      d[0] = __fmul_rn(rt(p, __fsub_rn(rt(p, __fmul_rn(x1[u], cs[u])),
                                       rt(p, __fmul_rn(x2[u], sn[u])))),
                       scale);
      d[half] = __fmul_rn(rt(p, __fadd_rn(rt(p, __fmul_rn(x2[u], cs[u])),
                                          rt(p, __fmul_rn(x1[u], sn[u])))),
                          scale);
    }
  }
}

// Rows [0, n) of one head's V (src at its first row) into dst, stride HD.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int nq, int n) {
  for (int i = threadIdx.x; i < n * HD / 4; i += kThreads) {
    const int r = i / (HD / 4), c = i % (HD / 4) * 4;
    *reinterpret_cast<float4*>(dst + r * HD + c) =
        __ldcg(reinterpret_cast<const float4*>(src + r * nq + c));
  }
}

// 'exact' scores of the thread's tile: q k^T / sqrt(D), as JAX divides them
// (in a bfloat16 trunk the product and the quotient are rounded).
template <int HD, int BK>
__device__ __forceinline__ void exact_scores(const Params& p, const float* sQ,
                                             const float* sK,
                                             float (&s)[kBQ / 16][BK / 16]) {
  repro::qk_scores<kBQ, BK, HD>(sQ, sK, s);
#pragma unroll
  for (int i = 0; i < kBQ / 16; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      s[i][j] = rt(p, __fdiv_rn(rt(p, s[i][j]), p.attn_div));
}

// acc[i][r] += sum_c sP[row i, c] sV[c, col r] for the thread's tile (the
// layout of pv_product), one FMA chain per element into acc: keeping one
// accumulator instead of pv_product's block sum beside it keeps the exact
// kernels within the register budget (no spills; as a separate block sum
// it spilled and slowed every phase of those kernels by ~10%).  From acc =
// 0 over one block it is pv_product's sum.
template <int BK, int HD>
__device__ __forceinline__ void pv_accumulate(const float* sP, const float* sV,
                                              float (&acc)[kBQ / 16][HD / 16]) {
  constexpr int RQ = kBQ / 16, RD = HD / 16, PS = BK + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    float v[RD];
#pragma unroll
    for (int r = 0; r < RD; ++r) v[r] = sV[c * HD + tx + 16 * r];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float pc = sP[(ty * RQ + i) * PS + c];
#pragma unroll
      for (int r = 0; r < RD; ++r) acc[i][r] = fmaf(pc, v[r], acc[i][r]);
    }
  }
}

// One item per (sample, q head, kBQ query rows q0..): q head h reads kv
// head h / G over the sample's S / BK K/V blocks; the result goes to
// columns h*D of rows q0.. of the (M, H*D) buffer.  FLASH scales q by
// 1/sqrt(D) after RoPE (streaming_attention_body) and runs the recurrence
// over the blocks.  'exact' takes the rows' max m and sum l over the
// blocks first (the recurrence's running pair: m the row max, l the sum of
// exp(s - m)), then writes p = exp(s - m) / l block by block and
// accumulates p v over the blocks; with one block (S = BK) that is the
// plain row softmax and the K block is not reloaded.
template <bool FLASH, int HD>
__device__ __noinline__ void attention_items(const Params& p, float* smem) {
  using T = AttnTiles<HD>;
  constexpr int BK = T::BK, RQ = kBQ / 16, RK = BK / 16, RD = HD / 16;
  const int H = p.w.n_heads, Hkv = p.w.n_kv_heads, G = H / Hkv, S = p.seq;
  const int hq = H * HD, nq = hq + 2 * Hkv * HD, nqb = S / kBQ, nkb = S / BK;
  float* sQ = smem + T::kQ;
  float* sK = smem + T::kK;
  float* sP = smem + T::kP;
  float* sV = smem + T::kV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int item = block_rank(smem); item < p.batch * H * nqb;
       item += gridDim.x) {
    const int qb = item % nqb, bh = item / nqb, b = bh / H, hh = bh % H,
              kvh = hh / G, q0 = qb * kBQ;
    const float* base = p.qkv + static_cast<long long>(b) * S * nq;
    const float* k = base + hq + kvh * HD;
    const float* v = base + hq + Hkv * HD + kvh * HD;
    float* out = p.ao + (static_cast<long long>(b) * S + q0) * hq + hh * HD;
    auto store = [&](int row, int col, float val) {
      out[row * hq + col] = rt(p, val);
    };
    load_roped<HD>(sQ, base + static_cast<long long>(q0) * nq + hh * HD, nq,
                   p, q0, kBQ, FLASH ? p.q_scale : 1.0f);
    if (FLASH) {
      repro::SoftmaxState<kBQ, HD> st;
      st.init();
      for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * BK;
        __syncthreads();  // the previous block is no longer read
        load_roped<HD>(sK, k + static_cast<long long>(k0) * nq, nq, p, k0,
                       BK, 1.0f);
        load_rows<HD>(sV, v + static_cast<long long>(k0) * nq, nq, BK);
        __syncthreads();
        repro::online_softmax_step<kBQ, BK, HD, false>(sQ, sK, sV, sP, st, q0,
                                                       k0);
      }
      repro::softmax_finish<kBQ, HD>(st, store);
    } else {
      float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        m[i] = repro::kNegBig;
        l[i] = 0.0f;
#pragma unroll
        for (int r = 0; r < RD; ++r) acc[i][r] = 0.0f;
      }
      for (int kb = 0; kb < nkb; ++kb) {  // pass 1: max and sum
        const int k0 = kb * BK;
        __syncthreads();
        load_roped<HD>(sK, k + static_cast<long long>(k0) * nq, nq, p, k0,
                       BK, 1.0f);
        __syncthreads();
        float s[RQ][RK];
        exact_scores<HD, BK>(p, sQ, sK, s);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          float mx = repro::kNegBig;
#pragma unroll
          for (int j = 0; j < RK; ++j) mx = fmaxf(mx, s[i][j]);
          const float m_new = fmaxf(m[i], repro::half_warp_max(mx));
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < RK; ++j) sum += expf(s[i][j] - m_new);
          l[i] = expf(m[i] - m_new) * l[i] + repro::half_warp_sum(sum);
          m[i] = m_new;
        }
      }
      for (int kb = 0; kb < nkb; ++kb) {  // pass 2: p, then p v
        const int k0 = kb * BK;
        __syncthreads();
        if (nkb > 1)
          load_roped<HD>(sK, k + static_cast<long long>(k0) * nq, nq, p, k0,
                         BK, 1.0f);
        load_rows<HD>(sV, v + static_cast<long long>(k0) * nq, nq, BK);
        __syncthreads();
        float s[RQ][RK];
        exact_scores<HD, BK>(p, sQ, sK, s);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RK; ++j)
            sP[(ty * RQ + i) * T::PS + tx + 16 * j] =
                rt(p, __fdiv_rn(expf(s[i][j] - m[i]), l[i]));
        __syncwarp();  // a half-warp reads back only the P rows it wrote
        pv_accumulate<BK, HD>(sP, sV, acc);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int r = 0; r < RD; ++r)
          store(ty * RQ + i, tx + 16 * r, acc[i][r]);
    }
    __syncthreads();  // shared memory is reused by the next item
  }
}

// The attention phase at the trunk's head dim (widths_ok admits these).
template <bool FLASH>
__device__ __forceinline__ void phase_attention(const Params& p,
                                                float* smem) {
  switch (p.w.head_dim) {
    case 16:
      attention_items<FLASH, 16>(p, smem);
      break;
    case 32:
      attention_items<FLASH, 32>(p, smem);
      break;
    case 64:
      attention_items<FLASH, 64>(p, smem);
      break;
    default:
      attention_items<FLASH, 128>(p, smem);
  }
}

// eps = rmsnorm(h, out_norm) @ w_out, split-K, then the update of the
// state elements the tile covers: element idx = m * L + n of the flat
// (batch, S, L) state.  B3 reads the step's coefficients, B4 (ROWS) the
// (R, 8) row idx / 256.  A bfloat16 state is read from xs, and the update
// (float32) is rounded to bfloat16 into out and xs.
template <bool CLIP, bool ROWS>
__device__ __noinline__ void phase_out(const Params& p, float* smem,
                                       int step) {
  const int d = p.w.d_model, L = p.w.latent;
  const float* prev = p.state_bf16 ? p.xs : step == 0 ? p.x : p.out;
  const bool from_input = step == 0 && !p.state_bf16;
  gemm_phase<true, false>(
      p, smem, L, d, p.split_out,
      [&](int m0, int n0) {
        return Tile{p.h + static_cast<long long>(m0) * d, p.w.w_out + n0,
                    nullptr, d, L, 0, 0, p.w.out_norm};
      },
      NoPre{},
      [&](int m, int n, const float2 (&v)[1]) {
        const long long idx = static_cast<long long>(m) * L + n;
        const float* cr =
            ROWS ? p.coefs + idx / kTileC * kRowCoefs : p.coefs + step * 5;
        const repro::Coefs c{__ldg(cr), __ldg(cr + 1), __ldg(cr + 2),
                             __ldg(cr + 3), __ldg(cr + 4)};
        const float2 x = from_input
                             ? __ldg(reinterpret_cast<const float2*>(prev + idx))
                             : __ldcg(reinterpret_cast<const float2*>(prev + idx));
        float x0;
        const float y0 =
            repro::update<CLIP, false>(x.x, rt(p, v[0].x), c, p.clip, &x0);
        const float y1 =
            repro::update<CLIP, false>(x.y, rt(p, v[0].y), c, p.clip, &x0);
        if (p.state_bf16) {
          const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
          *reinterpret_cast<__nv_bfloat162*>(p.outb + idx) = y;
          *reinterpret_cast<float2*>(p.xs + idx) = __bfloat1622float2(y);
        } else {
          *reinterpret_cast<float2*>(p.out + idx) = make_float2(y0, y1);
        }
      });
}

// Phase trace (off when p.trace is null): block 0 records %globaltimer
// (ns) at the start and after every phase, barrier included, so stamp i+1
// - stamp i is phase i as the grid saw it.  2 + steps (2 + 5 n_layers)
// stamps.
__device__ __forceinline__ void stamp(const Params& p, int& n) {
  if (p.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.trace[n] = t;
  }
  ++n;
}

// ROWS is the scheduler tick (B4): one step (K = 1), slot b's tiles read
// its own embedding, and state element i of slot b takes coefficient row
// b * rows_per_slot + i / 256 of the (R, 8) per-row block.
template <bool CLIP, bool FLASH, bool ROWS>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
megastep_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  int n = 0;
  stamp(p, n);
  if (threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    p.sm_of[blockIdx.x] = static_cast<int>(smid);
  }
  phase_time(p, smem);
  grid.sync();
  compute_rank(p, smem);
  stamp(p, n);
  const int steps = ROWS ? 1 : p.K;
  for (int step = 0; step < steps; ++step) {
    phase_w_in(p, smem, step, ROWS);
    grid.sync();
    stamp(p, n);
    for (int layer = 0; layer < p.w.n_layers; ++layer) {
      phase_qkv(p, smem, layer);
      grid.sync();
      stamp(p, n);
      phase_attention<FLASH>(p, smem);
      grid.sync();
      stamp(p, n);
      phase_wo(p, smem, layer);
      grid.sync();
      stamp(p, n);
      phase_mlp(p, smem, layer);
      grid.sync();
      stamp(p, n);
      phase_down(p, smem, layer);
      grid.sync();
      stamp(p, n);
    }
    phase_out<CLIP, ROWS>(p, smem, step);
    if (step + 1 < steps) grid.sync();
    stamp(p, n);
  }
}

// The geometry the kernel takes (mirrored by kernel._shape_limits): S a
// multiple of 64, D in {16, 32, 64, 128}, every product width a multiple
// of the 32-wide tiles (the q, k and v column ranges of the qkv product
// included), and a sample a whole number of 256-wide tile rows.
bool widths_ok(const ReproMegaWeights& w, int seq) {
  const int D = w.head_dim;
  return w.n_layers >= 0 && w.n_heads > 0 && w.n_kv_heads > 0 &&
         w.n_heads % w.n_kv_heads == 0 && seq >= kSeqMultiple &&
         seq % kSeqMultiple == 0 &&
         (D == 16 || D == 32 || D == 64 || D == 128) &&
         (w.n_heads * D) % kBN == 0 && (w.n_kv_heads * D) % kBN == 0 &&
         w.d_model % kBK == 0 && w.d_ff % kBK == 0 && w.latent % kBK == 0 &&
         w.latent <= 128 && w.time_dim % 4 == 0 &&
         (static_cast<long long>(seq) * w.latent) % kTileC == 0;
}

using Kernel = void (*)(Params);

Kernel pick(bool clip, bool flash, bool rows) {
  if (rows) {
    if (clip)
      return flash ? megastep_kernel<true, true, true>
                   : megastep_kernel<true, false, true>;
    return flash ? megastep_kernel<false, true, true>
                 : megastep_kernel<false, false, true>;
  }
  if (clip)
    return flash ? megastep_kernel<true, true, false>
                 : megastep_kernel<true, false, false>;
  return flash ? megastep_kernel<false, true, false>
               : megastep_kernel<false, false, false>;
}

// Blocks per SM and SM count of one instantiation on the current device:
// the shared-memory attribute is set and the occupancy queried once per
// device.  Refuses a device without cooperative launch.
cudaError_t residency(bool clip, bool flash, bool rows, int* per_sm,
                      int* sms) {
  static int cache[kMaxDevices][8][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int* c = cache[dev][(clip ? 4 : 0) + (flash ? 2 : 0) + (rows ? 1 : 0)];
  if (c[0] == 0) {
    int coop = 0, n_sm = 0, nb = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const Kernel k = pick(clip, flash, rows);
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, kThreads,
                                                        kSmemBytes);
    if (err != cudaSuccess) return err;
    if (nb < 1) return cudaErrorCooperativeLaunchTooLarge;
    c[1] = n_sm;
    c[0] = nb < kMaxBlocksPerSM ? nb : kMaxBlocksPerSM;
  }
  *per_sm = c[0];
  *sms = c[1];
  return cudaSuccess;
}

cudaError_t plan_for(const ReproMegaWeights& w, int batch, int seq,
                     bool clip, bool flash, bool rows, Plan* plan) {
  if (!widths_ok(w, seq) || batch < 1 || w.dtype != kWeightCode)
    return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const cudaError_t err = residency(clip, flash, rows, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  *plan = make_plan(w, batch, seq, per_sm, sms);
  return cudaSuccess;
}

// float32 v rounded to the nearest bfloat16 (ties to even), on the host.
float bf16_round_host(float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  memcpy(&v, &u, 4);
  return v;
}

int launch(const void* x, void* out, const ReproMegaWeights* w,
           const void* temb, const void* rope_cos, const void* rope_sin,
           const void* coefs, int K, int batch, int seq, int has_clip,
           float clip, int flash, int state_dtype, void* ws, void* trace,
           void* stream, bool rows) {
  if (K < 1 || w->dtype != kWeightCode || state_dtype < 0 || state_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  cudaError_t err = plan_for(*w, batch, seq, has_clip, flash, rows, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_emb = rows ? batch : K;
  const Layout l = layout(*w, batch, seq, n_emb, plan);
  float* base = static_cast<float*>(ws);
  Params p;
  p.w = *w;
  p.state_bf16 = state_dtype == 1;
  p.round_trunk = kBf16W && p.state_bf16;
  p.x = p.state_bf16 ? nullptr : static_cast<const float*>(x);
  p.out = p.state_bf16 ? nullptr : static_cast<float*>(out);
  p.xb = p.state_bf16 ? static_cast<const __nv_bfloat16*>(x) : nullptr;
  p.outb = p.state_bf16 ? static_cast<__nv_bfloat16*>(out) : nullptr;
  p.temb = static_cast<const float*>(temb);
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.coefs = static_cast<const float*>(coefs);
  p.K = K;
  p.batch = batch;
  p.seq = seq;
  p.n_emb = n_emb;
  p.n_cnt = static_cast<int>(l.n_cnt);
  p.clip = clip;
  // sqrtf is correctly rounded: jnp.sqrt(float32(D)) (in a bfloat16 trunk
  // the bfloat16 sqrt(D)); 1/sqrt(D) rounded from double, as the flash
  // trunk's Python-float scale
  p.attn_div = sqrtf(static_cast<float>(w->head_dim));
  if (p.round_trunk) p.attn_div = bf16_round_host(p.attn_div);
  p.q_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(w->head_dim)));
  p.h = base + l.h;
  p.qkv = base + l.qkv;
  p.ao = base + l.ao;
  p.ff = base + l.ff;
  p.th = base + l.th;
  p.part = base + l.part;
  p.ssq = base + l.ssq;
  p.xs = base + l.xs;
  p.cnt = reinterpret_cast<int*>(base + l.cnt);
  p.sm_of = reinterpret_cast<int*>(base + l.sm_of);
  p.split_wo = plan.split_wo;
  p.split_dn = plan.split_dn;
  p.split_out = plan.split_out;
  p.trace = static_cast<unsigned long long*>(trace);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pick(has_clip, flash, rows), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch plan of one instantiation on the current device, into out[8]:
// workspace floats (batch samples of seq tokens, n_emb embeddings), grid
// blocks, blocks per SM, grid barriers per step, dynamic shared memory
// bytes, and the split-K factors of wo, w_down and w_out.  Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue outside widths_ok).
int repro_megastep_plan(const ReproMegaWeights* w, int batch, int seq,
                        int n_emb, int rows, int has_clip, int flash,
                        long long* out) {
  Plan plan;
  const cudaError_t err =
      plan_for(*w, batch, seq, has_clip, flash, rows, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = layout(*w, batch, seq, n_emb, plan).total;
  out[1] = plan.grid;
  out[2] = plan.per_sm;
  out[3] = 2 + 5 * w->n_layers;
  out[4] = kSmemBytes;
  out[5] = plan.split_wo;
  out[6] = plan.split_dn;
  out[7] = plan.split_out;
  return 0;
}

// x, out: (batch * seq * latent / 256, 256) tile view, float32
// (state_dtype 0) or bfloat16 (1), sample b at flat offset b * seq *
// latent; w: weights of this library's type (w->dtype); temb: (K,
// time_dim) sinusoidal embeddings of the K timesteps, float32 holding
// values of the state's type; rope_cos / rope_sin: (seq, head_dim / 2),
// float32 (holding bfloat16 values in a bfloat16 trunk); coefs: (K, 5)
// rows [c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t]; ws: the plan's
// workspace floats (repro_megastep_plan with n_emb = K); trace: null, or 2
// + K (2 + 5 n_layers) uint64 for the phase stamps.  All device pointers,
// 16-byte aligned.  Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for weights of the other library's type).
int repro_megastep(const void* x, void* out, const ReproMegaWeights* w,
                   const void* temb, const void* rope_cos,
                   const void* rope_sin, const void* coefs, int K, int batch,
                   int seq, int has_clip, float clip, int flash,
                   int state_dtype, void* ws, void* trace, void* stream) {
  return launch(x, out, w, temb, rope_cos, rope_sin, coefs, K, batch, seq,
                has_clip, clip, flash, state_dtype, ws, trace, stream, false);
}

// One scheduler tick (B4, replaces megastep_rows_call of
// src/repro/kernels/megastep/kernel.py:269): as repro_megastep with K = 1,
// but temb is (batch, time_dim), one embedding per slot, coefs is the
// (R, 8) per-row block (sampler_step ops.expand_slot_coefs), R = batch *
// seq * latent / 256, and ws is the plan's with rows = 1, n_emb = batch.
int repro_megastep_rows(const void* x, void* out, const ReproMegaWeights* w,
                        const void* temb, const void* rope_cos,
                        const void* rope_sin, const void* row_coefs,
                        int batch, int seq, int has_clip, float clip,
                        int flash, int state_dtype, void* ws, void* trace,
                        void* stream) {
  return launch(x, out, w, temb, rope_cos, rope_sin, row_coefs, 1, batch,
                seq, has_clip, clip, flash, state_dtype, ws, trace, stream,
                true);
}

}  // extern "C"
