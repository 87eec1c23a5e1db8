// The sampler megakernels for Hopper (sm_90a), plain-C ABI: K consecutive
// plan steps, each the whole dense diffusion-LM eps trunk followed by the
// Eq. 12 update, in ONE launch (repro_megastep); or one continuous-batching
// scheduler tick, the trunk with a timestep per slot followed by the
// per-row update (repro_megastep_rows).  Both are one kernel template.
// This body is compiled once per weight type: megastep.cu (float32
// weights), megastep_bf16.cu (bfloat16 weights) and megastep_f16.cu
// (float16 weights) define REPRO_MEGA_WEIGHT and include it, and
// megastep_mixed.cu (REPRO_MEGA_MIXED: trees whose leaves are of more than
// one type) builds it once more; each of the four with 'exact' attention
// and the lockstep kernels (B3) only, beside its *_flash.cu, *_rows.cu and
// *_flash_rows.cu twins, so that the sixteen libraries build in parallel,
// 2 kernels each.
//
// Replaces the Pallas TPU kernels ``megastep_call`` (B3) and
// ``megastep_rows_call`` (B4) of src/repro/kernels/megastep/kernel.py:232
// and :269 (bodies ``_mega_kernel`` / ``_mega_rows_kernel``, ``eps_exact``
// / ``eps_flash``).  Per step and sample (float32 here; 16-bit below):
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
// Geometry (every one the TPU kernel admits): any seq_len S >= 1 whose
// sample is a whole number of 256-wide tile rows, any d_model, d_ff,
// latent and time_dim, and any even head dim D (widths_ok).
// A 64-row product tile may straddle samples (S 32, 80, 200) and may end
// past the batch's M = batch x S rows: every row of a tile finds its own
// sample (m / S), rows past M are copied as zeros and never stored.  Tile
// columns past a product's width and depth past its K are zero-filled the
// same way (cp.async with source size 0 where rows are whole 16-byte
// chunks, one element at a time where they are not), and a tile wholly
// inside with 16-byte rows takes the plain copies.  Attention pads each
// head to a width of 16, 32, 64, 96, 128 or 256 (columns past D are zero),
// masks the K/V rows of a ragged last block (past S) to -1e30 and stores no
// query row past S.  Past 256 (attention_wide) it streams q k^T over the
// head in chunks of 64 columns and p v in output chunks of 64 (the score
// rows in shared memory up to kWideRowsMaxS tokens, else the running sums
// in the item's own rows of the attention output buffer).  The aligned geometry (``aligned``: S a multiple of
// 64, D 16, 32, 64 or 128, every product width a multiple of 32) runs its
// own instantiation of each phase, with none of these checks: run there,
// the general phases take 11% longer (bound_probe.py's ``general``
// variant, a B4 tick on an H100 80GB HBM3 at 700 W).  Only the phases
// are instantiated twice (and attention per width), so the build stays
// at 8 kernels.
// sqrt(D) and 1/sqrt(D) of the true D are the float32 values JAX's exact
// and flash trunks use, computed by the launcher.
//
// bfloat16 and float16 (the TPU kernel's dtype rules, kernel.py:152-155,
// :171-174).  The state is float32, bfloat16 or float16 (a runtime
// switch): a 16-bit state is widened into a float32 copy in the workspace
// as the launch starts, and every step's update (float32) is rounded to
// the state's type before it is stored.  The weights are all float32, all
// bfloat16 or all float16 (REPRO_MEGA_WEIGHT): 16-bit weight slices are
// copied as they are (cp.async, half of each stage's B area) and widened
// as the product reads its fragments (same ring, same shared memory, same
// 2 blocks per SM).  The trunk computes in the promotion of the two types,
// as jnp does: float32 unless both are of one 16-bit type (float16 with
// bfloat16 promotes to float32).  The mixed library reads each leaf at its
// own type (a type code per pointer, ReproMegaWeights::leaf) and rounds
// every value at the type JAX's promotion gives it, site by site
// (ReproMegaWeights::site: the wrapper replays the promotion on the leaf
// types); it runs the three 3xTF32 passes of every product (those of a
// 16-bit operand add zeros: its TF32 remainder is 0) and only the general
// phases.  Then (``round_trunk``) every value that
// JAX's op sequence makes in that type is rounded there, bfloat16 or
// float16 alike: each product's output (summed in
// float32), the norms' inverse RMS, x * inv and * scale (so the norm is
// applied to the A fragments before the product, from a row sum of
// squares taken first, and not in the epilogue), the time MLP's silu, the
// RoPE products and sums (on cos / sin of the type), exact attention's
// scores and probabilities (divided by sqrt(D) of the type), the
// attention output, SwiGLU's silu and product, the residual adds and eps.
// Every A operand then holds values of the 16-bit type and every B
// operand too, which are exact in TF32 (a float16 has 11 significant
// bits and, subnormals included, lies inside TF32's exponent range): one
// mma.sync pass per product is exact, and the two 3xTF32 correction
// passes are skipped (16-bit weights also skip the pass of B's remainder,
// which is 0, under a float32 trunk).  Nothing is clamped: where JAX's
// float16 overflows to inf, the kernel's rounding does too.
//
// Bound on the H100: operations.  One step at smollm width (d 576, 9 / 3
// heads of 64, d_ff 1536, 2 layers), batch 4, 64 tokens is ~3.7 GFLOP
// (2 x 256 tokens x 7.11 M eps-path weights, plus attention), so an
// 8-step launch is ~30 GFLOP, ~0.44 ms at the H100's 67 TFLOP/s float32
// data-sheet rate; reading the 29.3 MB of weights once takes ~9 us at its
// 3.35 TB/s.  A scheduler tick is one such step, ~56 us at 67 TFLOP/s.
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
//         for B3, one per slot for B4), once per launch; in the general
//         geometry then tw = th @ time_w2 (a second barrier)
//   w_in  h = x @ w_in + th[e] @ time_w2: 64 x 32 output tiles; e is the
//         step, or B4's slot m / S.  An aligned tile lies in one sample and
//         its block computes its 32 columns of th @ time_w2 itself; in the
//         general geometry row m adds row e of tw
//   per layer:
//   qkv   [q k v] = rmsnorm(h) @ [wq wk wv] (one product, N = H*D +
//         2 Hkv*D; the tiles of q, k and v are counted apart, so none
//         straddles two of them)
//   attn  one item per (sample, q head, block of 32 query rows) on kv head
//         h / (H / Hkv), looping over the sample's K/V blocks of 64 rows
//         (32 at width 128, 16 past it, so that the tiles fit the product
//         ring's shared memory and two blocks stay resident per SM); RoPE
//         is applied to q and k as they are loaded, at their own positions.
//         'flash' runs the online-softmax recurrence over the blocks;
//         'exact' takes two passes, the rows' max and sum first, then p =
//         exp(s - max) / sum and p v block by block (one pass where S is
//         one block: then it is the plain row softmax)
//   wo    h += attn @ wo, split-K
//   mlp   ff = silu(rmsnorm(h) @ w_gate) * (rmsnorm(h) @ w_up), both
//         products in one item
//   down  h += ff @ w_down, split-K
//   out   eps = rmsnorm(h) @ w_out, split-K, with the Eq. 12 update fused
//         into the epilogue: a 64 x 32 tile of eps is a run of the
//         sample's state elements, so element i of sample b takes its
//         coefficients (B4: row b * rows_per_slot + i / 256) and x in place
// That is 2 + 5 n_layers grid barriers per step (12 at 2 layers), one more
// per launch for the time MLP (two in the general geometry) and one fewer
// after the last step.  A normed product computes rmsnorm(h) @ W as
// inv[row] * ((h * scale) @ W): the A fragments are multiplied by the
// norm's scale as they are read, each row's sum of squares is taken from
// the A slices as they stream through shared memory, and the epilogue
// multiplies by the inverse RMS
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
#include <cuda_fp16.h>
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
#error "define REPRO_MEGA_WEIGHT (float, __nv_bfloat16 or __half) first"
#endif
#ifndef REPRO_MEGA_MIXED
#define REPRO_MEGA_MIXED 0
#endif
// REPRO_MEGA_FLASH 0 builds the 'exact' kernels only, 1 the 'flash' ones
// only, and REPRO_MEGA_ROWS 0 the lockstep kernels (B3) only, 1 the
// scheduler tick's (B4) only: each library is built as four sources
// (megastep*{,_flash}{,_rows}.cu, two kernels each), so that the build,
// whose time is its CPU seconds over the cores, spreads evenly over them.
// Left undefined, both.
#ifndef REPRO_MEGA_FLASH
#define REPRO_MEGA_FLASH -1
#endif
#ifndef REPRO_MEGA_ROWS
#define REPRO_MEGA_ROWS -1
#endif

// The rounding sites of a mixed tree (ReproMegaWeights::site): the type
// JAX gives each value, as a code (0 float32: none, 1 bfloat16, 2
// float16).  Seven for the launch, then two rows of kLayerSites (layer 0,
// and every later layer: a layer that turns h into float32 leaves it
// there).  Mirrored by ../kernel.py (_GLOBAL_SITES, _LAYER_SITES).
enum ReproMegaSite {
  kSiteT1,   // temb @ time_w1 and its silu
  kSiteT2,   // th @ time_w2
  kSiteIn,   // state @ w_in
  kSiteH0,   // h = state @ w_in + time embedding
  kSiteHL,   // h entering the out norm
  kSiteXO,   // rmsnorm(h, out_norm)
  kSiteEps,  // eps = xo @ w_out
  kGlobalSites
};
enum ReproMegaLayerSite {
  kSiteH,    // h entering the layer
  kSiteXA,   // rmsnorm(h, attn_norm)
  kSiteQ,    // q (and its RoPE, and exact attention's probabilities)
  kSiteK,    // k (and its RoPE)
  kSiteV,    // v
  kSiteQK,   // exact attention's scores
  kSitePV,   // exact attention's output
  kSiteWO,   // attention output @ wo
  kSiteH1,   // h after the attention residual
  kSiteXM,   // rmsnorm(h, mlp_norm)
  kSiteG,    // xm @ w_gate and its silu
  kSiteU,    // xm @ w_up
  kSiteGU,   // silu(g) * u
  kSiteD,    // gu @ w_down
  kSiteH2,   // h after the MLP residual
  kLayerSites
};
constexpr int kMegaLeaves = 14;
constexpr int kMegaSites = kGlobalSites + 2 * kLayerSites;

// Device pointers of the eps-path weights (stacked (n_layers, ...) leaves,
// (in, out) layouts as the JAX pytree), all of this library's weight type,
// and the trunk's widths.  The layout is mirrored by ctypes in
// ../kernel.py; ``dtype`` names the weight type (0 float32, 1 bfloat16, 2
// float16, 3 mixed), and a launch refuses weights of another library's
// type.  The mixed library reads ``leaf`` (each pointer's type code, in
// pointer order), ``site`` (ReproMegaSite) and ``attn_div`` (sqrt(D) as
// exact attention divides by it: in q's type, layer 0 and later); the
// uniform libraries ignore them.
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
  int leaf[kMegaLeaves];
  int site[kMegaSites];
  float attn_div[2];
};

namespace {

namespace cg = cooperative_groups;
using repro::cp_async16;
using repro::cp_async16_zfill;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::kAttnThreads;
using repro::mma_tf32;
using repro::to_tf32;
using WT = REPRO_MEGA_WEIGHT;  // the weights' type
constexpr bool kBf16W = std::is_same<WT, __nv_bfloat16>::value;
constexpr bool kF16W = std::is_same<WT, __half>::value;
constexpr bool k16W = kBf16W || kF16W;  // 16-bit weights
constexpr bool kMixed = REPRO_MEGA_MIXED;  // leaves of any of the types
static_assert(k16W || std::is_same<WT, float>::value,
              "weights are float32, bfloat16 or float16");
static_assert(!kMixed || std::is_same<WT, float>::value,
              "the mixed library stages weights as float32 does");
constexpr int kWeightCode = kMixed ? 3 : kBf16W ? 1 : kF16W ? 2 : 0;

constexpr int kThreads = kAttnThreads;  // 256: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;      // the widest one-pass attention tile
constexpr int kBQ = 32;                 // query rows of an attention item
constexpr int kBM = 64;                 // rows of a product tile
constexpr int kBN = 32;                 // columns of a product tile
constexpr int kBK = 32;                 // depth of a staged slice
constexpr int kStages = 4;              // cp.async ring
constexpr int kAS = kBK + 4;            // A slice row stride: conflict-free
constexpr int kBS = kBN + 8;            // B slice row stride: conflict-free
constexpr int kAStage = kBM * kAS;
constexpr int kBStage = kBK * kBS;
// 16-bit weights stay 16-bit in the ring, in the first half of each B
// area, rows of kBSh (conflict-free fragment reads, 16-byte rows)
constexpr int kBSh = kBN + 8;
static_assert(kBK * kBSh * 2 <= kBStage * 4, "16-bit B fits its area");
constexpr int kStageFloats = kAStage + 2 * kBStage;  // A, B (and B2)
constexpr int kGemmFloats = kStages * kStageFloats;
constexpr int kWVec = 16 / static_cast<int>(sizeof(WT));  // weights a chunk

// The attention tiles of padded head width HD in the union area: sQ (kBQ,
// HD), sK (BK, HD) with +1 pads, sP (kBQ, BK) +1, sV (BK, HD) 16-byte
// aligned.
template <int HD>
struct AttnTiles {
  static constexpr int BK = HD > 128 ? 16 : HD == 128 ? 32 : 64;  // K/V rows
  static constexpr int QS = HD + 1, PS = BK + 1;
  static constexpr int kQ = 0, kK = kQ + kBQ * QS, kP = kK + BK * QS;
  static constexpr int kV = (kP + kBQ * PS + 3) / 4 * 4;
  static constexpr int kFloats = kV + BK * HD;
};
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kAttnFloats =
    cmax(cmax(cmax(AttnTiles<16>::kFloats, AttnTiles<32>::kFloats),
              cmax(AttnTiles<64>::kFloats, AttnTiles<96>::kFloats)),
         cmax(AttnTiles<128>::kFloats, AttnTiles<kMaxHeadDim>::kFloats));
static_assert(kAttnFloats <= kGemmFloats,
              "the attention tiles must not grow shared memory past the "
              "product ring: two blocks per SM");
// attention_wide's tiles (head dims past kMaxHeadDim): a depth chunk of q
// (kBQ, kWideDepth) and of K (kWideBK, kWideDepth) with +1 pads, sP
// (kBQ, kWideBK) +1, and an output chunk of V (kWideBK, kWideOut).
constexpr int kWideBK = 32, kWideDepth = 64, kWideOut = 64;
struct WideTiles {
  static constexpr int QS = kWideDepth + 1, PS = kWideBK + 1;
  static constexpr int kQ = 0, kK = kQ + kBQ * QS, kP = kK + kWideBK * QS;
  static constexpr int kV = (kP + kBQ * PS + 3) / 4 * 4;
  static constexpr int kFloats = kV + kWideBK * kWideOut;
};
static_assert(WideTiles::kFloats <= kGemmFloats,
              "attention_wide's tiles fit the product ring's area");
// Up to kWideRowsMaxS tokens a sample (a whole number of K/V blocks),
// attention_wide keeps an item's score rows (kBQ, +1 pad) beside those
// tiles.
constexpr int kWideRowsMaxS =
    ((kGemmFloats - WideTiles::kFloats) / kBQ - 1) / kWideBK * kWideBK;
static_assert(kWideRowsMaxS >= 64 &&
                  WideTiles::kFloats + kBQ * (kWideRowsMaxS + 1) <=
                      kGemmFloats,
              "the score rows of a 64-token sample fit");
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
  const float* x;             // a float32 state (null for 16-bit)
  float* out;
  const void* x16;            // a 16-bit state (null for float32)
  void* out16;
  int state16;                // a 16-bit state's type code (1 bfloat16,
                              // 2 float16), else 0
  int round_trunk;            // the trunk is the weights' 16-bit type (the
                              // state of that type too): round as JAX's
                              // ops do
  const float* temb;
  const float* rope_cos;
  const float* rope_sin;
  const float* coefs;
  int K, batch, seq, n_emb, n_cnt;
  int general;     // not the aligned geometry: the phases' G instantiation
  float clip;
  float attn_div;  // sqrt(D) in float32: 'exact' divides the scores by it
  float q_scale;   // 1/sqrt(D) in float32: 'flash' multiplies q by it
  float *h, *qkv, *ao, *ff, *th, *part, *ssq;
  float* tw;  // th @ time_w2, (n_emb, d_model)
  float* xs;  // a 16-bit state widened to float32, updated every step
  int* cnt;
  int* sm_of;  // the SM of each block
  int split_wo, split_dn, split_out;
  unsigned long long* trace;  // null, or one stamp per phase boundary
};

struct Plan {
  int grid, per_sm, split_wo, split_dn, split_out;
};

struct Layout {
  long long h, qkv, ao, ff, th, tw, part, ssq, xs, cnt, n_cnt, sm_of, total;
};

long long round4(long long n) { return (n + 3) / 4 * 4; }

// Tiles (or depth slices) of width w: the last one may be partial.
__host__ __device__ __forceinline__ int cdiv(int w, int t) {
  return (w + t - 1) / t;
}

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
  const int mt = cdiv(batch * seq, kBM);
  p.split_wo = split_for(mt * cdiv(w.d_model, kBN),
                         cdiv(w.n_heads * w.head_dim, kBK), p.grid);
  p.split_dn =
      split_for(mt * cdiv(w.d_model, kBN), cdiv(w.d_ff, kBK), p.grid);
  p.split_out =
      split_for(mt * cdiv(w.latent, kBN), cdiv(w.d_model, kBK), p.grid);
  return p;
}

// Workspace offsets in floats (each a multiple of 4: 16-byte aligned).
Layout layout(const ReproMegaWeights& w, int batch, int seq, int n_emb,
              const Plan& p) {
  const long long M = static_cast<long long>(batch) * seq,
                  d = w.d_model, hq = w.n_heads * w.head_dim,
                  hkv = w.n_kv_heads * w.head_dim, L = w.latent;
  const long long mt = cdiv(batch * seq, kBM),
                  nt = cdiv(w.d_model > w.latent ? w.d_model : w.latent, kBN);
  long long part = p.split_wo * M * d;
  if (p.split_dn * M * d > part) part = p.split_dn * M * d;
  if (p.split_out * M * L > part) part = p.split_out * M * L;
  Layout l;
  long long o = 0;
  l.h = o;
  o += round4(M * d);
  l.qkv = o;
  o += round4(M * (hq + 2 * hkv));
  l.ao = o;
  o += round4(M * hq);
  l.ff = o;
  o += round4(M * w.d_ff);
  l.th = o;
  o += round4(static_cast<long long>(n_emb) * w.time_dim);
  l.part = o;  // split-K partial tiles
  o += round4(part);
  l.ssq = o;  // row sums of squares of the split w_out items
  o += p.split_out * mt * cdiv(w.latent, kBN) * kBM;
  l.xs = o;  // the state in float32 (16-bit states)
  o += round4(M * L);
  l.cnt = o;  // arrival counters of split tiles
  l.n_cnt = mt * nt;
  o += round4(l.n_cnt);
  l.sm_of = o;
  o += round4(p.grid);
  // th @ time_w2 of the general geometry, last: no offset of a buffer of
  // the aligned geometry depends on it
  l.tw = o;
  o += round4(static_cast<long long>(n_emb) * d);
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

// v rounded to the nearest float16 (ties to even; past the largest
// finite float16, inf), as a float32.
__device__ __forceinline__ float f16_round(float v) {
  return __half2float(__float2half_rn(v));
}

// v rounded to the weights' 16-bit type.
__device__ __forceinline__ float r16(float v) {
  if constexpr (kF16W) return f16_round(v);
  return bf16_round(v);
}

// v as the trunk's type holds it: rounded to the weights' 16-bit type in
// a 16-bit trunk (only the 16-bit-weight libraries have one), else v.
__device__ __forceinline__ float rt(const Params& p, float v) {
  if constexpr (k16W) return p.round_trunk ? r16(v) : v;
  return v;
}

// The float32 bits of a 16-bit weight's bits w: a bfloat16's are its
// float32's top half; a float16 is converted (exactly).
__device__ __forceinline__ uint32_t widen16(uint16_t w) {
  if constexpr (kF16W)
    return __float_as_uint(__half2float(__ushort_as_half(w)));
  return static_cast<uint32_t>(w) << 16;
}

// A weight leaf: the typed pointer, or in the mixed library the address
// and the leaf's type code (0 float32, 1 bfloat16, 2 float16).  wadd(w,
// n) is n elements on, wload(w, i) weight i widened to float32, WLEAF the
// leaf of a ReproMegaWeights pointer field and WNONE no leaf.
#if REPRO_MEGA_MIXED
struct WPtr {
  const char* a;
  int code;
};
__device__ __forceinline__ WPtr wadd(WPtr w, long long n) {
  return WPtr{w.a + (w.code ? 2 * n : 4 * n), w.code};
}
__device__ __forceinline__ float wload(WPtr w, long long i) {
  if (w.code == 0) return __ldg(reinterpret_cast<const float*>(w.a) + i);
  const unsigned short h =
      __ldg(reinterpret_cast<const unsigned short*>(w.a) + i);
  return w.code == 1 ? __uint_as_float(static_cast<uint32_t>(h) << 16)
                     : __half2float(__ushort_as_half(h));
}
#define WLEAF(p, field, i) \
  (WPtr{reinterpret_cast<const char*>((p).w.field), (p).w.leaf[i]})
#define WNONE (WPtr{nullptr, 0})
#else
using WPtr = const WT*;
__device__ __forceinline__ WPtr wadd(WPtr w, long long n) { return w + n; }
__device__ __forceinline__ float wload(WPtr w, long long i) {
  return repro::to_f32(__ldg(w + i));
}
#define WLEAF(p, field, i) ((p).w.field)
#define WNONE nullptr
#endif
// The leaves' indices in pointer order (kernel.py _POINTERS).
enum {
  kLeafWIn, kLeafTimeW1, kLeafTimeW2, kLeafOutNorm, kLeafWOut,
  kLeafAttnNorm, kLeafMlpNorm, kLeafWq, kLeafWk, kLeafWv, kLeafWo,
  kLeafWGate, kLeafWUp, kLeafWDown
};

// v rounded to the type of code (0: as it is).
__device__ __forceinline__ float round_code(int code, float v) {
  return code == 1 ? bf16_round(v) : code == 2 ? f16_round(v) : v;
}

// v as JAX's trunk holds the value of a site: in the mixed library rounded
// to the site's type (``code``, ReproMegaWeights::site); in the uniform
// ones rt(p, v), whatever the code.
__device__ __forceinline__ float rc(const Params& p, int code, float v) {
  if constexpr (kMixed) return round_code(code, v);
  return rt(p, v);
}

// The code of a launch site, and of a layer's (layer 0's row, or the row
// of every later layer).
__device__ __forceinline__ int gsite(const Params& p, int site) {
  return p.w.site[site];
}
__device__ __forceinline__ int lsite(const Params& p, int layer, int site) {
  return p.w.site[kGlobalSites + (layer > 0 ? kLayerSites : 0) + site];
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
// row-major (M, kd) activation; B0 / B1 at row 0, column c of a row-major
// (kd, ldb) weight.  Of the tile, ``rows`` rows and ``cols`` columns are
// inside the product (the rest is copied as zeros and never stored), and
// its column 0 is column ``n`` of the output buffer.  ``fast``: the tile
// is whole, kd is a whole number of slices and every row of A and B is a
// whole number of 16-byte chunks, so the plain copies serve.  NORM
// computes rmsnorm(A) @ B as inv[row] * ((A * scale[k]) @ B): the
// fragments of A are multiplied by the norm's scale as they are read, each
// row's sum of squares is taken from the slices as they stream through
// shared memory, and the epilogue multiplies by the inverse RMS (equal in
// exact arithmetic to scaling A).
// In a 16-bit trunk NORM takes the norm's own op order instead: the
// rows' inverse RMS first (row_inv16), then each A element as
// T(T(a * inv) * scale), T the trunk's type, and no epilogue factor.
// In the mixed library a NORM tile also carries the codes of h's type
// (nh: the inverse RMS and x * inv are rounded to it; 0 folds the norm
// into the epilogue, as a float32 trunk does) and of the normed value's
// (nx: * scale is rounded to it).
struct Tile {
  const float* A;
  WPtr B0;
  WPtr B1;
  int ldb, n, cols;
  WPtr scale;
  int kd, rows, sl0, sl1;
  bool fast;
#if REPRO_MEGA_MIXED
  int nh, nx;
#endif
};

// A tile of B0 (and B1) at column c of a (kd, ldb) weight, whose column 0
// lands on output column n; gemm_phase sets the rest.
__device__ __forceinline__ Tile make_tile(const float* A, WPtr B0, WPtr B1,
                                          int ldb, int c, int n,
                                          WPtr scale) {
  Tile t;
  t.A = A;
  t.B0 = wadd(B0, c);
#if REPRO_MEGA_MIXED
  t.B1 = wadd(B1, c);
#else
  t.B1 = B1 == nullptr ? nullptr : B1 + c;
#endif
  t.ldb = ldb;
  t.n = n;
  t.cols = ldb - c < kBN ? ldb - c : kBN;
  t.scale = scale;
  return t;
}

// The mixed library's B copies (of nb weights: B0, B1) of slice depth k
// (kn rows inside the product), each at its leaf's type: a float32 leaf
// as the float32 library stages it, a 16-bit one as the 16-bit libraries
// do (in the first half of its B area, rows of kBSh), to be widened as
// the fragments are read (bfrag).  16-byte chunks where the leaf's rows
// are whole chunks, else one element at a time.
#if REPRO_MEGA_MIXED
template <int nb>
__device__ __forceinline__ void load_b_edge_mixed(float* st, const Tile& t,
                                                  int k, int kn) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int b = 0; b < nb; ++b) {
    const WPtr B = b ? t.B1 : t.B0;
    float* dst = st + kAStage + b * kBStage;
    const int vw = B.code ? 8 : 4;  // elements of a 16-byte chunk
    if (t.ldb % vw == 0) {
      const int per_row = kBN / vw;
      for (int c = tid; c < kBK * per_row; c += kThreads) {
        const int r = c / per_row, q = c % per_row;
        const bool ok = r < kn && vw * q < t.cols;
        void* d = B.code ? static_cast<void*>(reinterpret_cast<uint16_t*>(dst) +
                                              r * kBSh + vw * q)
                         : static_cast<void*>(dst + r * kBS + vw * q);
        cp_async16_zfill(
            d, ok ? wadd(B, static_cast<long long>(k + r) * t.ldb + vw * q).a
                  : B.a,
            ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int r = e / kBN, c = e % kBN;
        const bool ok = r < kn && c < t.cols;
        const long long off = static_cast<long long>(k + r) * t.ldb + c;
        if (B.code)
          reinterpret_cast<uint16_t*>(dst)[r * kBSh + c] =
              ok ? __ldg(reinterpret_cast<const unsigned short*>(B.a) + off)
                 : 0;
        else
          dst[r * kBS + c] =
              ok ? __ldg(reinterpret_cast<const float*>(B.a) + off) : 0.0f;
      }
    }
  }
}
#endif

// Elements of a 16-byte chunk of the tile's weights: the library's type,
// or in the mixed library the narrowest leaf's (a tile is ``fast`` only
// where every weight row is whole chunks of its own type).
__device__ __forceinline__ int bvec(const Tile& t) {
#if REPRO_MEGA_MIXED
  return (t.B0.code | t.B1.code) ? 8 : 4;
#else
  return kWVec;
#endif
}

// The copies of slice sl of a tile that is not ``fast``: A rows past
// ``rows``, B columns past ``cols`` and depth past kd zero.  Rows that are
// whole 16-byte chunks take cp.async, a chunk past the product's edge
// with source size 0; other rows are copied one element at a time (the
// stores land before the ring's next barrier, as the copies do).
template <bool DUAL>
__device__ __noinline__ void load_slice_edge(float* st, const Tile& t,
                                             int sl) {
  const int tid = threadIdx.x, k = sl * kBK;
  const int kn = t.kd - k < kBK ? t.kd - k : kBK;  // depth in the product
  if ((t.kd & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 64 rows x 8 chunks of 16 bytes
      const int c = tid + i * kThreads, r = c >> 3, q = c & 7;
      const bool ok = r < t.rows && 4 * q < kn;
      cp_async16_zfill(
          st + r * kAS + 4 * q,
          ok ? t.A + static_cast<long long>(r) * t.kd + k + 4 * q : t.A,
          ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      st[r * kAS + c] =
          r < t.rows && c < kn
              ? __ldcg(t.A + static_cast<long long>(r) * t.kd + k + c)
              : 0.0f;
    }
  }
  constexpr int nb = DUAL ? 2 : 1;
#if REPRO_MEGA_MIXED
  load_b_edge_mixed<nb>(st, t, k, kn);
#else
  if (t.ldb % kWVec == 0) {
    constexpr int per_row = kBN / kWVec;  // chunks of a B row
    for (int c = tid; c < nb * kBK * per_row; c += kThreads) {
      const int b = c / (kBK * per_row), r = c % (kBK * per_row) / per_row,
                q = c % per_row;
      const WPtr B = b ? t.B1 : t.B0;
      const bool ok = r < kn && kWVec * q < t.cols;
      float* dst = st + kAStage + b * kBStage;
      void* d = k16W ? static_cast<void*>(reinterpret_cast<uint16_t*>(dst) +
                                            r * kBSh + kWVec * q)
                       : static_cast<void*>(dst + r * kBS + kWVec * q);
      cp_async16_zfill(
          d, ok ? B + static_cast<long long>(k + r) * t.ldb + kWVec * q : B,
          ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < nb * kBK * kBN; e += kThreads) {
      const int b = e / (kBK * kBN), r = e % (kBK * kBN) / kBN, c = e % kBN;
      const WPtr B = b ? t.B1 : t.B0;
      const bool ok = r < kn && c < t.cols;
      float* dst = st + kAStage + b * kBStage;
      const long long off = static_cast<long long>(k + r) * t.ldb + c;
      if constexpr (k16W) {
        reinterpret_cast<uint16_t*>(dst)[r * kBSh + c] =
            ok ? __ldg(reinterpret_cast<const unsigned short*>(B) + off) : 0;
      } else {
        dst[r * kBS + c] = ok ? repro::to_f32(__ldg(B + off)) : 0.0f;
      }
    }
  }
#endif
}

// The copies of slice sl into stage st by cp.async: A, and B as stored
// (16-bit weights stay 16-bit and are widened as the fragments are read:
// the same ring, the same copies in flight).  G: the general
// geometry, whose tiles may not be ``fast``.
template <bool DUAL, bool G>
__device__ __forceinline__ void load_slice(float* st, const Tile& t,
                                           int sl) {
  if (G && !t.fast) {
    load_slice_edge<DUAL>(st, t, sl);
    return;
  }
  const int tid = threadIdx.x, k = sl * kBK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 64 rows x 8 chunks of 16 bytes
    const int c = tid + i * kThreads, r = c >> 3, q = c & 7;
    cp_async16(st + r * kAS + 4 * q,
               t.A + static_cast<long long>(r) * t.kd + k + 4 * q);
  }
#if REPRO_MEGA_MIXED
  {  // each B as its leaf's library stages it
#pragma unroll
    for (int b = 0; b < (DUAL ? 2 : 1); ++b) {
      const WPtr B = b ? t.B1 : t.B0;
      float* dst = st + kAStage + b * kBStage;
      if (B.code == 0) {
        const int r = tid >> 3, q = tid & 7;  // 32 rows x 8 chunks
        cp_async16(dst + r * kBS + 4 * q,
                   wadd(B, static_cast<long long>(k + r) * t.ldb + 4 * q).a);
      } else if (tid < 128) {  // 32 rows x 4 chunks of 8
        const int r = tid >> 2, q = tid & 3;
        cp_async16(reinterpret_cast<uint16_t*>(dst) + r * kBSh + 8 * q,
                   wadd(B, static_cast<long long>(k + r) * t.ldb + 8 * q).a);
      }
    }
  }
#else
  if constexpr (k16W) {  // 32 rows x 4 chunks of 8 per B: B1 on tid 128+
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
#endif
}

#if REPRO_MEGA_MIXED
// Element (k, n) of a staged B slice of the leaf type ``code``, as float32
// (a 16-bit leaf's, staged as it is, widened exactly).
__device__ __forceinline__ float bfrag(const float* sB, int code, int k,
                                       int n) {
  if (code == 0) return sB[k * kBS + n];
  const uint16_t h = reinterpret_cast<const uint16_t*>(sB)[k * kBSh + n];
  return code == 1 ? __uint_as_float(static_cast<uint32_t>(h) << 16)
                   : __half2float(__ushort_as_half(h));
}
#endif

// Warp (wm, wn) = (warp % 4, warp / 4) owns rows 16 wm + [0, 16) and
// columns 16 wn + [0, 16): two m16n8 fragments per B.  ``bf16`` (a
// 16-bit trunk, bfloat16 or float16): every A and B value is of the
// 16-bit type, exact in TF32, so one pass (big.big) is the product; NORM
// then normalises the fragments by the rows' inverse RMS inv0 (row g) and
// inv1 (row g + 8).  16-bit weights have no remainder (the small.big pass
// of B is 0 and skipped).
template <bool NORM, bool DUAL, bool G, bool BF16>
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
    if (NORM) {  // depth past kd: A is 0 there, any scale element serves
      const int k0 = sl * kBK + kc, kl = t.kd - 1;
      const float s0 = wload(t.scale, !G || k0 < kl ? k0 : kl);
      const float s1 = wload(t.scale, !G || k0 + 4 < kl ? k0 + 4 : kl);
#if REPRO_MEGA_MIXED
      if (t.nh) {  // X(H(a * inv) * scale), H h's type, X the normed one's
        a[0] = round_code(t.nx, __fmul_rn(round_code(t.nh, __fmul_rn(a[0], inv0)), s0));
        a[1] = round_code(t.nx, __fmul_rn(round_code(t.nh, __fmul_rn(a[1], inv1)), s0));
        a[2] = round_code(t.nx, __fmul_rn(round_code(t.nh, __fmul_rn(a[2], inv0)), s1));
        a[3] = round_code(t.nx, __fmul_rn(round_code(t.nh, __fmul_rn(a[3], inv1)), s1));
      } else {
        a[0] = __fmul_rn(a[0], s0);
        a[1] = __fmul_rn(a[1], s0);
        a[2] = __fmul_rn(a[2], s1);
        a[3] = __fmul_rn(a[3], s1);
      }
#else
      if (bf16) {  // T(T(a * inv) * scale), as rms_norm
        a[0] = r16(__fmul_rn(r16(__fmul_rn(a[0], inv0)), s0));
        a[1] = r16(__fmul_rn(r16(__fmul_rn(a[1], inv1)), s0));
        a[2] = r16(__fmul_rn(r16(__fmul_rn(a[2], inv0)), s1));
        a[3] = r16(__fmul_rn(r16(__fmul_rn(a[3], inv1)), s1));
      } else {
        a[0] = __fmul_rn(a[0], s0);
        a[1] = __fmul_rn(a[1], s0);
        a[2] = __fmul_rn(a[2], s1);
        a[3] = __fmul_rn(a[3], s1);
      }
#endif
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
#if REPRO_MEGA_MIXED
      const int code = f / 2 ? t.B1.code : t.B0.code;
      split_tf32(bfrag(sB, code, kc, n), bb[f][0], bs[f][0]);
      split_tf32(bfrag(sB, code, kc + 4, n), bb[f][1], bs[f][1]);
#else
      if constexpr (k16W) {
        const uint16_t* sBh = reinterpret_cast<const uint16_t*>(sB);
        bb[f][0] = widen16(sBh[kc * kBSh + n]);
        bb[f][1] = widen16(sBh[(kc + 4) * kBSh + n]);
      } else {
        split_tf32(sB[kc * kBS + n], bb[f][0], bs[f][0]);
        split_tf32(sB[(kc + 4) * kBS + n], bb[f][1], bs[f][1]);
      }
#endif
    }
    // pass-major: consecutive mma.sync go to independent accumulators
    if (!bf16) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        mma_tf32(acc[f / 2][f % 2], as, bb[f][0], bb[f][1]);
    }
    if constexpr (!k16W) {
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
template <bool NORM, bool DUAL, bool G>
__device__ __forceinline__ void mma_slice(const float* st, const Tile& t,
                                          int sl, bool bf16, float inv0,
                                          float inv1,
                                          float (&acc)[DUAL ? 2 : 1][2][4]) {
  if constexpr (k16W)
    if (bf16) {
      mma_slice_as<NORM, DUAL, G, true>(st, t, sl, inv0, inv1, acc);
      return;
    }
  mma_slice_as<NORM, DUAL, G, false>(st, t, sl, inv0, inv1, acc);
}

// The inverse RMS of the tile's kBM rows of A (depth Kd) in a 16-bit
// trunk, rounded to its type (rms_inv_from_sumsq), into inv[kBM]: four
// threads per row sum its squares in float32 (in the general geometry, G,
// rows past the product's edge sum nothing).  Ends before a barrier the
// caller makes.
template <bool G>
__device__ __forceinline__ void row_inv16(const Tile& t, int Kd, float eps,
                                          float* inv) {
  // (the mixed library rounds the inverse RMS to h's type, t.nh)
  static_assert(kThreads == 4 * kBM, "row_inv16: 4 threads per row");
  const int r = threadIdx.x >> 2, qq = threadIdx.x & 3;
  const float* row = t.A + static_cast<long long>(r) * Kd;
  float ss = 0.0f;
  if (!G || (r < t.rows && (Kd & 3) == 0)) {
#pragma unroll 8
    for (int c = 4 * qq; c < Kd; c += 16) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(row + c));
      ss = __fadd_rn(ss, __fmul_rn(v.x, v.x));
      ss = __fadd_rn(ss, __fmul_rn(v.y, v.y));
      ss = __fadd_rn(ss, __fmul_rn(v.z, v.z));
      ss = __fadd_rn(ss, __fmul_rn(v.w, v.w));
    }
  } else if (r < t.rows) {  // rows that are no whole 16-byte chunks
    for (int c = qq; c < Kd; c += 4) {
      const float v = __ldcg(row + c);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
  }
  ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 1));
  ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 2));
#if REPRO_MEGA_MIXED
  if (qq == 0)
    inv[r] = round_code(t.nh, repro::rms_inv_from_sumsq<float>(ss, Kd, eps));
#else
  if (qq == 0) inv[r] = repro::rms_inv_from_sumsq<WT>(ss, Kd, eps);
#endif
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

// Output elements (n, n + 1) of a row-major float32 buffer at a (only n
// unless ``two``): one 8-byte access where ``vec`` (the buffer's row
// stride is even, and n always is), else one access each.
__device__ __forceinline__ void put2(float* a, float x, float y, bool two,
                                     bool vec) {
  if (two && vec) {
    *reinterpret_cast<float2*>(a) = make_float2(x, y);
  } else {
    a[0] = x;
    if (two) a[1] = y;
  }
}

// get2cg reads such a pair through L2 (activations of this launch); the
// element past the edge reads as 0.
__device__ __forceinline__ float2 get2cg(const float* a, bool two, bool vec) {
  if (two && vec) return __ldcg(reinterpret_cast<const float2*>(a));
  return make_float2(__ldcg(a), two ? __ldcg(a + 1) : 0.0f);
}

// A 16-bit state's output pair y (only its first element unless ``two``)
// at o, and its float32 value into the state's copy xs.
template <typename T, typename T2>
__device__ __forceinline__ void put2_16(T* o, T2 y, float* xs, bool two,
                                        bool vec) {
  if (two && vec) {
    *reinterpret_cast<T2*>(o) = y;
  } else {
    o[0] = y.x;
    if (two) o[1] = y.y;
  }
  put2(xs, __low2float(y), __high2float(y), two, vec);
}

// One product phase: M = batch x S rows in ceil(M / 64) row tiles by
// ``n_nt`` column tiles, depth Kd, each tile cut into ``split`` items
// along the depth.  tile_of(m0, nt) gives the operands of row tile m0,
// column tile nt (make_tile); epi(m, n, v, two) takes output pair (m, n),
// (m, n + 1) of the finished tile (v[nb] from B0 / B1; only (m, n) unless
// ``two``), only inside the product; pre(m0, nt) runs before a tile's
// product (all threads; the block synchronises after it) unless it is a
// NoPre.  A split phase's tiles are those of one (M, N) output, nt * 32
// its columns.  Without G (the aligned geometry: M, N and Kd whole tiles)
// every tile is whole and ``fast``, and none of the edge checks is
// compiled.  nh, nx: the mixed library's NORM codes (Tile); the uniform
// libraries ignore them.
struct NoPre {
  __device__ __forceinline__ void operator()(int, int) const {}
};

template <bool NORM, bool DUAL, bool G, typename TileOf, typename Epi,
          typename Pre = NoPre>
__device__ __forceinline__ void gemm_phase(const Params& p, float* smem,
                                           int n_nt, int N, int Kd,
                                           int split, int nh, int nx,
                                           TileOf tile_of, Epi epi,
                                           Pre pre = NoPre{}) {
  static_assert(kThreads == 4 * kBM, "slice_sumsq: 4 threads per row");
  const int M = p.batch * p.seq, tiles = cdiv(M, kBM) * n_nt;
  const int nsl = cdiv(Kd, kBK);
  const bool vec_part = !G || (N & 1) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp & 3, wn = warp >> 2;
  // the tile's row sums of squares (the inverse RMS in a 16-bit trunk)
  float* sSS = smem + kUnionFloats;
#if REPRO_MEGA_MIXED
  const bool bf16 = false;             // every product takes three passes
  const bool nrm16 = NORM && nh != 0;  // the norm in JAX's op order
#else
  const bool bf16 = k16W && p.round_trunk;
  const bool nrm16 = NORM && bf16;
#endif
  const bool stream_ss = NORM && !nrm16;  // the norm folded into the epilogue
  __shared__ int s_last;
  for (int item = block_rank(smem); item < tiles * split;
       item += gridDim.x) {
    const int tile = item % tiles, s = item / tiles;
    const int m0 = tile / n_nt * kBM;
    Tile t = tile_of(m0, tile % n_nt);
#if REPRO_MEGA_MIXED
    t.nh = nh;
    t.nx = nx;
#endif
    t.kd = Kd;
    t.rows = !G || M - m0 >= kBM ? kBM : M - m0;
    t.fast = !G || (t.rows == kBM && t.cols == kBN && Kd % kBK == 0 &&
                    t.ldb % bvec(t) == 0);
    t.sl0 = s * nsl / split;
    t.sl1 = (s + 1) * nsl / split;
    if constexpr (!std::is_same<Pre, NoPre>::value) {
      pre(m0, tile % n_nt);
      __syncthreads();
    }

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
      if (i < n_sl) load_slice<DUAL, G>(smem + i * kStageFloats, t, t.sl0 + i);
      cp_async_commit();
    }
    // a 16-bit trunk's norm: the rows' inverse RMS, while the first
    // slices' copies are in flight
    float inv0 = 1.0f, inv1 = 1.0f;
    if (nrm16) {
      row_inv16<G>(t, Kd, p.w.norm_eps, sSS);
      __syncthreads();
      inv0 = sSS[wm * 16 + g];
      inv1 = sSS[wm * 16 + g + 8];
    }
    for (int i = 0; i < n_sl; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slice i landed; slice i - 1 is no longer read
      const int nx = i + kStages - 1;
      if (nx < n_sl)
        load_slice<DUAL, G>(smem + (nx % kStages) * kStageFloats, t,
                            t.sl0 + nx);
      cp_async_commit();
      const float* st = smem + (i % kStages) * kStageFloats;
      if (stream_ss) slice_sumsq(st, ss);
      mma_slice<NORM, DUAL, G>(st, t, t.sl0 + i, bf16, inv0, inv1, acc);
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
          const int r = wm * 16 + g + 8 * hr, c = wn * 16 + j * 8 + 2 * q;
          if (!G || (r < t.rows && c < t.cols))
            put2(part + static_cast<long long>(m0 + r) * N + t.n + c,
                 acc[0][j][2 * hr], acc[0][j][2 * hr + 1],
                 !G || c + 1 < t.cols, vec_part);
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
            const int r = wm * 16 + g + 8 * hr, c = wn * 16 + j * 8 + 2 * q;
            if (G && (r >= t.rows || c >= t.cols)) continue;
            const bool two = !G || c + 1 < t.cols;
            const long long off =
                static_cast<long long>(m0 + r) * N + t.n + c;
            float2 v = get2cg(p.part + off, two, vec_part);
            for (int s2 = 1; s2 < split; ++s2) {
              const float2 u = get2cg(
                  p.part + static_cast<long long>(s2) * M * N + off, two,
                  vec_part);
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
          const int r = wm * 16 + g + 8 * hr, c = wn * 16 + j * 8 + 2 * q;
          if (G && (r >= t.rows || c >= t.cols)) continue;
          float2 v[DUAL ? 2 : 1];
#pragma unroll
          for (int nb = 0; nb < (DUAL ? 2 : 1); ++nb) {
            v[nb] = make_float2(acc[nb][j][2 * hr], acc[nb][j][2 * hr + 1]);
            if (stream_ss) {
              v[nb].x = __fmul_rn(v[nb].x, inv[hr]);
              v[nb].y = __fmul_rn(v[nb].y, inv[hr]);
            }
          }
          epi(m0 + r, t.n + c, v, !G || c + 1 < t.cols);
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
                                               WPtr w,
                                               int ldw, int c0, int n_out,
                                               float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = c0 + lane;
  float a = 0.0f;
  if (c < n_out)  // 32 loads in flight: the dot waits about one latency
#pragma unroll 32
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
// clears the split-K counters and widens a 16-bit state into xs.
__device__ __noinline__ void phase_time(const Params& p, float* smem) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < p.n_cnt; i += kThreads) p.cnt[i] = 0;
  if (p.state16) {
    const long long n = static_cast<long long>(p.batch) * p.seq * p.w.latent;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         i < n; i += static_cast<long long>(gridDim.x) * kThreads)
      p.xs[i] =
          p.state16 == 1
              ? __bfloat162float(
                    __ldg(static_cast<const __nv_bfloat16*>(p.x16) + i))
              : __half2float(__ldg(static_cast<const __half*>(p.x16) + i));
  }
  const int T = p.w.time_dim, groups = cdiv(T, 32);
  float* red = smem + kUnionFloats + kBM;
  for (int item = blockIdx.x; item < p.n_emb * groups; item += gridDim.x) {
    const int e = item / groups, c0 = item % groups * 32;
    const float a = block_row_dot(p.temb + static_cast<long long>(e) * T, T,
                                  WLEAF(p, time_w1, kLeafTimeW1), T, c0, T,
                                  red);
    const int c1 = gsite(p, kSiteT1);
    if (threadIdx.x < 32 && c0 + threadIdx.x < T)
      p.th[static_cast<long long>(e) * T + c0 + threadIdx.x] =
          rc(p, c1, silu(rc(p, c1, a)));
  }
}

// tw[e] = th[e] @ time_w2, the embedding row w_in adds, for every
// embedding of the launch (after the barrier that follows phase_time), in
// the general geometry, whose w_in tiles may hold rows of several samples.
__device__ __noinline__ void phase_time_out(const Params& p, float* smem) {
  const int d = p.w.d_model, T = p.w.time_dim, groups = cdiv(d, 32);
  float* red = smem + kUnionFloats + kBM;
  for (int item = block_rank(smem); item < p.n_emb * groups;
       item += gridDim.x) {
    const int e = item / groups, c0 = item % groups * 32;
    const float a = block_row_dot(p.th + static_cast<long long>(e) * T, T,
                                  WLEAF(p, time_w2, kLeafTimeW2), d, c0, d,
                                  red);
    if (threadIdx.x < 32 && c0 + threadIdx.x < d)
      p.tw[static_cast<long long>(e) * d + c0 + threadIdx.x] =
          rc(p, gsite(p, kSiteT2), a);
  }
}

// h = state @ w_in + th[e] @ time_w2; e is the step (B3) or, with
// per_slot, the row's sample (B4).  The aligned geometry's tile lies in
// one sample, so the block computes its 32 columns of th[e] @ time_w2
// itself; in the general one (G) a tile may hold rows of several samples,
// and each row adds its own row of tw (phase_time_out).  The state is x
// at step 0, then out (a 16-bit state: always its float32 copy xs).  G:
// the general geometry (gemm_phase), here and in every product phase.
template <bool G>
__device__ __noinline__ void phase_w_in(const Params& p, float* smem,
                                        int step, bool per_slot) {
  const int d = p.w.d_model, L = p.w.latent, T = p.w.time_dim;
  const bool vec = !G || (d & 1) == 0;
  const float* state = p.state16 ? p.xs : step == 0 ? p.x : p.out;
  float* red = smem + kUnionFloats + kBM;
  float* tv = red + kWarps * 32;
  const int ci = gsite(p, kSiteIn), ch = gsite(p, kSiteH0);
  auto tile_of = [&](int m0, int nt) {
    return make_tile(state + static_cast<long long>(m0) * L,
                     WLEAF(p, w_in, kLeafWIn), WNONE, d, nt * kBN, nt * kBN,
                     WNONE);
  };
  if constexpr (G) {
    gemm_phase<false, false, true>(
        p, smem, cdiv(d, kBN), d, L, 1, 0, 0, tile_of,
        [&](int m, int n, const float2 (&v)[1], bool two) {
          const int e = per_slot ? m / p.seq : step;
          const float2 t2 =
              get2cg(p.tw + static_cast<long long>(e) * d + n, two, vec);
          put2(p.h + static_cast<long long>(m) * d + n,
               rc(p, ch, __fadd_rn(rc(p, ci, v[0].x), t2.x)),
               rc(p, ch, __fadd_rn(rc(p, ci, v[0].y), t2.y)), two, vec);
        });
  } else {
    gemm_phase<false, false, false>(
        p, smem, d / kBN, d, L, 1, 0, 0, tile_of,
        [&](int m, int n, const float2 (&v)[1], bool) {
          *reinterpret_cast<float2*>(p.h + static_cast<long long>(m) * d +
                                     n) =
              make_float2(rc(p, ch, __fadd_rn(rc(p, ci, v[0].x), tv[n % kBN])),
                          rc(p, ch, __fadd_rn(rc(p, ci, v[0].y),
                                              tv[n % kBN + 1])));
        },
        [&](int m0, int nt) {
          const int e = per_slot ? m0 / p.seq : step;
          const float a = block_row_dot(p.th + static_cast<long long>(e) * T,
                                        T, WLEAF(p, time_w2, kLeafTimeW2), d,
                                        nt * kBN, d, red);
          if (threadIdx.x < 32) tv[threadIdx.x] = rc(p, gsite(p, kSiteT2), a);
        });
  }
}

// [q k v] = rmsnorm(h, attn_norm) @ [wq wk wv] into the (M, H*D + 2
// Hkv*D) qkv buffer: the column tiles of q, then of k, then of v.
template <bool G>
__device__ __noinline__ void phase_qkv(const Params& p, float* smem,
                                       int layer) {
  const int d = p.w.d_model, hq = p.w.n_heads * p.w.head_dim,
            hkv = p.w.n_kv_heads * p.w.head_dim, nq = hq + 2 * hkv;
  const int tq = cdiv(hq, kBN), tkv = cdiv(hkv, kBN);
  const long long dd = d;
  const WPtr wq = wadd(WLEAF(p, wq, kLeafWq), layer * dd * hq);
  const WPtr wk = wadd(WLEAF(p, wk, kLeafWk), layer * dd * hkv);
  const WPtr wv = wadd(WLEAF(p, wv, kLeafWv), layer * dd * hkv);
  const WPtr scale = wadd(WLEAF(p, attn_norm, kLeafAttnNorm), layer * dd);
  const int cq = lsite(p, layer, kSiteQ), ck = lsite(p, layer, kSiteK),
            cv = lsite(p, layer, kSiteV);
  const bool vec = !G || (nq & 1) == 0;
  gemm_phase<true, false, G>(
      p, smem, tq + 2 * tkv, nq, d, 1, lsite(p, layer, kSiteH),
      lsite(p, layer, kSiteXA),
      [&](int m0, int nt) {
        const float* A = p.h + static_cast<long long>(m0) * d;
        if (nt < tq)
          return make_tile(A, wq, WNONE, hq, nt * kBN, nt * kBN, scale);
        nt -= tq;
        if (nt < tkv)
          return make_tile(A, wk, WNONE, hkv, nt * kBN, hq + nt * kBN,
                           scale);
        nt -= tkv;
        return make_tile(A, wv, WNONE, hkv, nt * kBN, hq + hkv + nt * kBN,
                         scale);
      },
      [&](int m, int n, const float2 (&v)[1], bool two) {
        // the tiles never straddle q, k and v, so n + 1 is of n's part
        const int c = n < hq ? cq : n < hq + hkv ? ck : cv;
        put2(p.qkv + static_cast<long long>(m) * nq + n, rc(p, c, v[0].x),
             rc(p, c, v[0].y), two, vec);
      });
}

// h += a @ w (a: (M, Kd) activations), split-K: the attention output
// projection and the MLP's down projection; cw and ch are the mixed
// library's sites of the product and of the sum.
template <bool G>
__device__ __forceinline__ void residual_phase(const Params& p, float* smem,
                                               const float* a, int Kd,
                                               WPtr w, int split, int cw,
                                               int ch) {
  const int d = p.w.d_model;
  const bool vec = !G || (d & 1) == 0;
  gemm_phase<false, false, G>(
      p, smem, cdiv(d, kBN), d, Kd, split, 0, 0,
      [&](int m0, int nt) {
        return make_tile(a + static_cast<long long>(m0) * Kd, w, WNONE, d,
                         nt * kBN, nt * kBN, WNONE);
      },
      [&](int m, int n, const float2 (&v)[1], bool two) {
        float* hp = p.h + static_cast<long long>(m) * d + n;
        const float2 o = get2cg(hp, two, vec);
        put2(hp, rc(p, ch, __fadd_rn(o.x, rc(p, cw, v[0].x))),
             rc(p, ch, __fadd_rn(o.y, rc(p, cw, v[0].y))), two, vec);
      });
}

template <bool G>
__device__ __noinline__ void phase_wo(const Params& p, float* smem,
                                      int layer) {
  const int hq = p.w.n_heads * p.w.head_dim;
  residual_phase<G>(p, smem, p.ao, hq,
                 wadd(WLEAF(p, wo, kLeafWo),
                      layer * static_cast<long long>(hq) * p.w.d_model),
                 p.split_wo, lsite(p, layer, kSiteWO),
                 lsite(p, layer, kSiteH1));
}

template <bool G>
__device__ __noinline__ void phase_down(const Params& p, float* smem,
                                        int layer) {
  const int dff = p.w.d_ff;
  residual_phase<G>(p, smem, p.ff, dff,
                 wadd(WLEAF(p, w_down, kLeafWDown),
                      layer * static_cast<long long>(dff) * p.w.d_model),
                 p.split_dn, lsite(p, layer, kSiteD),
                 lsite(p, layer, kSiteH2));
}

// ff = silu(xn @ w_gate) * (xn @ w_up), xn = rmsnorm(h, mlp_norm).
template <bool G>
__device__ __noinline__ void phase_mlp(const Params& p, float* smem,
                                       int layer) {
  const int d = p.w.d_model, dff = p.w.d_ff;
  const long long dd = d;
  const WPtr wg = wadd(WLEAF(p, w_gate, kLeafWGate), layer * dd * dff);
  const WPtr wu = wadd(WLEAF(p, w_up, kLeafWUp), layer * dd * dff);
  const WPtr scale = wadd(WLEAF(p, mlp_norm, kLeafMlpNorm), layer * dd);
  const int cg_ = lsite(p, layer, kSiteG), cu = lsite(p, layer, kSiteU),
            cgu = lsite(p, layer, kSiteGU);
  const bool vec = !G || (dff & 1) == 0;
  gemm_phase<true, true, G>(
      p, smem, cdiv(dff, kBN), dff, d, 1, lsite(p, layer, kSiteH1),
      lsite(p, layer, kSiteXM),
      [&](int m0, int nt) {
        return make_tile(p.h + static_cast<long long>(m0) * d, wg, wu, dff,
                         nt * kBN, nt * kBN, scale);
      },
      [&](int m, int n, const float2 (&v)[2], bool two) {
        put2(p.ff + static_cast<long long>(m) * dff + n,
             rc(p, cgu, __fmul_rn(rc(p, cg_, silu(rc(p, cg_, v[0].x))),
                                  rc(p, cu, v[1].x))),
             rc(p, cgu, __fmul_rn(rc(p, cg_, silu(rc(p, cg_, v[0].y))),
                                  rc(p, cu, v[1].y))),
             two, vec);
      });
}

// One RoPE pair of a head: d[0] = x1 c - x2 s, d[half] = x2 c + x1 s, each
// product and sum rounded in a 16-bit trunk (whose tables the launcher
// rounds), times ``scale`` in float32.  The mixed library rounds the
// tables and the pair to the head's type itself (``code``: q's or k's).
__device__ __forceinline__ void rope_pair(const Params& p, float* d, int half,
                                          float x1, float x2, float cs,
                                          float sn, float scale, int code) {
  if constexpr (kMixed) {
    cs = round_code(code, cs);
    sn = round_code(code, sn);
  }
  d[0] = __fmul_rn(rc(p, code, __fsub_rn(rc(p, code, __fmul_rn(x1, cs)),
                                         rc(p, code, __fmul_rn(x2, sn)))),
                   scale);
  d[half] = __fmul_rn(rc(p, code, __fadd_rn(rc(p, code, __fmul_rn(x2, cs)),
                                            rc(p, code, __fmul_rn(x1, sn)))),
                      scale);
}

// load_roped's 16-byte path (D a multiple of 8); FULL: D is the padded
// width HD itself, so the chunk counts are constants; without G every row
// is inside S.
template <int HD, bool FULL, bool G>
__device__ __forceinline__ void roped_chunks(float* dst, const float* src,
                                             int nq, const Params& p, int r0,
                                             int n, int nrows, float scale,
                                             int D, int code) {
  constexpr int QS = HD + 1;
  const int half = FULL ? HD / 2 : D / 2, C4 = half / 4;
  for (int i = threadIdx.x; i < nrows * C4; i += kThreads) {
    const int r = i / C4, j = i % C4 * 4;
    float* d = dst + r * QS + j;
    if (!G || r < n) {
      const float4 c4 = __ldg(reinterpret_cast<const float4*>(
          p.rope_cos + (r0 + r) * half + j));
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(
          p.rope_sin + (r0 + r) * half + j));
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(src + r * nq + j));
      const float4 b =
          __ldcg(reinterpret_cast<const float4*>(src + r * nq + j + half));
      rope_pair(p, d, half, a.x, b.x, c4.x, s4.x, scale, code);
      rope_pair(p, d + 1, half, a.y, b.y, c4.y, s4.y, scale, code);
      rope_pair(p, d + 2, half, a.z, b.z, c4.z, s4.z, scale, code);
      rope_pair(p, d + 3, half, a.w, b.w, c4.w, s4.w, scale, code);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) d[u] = d[u + half] = 0.0f;
    }
  }
}

// Rows [0, nrows) of one head into dst (row stride HD + 1), from rows r0..
// of the (M, nq) qkv buffer (src points at row r0, the head's column 0):
// the first n rows RoPE'd with the table's rows r0.. (the head dim D splits
// into halves; the table's row stride is D / 2) and multiplied by
// ``scale``; rows past n and columns past D zero.  16-byte loads where D
// is a multiple of 8, else one element at a time.  Without G, D is HD and
// n is nrows.  ``code``: the mixed library's site of the head (q or k).
template <int HD, bool G>
__device__ __forceinline__ void load_roped(float* dst, const float* src,
                                           int nq, const Params& p, int r0,
                                           int n, int nrows, float scale,
                                           int D, int code) {
  constexpr int QS = HD + 1;
  if (!G || D == HD) {
    roped_chunks<HD, true, G>(dst, src, nq, p, r0, n, nrows, scale, D, code);
    return;
  }
  const int half = D / 2;
  if (D % 8 == 0) {
    roped_chunks<HD, false, G>(dst, src, nq, p, r0, n, nrows, scale, D,
                               code);
  } else {
    for (int i = threadIdx.x; i < nrows * half; i += kThreads) {
      const int r = i / half, j = i % half;
      float* d = dst + r * QS + j;
      if (r < n)
        rope_pair(p, d, half, __ldcg(src + r * nq + j),
                  __ldcg(src + r * nq + j + half),
                  __ldg(p.rope_cos + (r0 + r) * half + j),
                  __ldg(p.rope_sin + (r0 + r) * half + j), scale, code);
      else
        d[0] = d[half] = 0.0f;
    }
  }
  for (int i = threadIdx.x; i < nrows * (HD - D); i += kThreads)
    dst[i / (HD - D) * QS + D + i % (HD - D)] = 0.0f;
}

// Rows [0, nrows) of one head's V (src at its first row) into dst, stride
// HD: the first n rows' D columns, the rest zero (without G, D is HD and n
// is nrows).
template <int HD, bool G>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int nq, int n, int nrows, int D) {
  if (!G || D == HD) {
    for (int i = threadIdx.x; i < nrows * HD / 4; i += kThreads) {
      const int r = i / (HD / 4), c = i % (HD / 4) * 4;
      *reinterpret_cast<float4*>(dst + r * HD + c) =
          !G || r < n
              ? __ldcg(reinterpret_cast<const float4*>(src + r * nq + c))
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      dst[i] = r < n && c < D ? __ldcg(src + r * nq + c) : 0.0f;
    }
  }
}

// 'exact' scores of the thread's tile: q k^T / sqrt(D), as JAX divides them
// (in a 16-bit trunk the product and the quotient are rounded); in a
// ragged last block (kn < BK) the columns from kn on, K/V rows past S,
// masked to -1e30.
template <int HD, int BK>
__device__ __forceinline__ void exact_scores(const Params& p, const float* sQ,
                                             const float* sK, int kn,
                                             float (&s)[kBQ / 16][BK / 16],
                                             int cqk, float div) {
  repro::qk_scores<kBQ, BK, HD>(sQ, sK, s);
#pragma unroll
  for (int i = 0; i < kBQ / 16; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      s[i][j] = rc(p, cqk, __fdiv_rn(rc(p, cqk, s[i][j]), div));
  if (kn < BK) {
    const int tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < kBQ / 16; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        if (tx + 16 * j >= kn) s[i][j] = repro::kNegBig;
  }
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
// head h / (H / Hkv) over the sample's ceil(S / BK) K/V blocks (the last
// one's rows past S zero and masked); the result goes to columns h*D of
// rows q0.. of the (M, H*D) buffer, rows past S not stored.  HD is the
// padded width (D <= HD, the columns past D zero).  FLASH scales q by
// 1/sqrt(D) after RoPE (streaming_attention_body) and runs the recurrence
// over the blocks.  'exact' takes the rows' max m and sum l over the
// blocks first (the recurrence's running pair: m the row max, l the sum of
// exp(s - m)), then writes p = exp(s - m) / l block by block and
// accumulates p v over the blocks; with one block (S <= BK) that is the
// plain row softmax and the K block is not reloaded.  Without G (the
// aligned geometry) D is HD and S a whole number of blocks, so nothing is
// masked or padded.
template <bool FLASH, int HD, bool G>
__device__ __noinline__ void attention_items(const Params& p, float* smem,
                                             int layer) {
  using T = AttnTiles<HD>;
  constexpr int BK = T::BK, RQ = kBQ / 16, RK = BK / 16, RD = HD / 16;
  const int H = p.w.n_heads, Hkv = p.w.n_kv_heads, grp = H / Hkv,
            S = p.seq, D = G ? p.w.head_dim : HD;
  const int hq = H * D, nq = hq + 2 * Hkv * D,
            nqb = G ? cdiv(S, kBQ) : S / kBQ, nkb = G ? cdiv(S, BK) : S / BK;
  float* sQ = smem + T::kQ;
  float* sK = smem + T::kK;
  float* sP = smem + T::kP;
  float* sV = smem + T::kV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int cq = lsite(p, layer, kSiteQ), ck = lsite(p, layer, kSiteK),
            cqk = lsite(p, layer, kSiteQK),
            co = lsite(p, layer, FLASH ? kSiteH : kSitePV);
  const float div = kMixed ? p.w.attn_div[layer > 0] : p.attn_div;
  for (int item = block_rank(smem); item < p.batch * H * nqb;
       item += gridDim.x) {
    const int qb = item % nqb, bh = item / nqb, b = bh / H, hh = bh % H,
              kvh = hh / grp, q0 = qb * kBQ;
    const int qn = G && S - q0 < kBQ ? S - q0 : kBQ;  // query rows inside S
    const float* base = p.qkv + static_cast<long long>(b) * S * nq;
    const float* k = base + hq + kvh * D;
    const float* v = base + hq + Hkv * D + kvh * D;
    float* out = p.ao + (static_cast<long long>(b) * S + q0) * hq + hh * D;
    auto store = [&](int row, int col, float val) {
      if (!G || (row < qn && col < D)) out[row * hq + col] = rc(p, co, val);
    };
    load_roped<HD, G>(sQ, base + static_cast<long long>(q0) * nq + hh * D,
                      nq, p, q0, qn, kBQ, FLASH ? p.q_scale : 1.0f, D, cq);
    if (FLASH) {
      repro::SoftmaxState<kBQ, HD> st;
      st.init();
      for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * BK, kn = G && S - k0 < BK ? S - k0 : BK;
        __syncthreads();  // the previous block is no longer read
        load_roped<HD, G>(sK, k + static_cast<long long>(k0) * nq, nq, p,
                          k0, kn, BK, 1.0f, D, ck);
        load_rows<HD, G>(sV, v + static_cast<long long>(k0) * nq, nq, kn,
                         BK, D);
        __syncthreads();
        repro::online_softmax_step<kBQ, BK, HD, false>(sQ, sK, sV, sP, st, q0,
                                                       k0, kn);
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
        const int k0 = kb * BK, kn = G && S - k0 < BK ? S - k0 : BK;
        __syncthreads();
        load_roped<HD, G>(sK, k + static_cast<long long>(k0) * nq, nq, p,
                          k0, kn, BK, 1.0f, D, ck);
        __syncthreads();
        float s[RQ][RK];
        exact_scores<HD, BK>(p, sQ, sK, kn, s, cqk, div);
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
        const int k0 = kb * BK, kn = G && S - k0 < BK ? S - k0 : BK;
        __syncthreads();
        if (nkb > 1)
          load_roped<HD, G>(sK, k + static_cast<long long>(k0) * nq, nq, p,
                            k0, kn, BK, 1.0f, D, ck);
        load_rows<HD, G>(sV, v + static_cast<long long>(k0) * nq, nq, kn,
                         BK, D);
        __syncthreads();
        float s[RQ][RK];
        exact_scores<HD, BK>(p, sQ, sK, kn, s, cqk, div);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RK; ++j)
            sP[(ty * RQ + i) * T::PS + tx + 16 * j] =
                rc(p, cq, __fdiv_rn(expf(s[i][j] - m[i]), l[i]));
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

// Columns [c0, c0 + kWideDepth) of rows [0, NROWS) of one head, from rows
// r0.. of the qkv buffer (src at row r0, the head's column 0), RoPE'd
// (rope_pair's first output for a column of the lower half, its second
// for the upper one) and times ``scale``; rows past n and columns past D
// zero.  gather() loads a thread's operands into registers, store() writes
// its elements to dst (row stride kWideDepth + 1): a q chunk and a K chunk
// are gathered before either is stored, so all their loads are in flight
// together.
template <int NROWS>
struct RopeChunk {
  static constexpr int PER = NROWS * kWideDepth / kThreads;
  static_assert(PER * kThreads == NROWS * kWideDepth, "whole rounds");
  float x1[PER], x2[PER], cs[PER], sn[PER];
  int n, D, c0;

  __device__ __forceinline__ void gather(const float* src, int nq,
                                         const Params& p, int r0, int n_,
                                         int D_, int c0_) {
    n = n_;
    D = D_;
    c0 = c0_;
    const int half = D / 2;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kThreads, r = i / kWideDepth,
                col = c0 + i % kWideDepth, j = col < half ? col : col - half;
      x1[u] = x2[u] = cs[u] = sn[u] = 0.0f;
      if (r < n && col < D) {
        const float* row = src + static_cast<long long>(r) * nq;
        x1[u] = __ldcg(row + j);
        x2[u] = __ldcg(row + j + half);
        cs[u] = __ldg(p.rope_cos + (r0 + r) * half + j);
        sn[u] = __ldg(p.rope_sin + (r0 + r) * half + j);
      }
    }
  }

  __device__ __forceinline__ void store(const Params& p, float* dst,
                                        float scale, int code) const {
    const int half = D / 2;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kThreads, r = i / kWideDepth,
                jj = i % kWideDepth, col = c0 + jj;
      float d[2];
      rope_pair(p, d, 1, x1[u], x2[u], cs[u], sn[u], scale, code);
      dst[r * (kWideDepth + 1) + jj] =
          r < n && col < D ? d[col < half ? 0 : 1] : 0.0f;
    }
  }
};

// Attention past head dim kMaxHeadDim (any even D): one item per (sample,
// q head, kBQ query rows), as attention_items, whose tiles would not fit
// shared memory nor its accumulator the registers.  For every K/V block
// of kWideBK rows the scores stream over the head in chunks of kWideDepth
// columns (q and K RoPE'd as they are loaded), summing in registers in
// the depth order qk_scores takes.
// Up to kWideRowsMaxS tokens (the main path's) the item's score rows stay
// in shared memory: one pass over the blocks writes them, each half-warp
// turns its rows into p with their max m and sum l ('exact': exp(s - m) /
// l at q's type; 'flash': exp(s - m), divided by max(l, 1e-20) at the end:
// the recurrence's result in one step), then p v runs over the blocks, in
// registers, for one output chunk of kWideOut columns: there an item is
// (sample, q head, kBQ query rows, output chunk).
// Past that, p v runs in output chunks inside each block, each thread's
// running sums kept in its own elements of the item's rows of the
// attention output buffer (raw float32 between blocks, read back by the
// thread that wrote them; the last block stores the result at its site's
// type): 'flash' runs the recurrence, acc = acc alpha + p v; 'exact' the
// two passes of attention_items, its p v one FMA chain per element across
// the blocks.
template <bool FLASH>
__device__ __noinline__ void attention_wide(const Params& p, float* smem,
                                            int layer) {
  using T = WideTiles;
  constexpr int BK = kWideBK, RQ = kBQ / 16, RK = BK / 16,
                RO = kWideOut / 16;
  const int H = p.w.n_heads, Hkv = p.w.n_kv_heads, grp = H / Hkv, S = p.seq,
            D = p.w.head_dim;
  const int hq = H * D, nq = hq + 2 * Hkv * D, nqb = cdiv(S, kBQ),
            nkb = cdiv(S, BK), ndc = cdiv(D, kWideDepth),
            noc = cdiv(D, kWideOut);
  float* sQ = smem + T::kQ;
  float* sK = smem + T::kK;
  float* sP = smem + T::kP;
  float* sV = smem + T::kV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int cq = lsite(p, layer, kSiteQ), ck = lsite(p, layer, kSiteK),
            cqk = lsite(p, layer, kSiteQK),
            co = lsite(p, layer, FLASH ? kSiteH : kSitePV);
  const float div = kMixed ? p.w.attn_div[layer > 0] : p.attn_div;
  // with the score rows in shared memory an item is also one output chunk
  // (every chunk's item recomputes the scores: more items, each of fewer
  // serial stages, on a grid that the (sample, head, query block) items
  // alone leave mostly idle)
  const bool rows_mode = S <= kWideRowsMaxS;
  const int ngrp = rows_mode ? noc : 1;
  for (int item = block_rank(smem); item < p.batch * H * nqb * ngrp;
       item += gridDim.x) {
    const int oc_item = item % ngrp, rest = item / ngrp;
    const int qb = rest % nqb, bh = rest / nqb, b = bh / H, hh = bh % H,
              kvh = hh / grp, q0 = qb * kBQ;
    const int qn = S - q0 < kBQ ? S - q0 : kBQ;  // query rows inside S
    const float* base = p.qkv + static_cast<long long>(b) * S * nq;
    const float* qs = base + static_cast<long long>(q0) * nq + hh * D;
    const float* k = base + hq + kvh * D;
    const float* v = base + hq + Hkv * D + kvh * D;
    float* out = p.ao + (static_cast<long long>(b) * S + q0) * hq + hh * D;
    // s = q k^T of block k0 (kn rows inside S) over every depth chunk;
    // 'exact' divides as exact_scores does; columns from kn on masked
    auto scores = [&](int k0, int kn, float (&s)[RQ][RK]) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = 0.0f;
      for (int dc = 0; dc < ndc; ++dc) {
        RopeChunk<kBQ> qc;
        RopeChunk<BK> kc;
        qc.gather(qs, nq, p, q0, qn, D, dc * kWideDepth);
        kc.gather(k + static_cast<long long>(k0) * nq, nq, p, k0, kn, D,
                  dc * kWideDepth);
        __syncthreads();  // the previous chunk is no longer read
        qc.store(p, sQ, FLASH ? p.q_scale : 1.0f, cq);
        kc.store(p, sK, 1.0f, ck);
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < kWideDepth; ++c) {
          float a[RQ], bb[RK];
#pragma unroll
          for (int i = 0; i < RQ; ++i) a[i] = sQ[(ty * RQ + i) * T::QS + c];
#pragma unroll
          for (int j = 0; j < RK; ++j) bb[j] = sK[(tx + 16 * j) * T::QS + c];
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          if (!FLASH) s[i][j] = rc(p, cqk, __fdiv_rn(rc(p, cqk, s[i][j]), div));
          if (tx + 16 * j >= kn) s[i][j] = repro::kNegBig;
        }
    };
    float m[RQ], l[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      m[i] = repro::kNegBig;
      l[i] = 0.0f;
    }
    if (rows_mode) {  // the item's score rows in shared memory
      const int SS = nkb * BK + 1;
      float* sS = smem + T::kFloats;
      for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * BK, kn = S - k0 < BK ? S - k0 : BK;
        float s[RQ][RK];
        scores(k0, kn, s);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RK; ++j)
            sS[(ty * RQ + i) * SS + k0 + tx + 16 * j] = s[i][j];
      }
      __syncwarp();  // a half-warp reads back only the rows it wrote
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float* row = sS + (ty * RQ + i) * SS;
        float mx = repro::kNegBig;
        for (int c = tx; c < nkb * BK; c += 16) mx = fmaxf(mx, row[c]);
        m[i] = repro::half_warp_max(mx);
        float sum = 0.0f;
        for (int c = tx; c < nkb * BK; c += 16) sum += expf(row[c] - m[i]);
        l[i] = repro::half_warp_sum(sum);
        for (int c = tx; c < nkb * BK; c += 16)
          row[c] = FLASH ? expf(row[c] - m[i])
                         : rc(p, cq, __fdiv_rn(expf(row[c] - m[i]), l[i]));
      }
      {
        const int o0 = oc_item * kWideOut;  // the item's output chunk
        float acc[RQ][RO];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int r = 0; r < RO; ++r) acc[i][r] = 0.0f;
        for (int kb = 0; kb < nkb; ++kb) {
          const int k0 = kb * BK, kn = S - k0 < BK ? S - k0 : BK;
          constexpr int PV = BK * kWideOut / kThreads;
          float vv[PV];
#pragma unroll
          for (int u = 0; u < PV; ++u) {
            const int i = threadIdx.x + u * kThreads, r = i / kWideOut,
                      c = i % kWideOut;
            vv[u] = r < kn && o0 + c < D
                        ? __ldcg(v + static_cast<long long>(k0 + r) * nq +
                                 o0 + c)
                        : 0.0f;
          }
          __syncthreads();  // sV is no longer read; every p is written
#pragma unroll
          for (int u = 0; u < PV; ++u) sV[threadIdx.x + u * kThreads] = vv[u];
          __syncthreads();
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float* prow = sS + (ty * RQ + i) * SS + k0;
#pragma unroll 4
            for (int c = 0; c < BK; ++c) {
              const float pc = prow[c];
#pragma unroll
              for (int r = 0; r < RO; ++r)
                acc[i][r] = fmaf(pc, sV[c * kWideOut + tx + 16 * r],
                                 acc[i][r]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const int row = ty * RQ + i;
          const float den = FLASH ? fmaxf(l[i], 1e-20f) : 1.0f;
#pragma unroll
          for (int r = 0; r < RO; ++r) {
            const int col = o0 + tx + 16 * r;
            if (row < qn && col < D)
              out[static_cast<long long>(row) * hq + col] =
                  rc(p, co, FLASH ? __fdiv_rn(acc[i][r], den) : acc[i][r]);
          }
        }
      }
      __syncthreads();  // shared memory is reused by the next item
      continue;
    }
    if (!FLASH) {  // pass 1: the rows' max and sum
      for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * BK, kn = S - k0 < BK ? S - k0 : BK;
        float s[RQ][RK];
        scores(k0, kn, s);
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
    }
    for (int kb = 0; kb < nkb; ++kb) {  // p, then p v by output chunks
      const int k0 = kb * BK, kn = S - k0 < BK ? S - k0 : BK;
      float s[RQ][RK], alpha[RQ];
      scores(k0, kn, s);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int row = ty * RQ + i;
        if (FLASH) {
          float mx = repro::kNegBig;
#pragma unroll
          for (int j = 0; j < RK; ++j) mx = fmaxf(mx, s[i][j]);
          const float m_new = fmaxf(m[i], repro::half_warp_max(mx));
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < RK; ++j) {
            const float pr = expf(s[i][j] - m_new);
            sP[row * T::PS + tx + 16 * j] = pr;
            sum += pr;
          }
          alpha[i] = expf(m[i] - m_new);
          l[i] = alpha[i] * l[i] + repro::half_warp_sum(sum);
          m[i] = m_new;
        } else {
#pragma unroll
          for (int j = 0; j < RK; ++j)
            sP[row * T::PS + tx + 16 * j] =
                rc(p, cq, __fdiv_rn(expf(s[i][j] - m[i]), l[i]));
        }
      }
      const bool last = kb == nkb - 1;
      for (int oc = 0; oc < noc; ++oc) {
        const int o0 = oc * kWideOut;
        constexpr int PV = BK * kWideOut / kThreads;  // V elements a thread
        float vv[PV];
#pragma unroll
        for (int u = 0; u < PV; ++u) {  // gathered before the barrier
          const int i = threadIdx.x + u * kThreads, r = i / kWideOut,
                    c = i % kWideOut;
          vv[u] = r < kn && o0 + c < D
                      ? __ldcg(v + static_cast<long long>(k0 + r) * nq + o0 +
                               c)
                      : 0.0f;
        }
        __syncthreads();  // sV is no longer read; sP is written
#pragma unroll
        for (int u = 0; u < PV; ++u) sV[threadIdx.x + u * kThreads] = vv[u];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const int row = ty * RQ + i;
          float acc[RO];
#pragma unroll
          for (int r = 0; r < RO; ++r) {
            const int col = o0 + tx + 16 * r;
            acc[r] = kb > 0 && row < qn && col < D
                         ? __ldcg(out + static_cast<long long>(row) * hq + col)
                         : 0.0f;
          }
          if (FLASH) {
            float pv[RO] = {};
#pragma unroll 4
            for (int c = 0; c < BK; ++c) {
              const float pc = sP[row * T::PS + c];
#pragma unroll
              for (int r = 0; r < RO; ++r)
                pv[r] = fmaf(pc, sV[c * kWideOut + tx + 16 * r], pv[r]);
            }
#pragma unroll
            for (int r = 0; r < RO; ++r) acc[r] = acc[r] * alpha[i] + pv[r];
          } else {
#pragma unroll 4
            for (int c = 0; c < BK; ++c) {
              const float pc = sP[row * T::PS + c];
#pragma unroll
              for (int r = 0; r < RO; ++r)
                acc[r] = fmaf(pc, sV[c * kWideOut + tx + 16 * r], acc[r]);
            }
          }
          const float den = FLASH ? fmaxf(l[i], 1e-20f) : 1.0f;
#pragma unroll
          for (int r = 0; r < RO; ++r) {
            const int col = o0 + tx + 16 * r;
            if (row >= qn || col >= D) continue;
            out[static_cast<long long>(row) * hq + col] =
                !last ? acc[r]
                      : rc(p, co, FLASH ? __fdiv_rn(acc[r], den) : acc[r]);
          }
        }
      }
    }
    __syncthreads();  // shared memory is reused by the next item
  }
}

// The attention phase at the trunk's head dim: the aligned geometry's
// four widths as they are, or (G) padded to the next of six widths, or
// past kMaxHeadDim streamed over the head (attention_wide).
template <bool FLASH, bool G>
__device__ __forceinline__ void phase_attention(const Params& p,
                                                float* smem, int layer) {
  const int D = p.w.head_dim;
  if (D <= 16)
    attention_items<FLASH, 16, G>(p, smem, layer);
  else if (D <= 32)
    attention_items<FLASH, 32, G>(p, smem, layer);
  else if (D <= 64)
    attention_items<FLASH, 64, G>(p, smem, layer);
  else if (G && D <= 96)
    attention_items<FLASH, 96, G>(p, smem, layer);
  else if (!G || D <= 128)
    attention_items<FLASH, 128, G>(p, smem, layer);
  else if (!G || D <= kMaxHeadDim)
    attention_items<FLASH, kMaxHeadDim, G>(p, smem, layer);
  else if constexpr (G)
    attention_wide<FLASH>(p, smem, layer);
}

// eps = rmsnorm(h, out_norm) @ w_out, split-K, then the update of the
// state elements the tile covers: element idx = m * L + n of the flat
// (batch, S, L) state.  B3 reads the step's coefficients, B4 (ROWS) the
// (R, 8) row idx / 256.  A 16-bit state is read from xs, and the update
// (float32) is rounded to the state's type into out and xs.
template <bool CLIP, bool ROWS, bool G>
__device__ __noinline__ void phase_out(const Params& p, float* smem,
                                       int step) {
  const int d = p.w.d_model, L = p.w.latent;
  const bool vec = !G || (L & 1) == 0;
  const float* prev = p.state16 ? p.xs : step == 0 ? p.x : p.out;
  const bool from_input = step == 0 && !p.state16;
  const int ce = gsite(p, kSiteEps);
  gemm_phase<true, false, G>(
      p, smem, cdiv(L, kBN), L, d, p.split_out, gsite(p, kSiteHL),
      gsite(p, kSiteXO),
      [&](int m0, int nt) {
        return make_tile(p.h + static_cast<long long>(m0) * d,
                         WLEAF(p, w_out, kLeafWOut), WNONE, L, nt * kBN,
                         nt * kBN, WLEAF(p, out_norm, kLeafOutNorm));
      },
      [&](int m, int n, const float2 (&v)[1], bool two) {
        const long long idx = static_cast<long long>(m) * L + n;
        auto coefs = [&](long long i) {
          const float* cr =
              ROWS ? p.coefs + i / kTileC * kRowCoefs : p.coefs + step * 5;
          return repro::Coefs{__ldg(cr), __ldg(cr + 1), __ldg(cr + 2),
                              __ldg(cr + 3), __ldg(cr + 4)};
        };
        // an even L keeps idx even, so one 256-wide tile row holds the
        // pair; with an odd L the pair may straddle two rows (two slots)
        const repro::Coefs c = coefs(idx), c1 = vec ? c : coefs(idx + 1);
        float2 x;
        if (!from_input) {
          x = get2cg(prev + idx, two, vec);
        } else if (two && vec) {
          x = __ldg(reinterpret_cast<const float2*>(prev + idx));
        } else {
          x = make_float2(__ldg(prev + idx), two ? __ldg(prev + idx + 1)
                                                 : 0.0f);
        }
        float x0;
        const float y0 =
            repro::update<CLIP, false>(x.x, rc(p, ce, v[0].x), c, p.clip, &x0);
        const float y1 =
            repro::update<CLIP, false>(x.y, rc(p, ce, v[0].y), c1, p.clip,
                                       &x0);
        if (p.state16 == 1) {
          put2_16(static_cast<__nv_bfloat16*>(p.out16) + idx,
                  __floats2bfloat162_rn(y0, y1), p.xs + idx, two, vec);
        } else if (p.state16 == 2) {
          put2_16(static_cast<__half*>(p.out16) + idx,
                  __floats2half2_rn(y0, y1), p.xs + idx, two, vec);
        } else {
          put2(p.out + idx, y0, y1, two, vec);
        }
      });
}

// Phase trace (off when p.trace is null): block 0 records %globaltimer
// (ns) at the start and after every phase, barrier included, so stamp i+1
// - stamp i is phase i as the grid saw it (the first: the time MLP's two
// phases).  2 + steps (2 + 5 n_layers) stamps.
__device__ __forceinline__ void stamp(const Params& p, int& n) {
  if (p.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.trace[n] = t;
  }
  ++n;
}

// The steps of a launch (B3: K, B4: one), each phase in its G
// instantiation, with a grid barrier and a trace stamp after each.
template <bool CLIP, bool FLASH, bool ROWS, bool G>
__device__ __forceinline__ void run_steps(const Params& p, float* smem,
                                          int& n) {
  cg::grid_group grid = cg::this_grid();
  const int steps = ROWS ? 1 : p.K;
  for (int step = 0; step < steps; ++step) {
    phase_w_in<G>(p, smem, step, ROWS);
    grid.sync();
    stamp(p, n);
    for (int layer = 0; layer < p.w.n_layers; ++layer) {
      phase_qkv<G>(p, smem, layer);
      grid.sync();
      stamp(p, n);
      phase_attention<FLASH, G>(p, smem, layer);
      grid.sync();
      stamp(p, n);
      phase_wo<G>(p, smem, layer);
      grid.sync();
      stamp(p, n);
      phase_mlp<G>(p, smem, layer);
      grid.sync();
      stamp(p, n);
      phase_down<G>(p, smem, layer);
      grid.sync();
      stamp(p, n);
    }
    phase_out<CLIP, ROWS, G>(p, smem, step);
    if (step + 1 < steps) grid.sync();
    stamp(p, n);
  }
}

// ROWS is the scheduler tick (B4): one step (K = 1), slot b's rows read
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
  if (p.general) {
    phase_time_out(p, smem);
    grid.sync();
  }
  stamp(p, n);
  if constexpr (kMixed) {  // the mixed library runs the general phases
    run_steps<CLIP, FLASH, ROWS, true>(p, smem, n);
  } else {
    if (p.general)
      run_steps<CLIP, FLASH, ROWS, true>(p, smem, n);
    else
      run_steps<CLIP, FLASH, ROWS, false>(p, smem, n);
  }
}

// The geometry the kernel takes (mirrored by kernel._shape_limits): any
// seq_len whose sample is a whole number of 256-wide tile rows (the slot
// of a B4 coefficient row), an even head dim (RoPE's halves; past
// kMaxHeadDim attention_wide streams it), GQA groups of whole heads, and
// any other width: the product tiles cut them at any edge.
bool widths_ok(const ReproMegaWeights& w, int seq) {
  const int D = w.head_dim;
  return w.n_layers >= 0 && w.n_heads > 0 && w.n_kv_heads > 0 &&
         w.n_heads % w.n_kv_heads == 0 && D >= 2 && D % 2 == 0 &&
         w.d_model > 0 && w.d_ff > 0 && w.latent > 0 &&
         w.time_dim > 0 && seq >= 1 &&
         (static_cast<long long>(seq) * w.latent) % kTileC == 0;
}

// The aligned geometry, whose phases run without the edge checks: every
// 64-row tile inside one sample, every product width and depth a whole
// number of 32-wide tiles, and a head dim that is its own attention width
// (so S is also a whole number of K/V and query blocks).
bool aligned(const ReproMegaWeights& w, int seq) {
  const int D = w.head_dim;
  return seq % kBM == 0 && (D == 16 || D == 32 || D == 64 || D == 128) &&
         (w.n_heads * D) % kBN == 0 && (w.n_kv_heads * D) % kBN == 0 &&
         w.d_model % kBN == 0 && w.d_ff % kBN == 0 && w.latent % kBN == 0;
}

using Kernel = void (*)(Params);

template <bool FLASH, bool ROWS>
Kernel pick_one(bool clip) {
  return clip ? megastep_kernel<true, FLASH, ROWS>
              : megastep_kernel<false, FLASH, ROWS>;
}

// The library's instantiation, or null for one that REPRO_MEGA_FLASH /
// REPRO_MEGA_ROWS left out of this library (the preprocessor keeps those
// from being compiled at all).
Kernel pick(bool clip, bool flash, bool rows) {
#if REPRO_MEGA_FLASH != 1
#if REPRO_MEGA_ROWS != 1
  if (!flash && !rows) return pick_one<false, false>(clip);
#endif
#if REPRO_MEGA_ROWS != 0
  if (!flash && rows) return pick_one<false, true>(clip);
#endif
#endif
#if REPRO_MEGA_FLASH != 0
#if REPRO_MEGA_ROWS != 1
  if (flash && !rows) return pick_one<true, false>(clip);
#endif
#if REPRO_MEGA_ROWS != 0
  if (flash && rows) return pick_one<true, true>(clip);
#endif
#endif
  return nullptr;
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
    if (k == nullptr) return cudaErrorInvalidValue;
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
  if (K < 1 || w->dtype != kWeightCode || state_dtype < 0 || state_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  cudaError_t err = plan_for(*w, batch, seq, has_clip, flash, rows, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_emb = rows ? batch : K;
  const Layout l = layout(*w, batch, seq, n_emb, plan);
  float* base = static_cast<float*>(ws);
  Params p;
  p.w = *w;
  p.state16 = state_dtype;
  p.round_trunk = k16W && state_dtype == kWeightCode;
  p.x = p.state16 ? nullptr : static_cast<const float*>(x);
  p.out = p.state16 ? nullptr : static_cast<float*>(out);
  p.x16 = p.state16 ? x : nullptr;
  p.out16 = p.state16 ? out : nullptr;
  p.temb = static_cast<const float*>(temb);
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.coefs = static_cast<const float*>(coefs);
  p.K = K;
  p.batch = batch;
  p.seq = seq;
  p.n_emb = n_emb;
  p.n_cnt = static_cast<int>(l.n_cnt);
  p.general = kMixed || !aligned(*w, seq);
  p.clip = clip;
  // sqrtf is correctly rounded: jnp.sqrt(float32(D)) (in a 16-bit trunk
  // sqrt(D) of D in its type, in its type: past 256 a bfloat16 D rounds);
  // 1/sqrt(D) rounded from double, as the flash trunk's Python-float
  // scale.  (The mixed library takes sqrt(D) per layer from w->attn_div.)
  p.attn_div = sqrtf(static_cast<float>(w->head_dim));
  if (p.round_trunk) {
    const float D = static_cast<float>(w->head_dim);
    p.attn_div = kF16W ? __half2float(__float2half_rn(
                             sqrtf(__half2float(__float2half_rn(D)))))
                       : bf16_round_host(sqrtf(bf16_round_host(D)));
  }
  p.q_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(w->head_dim)));
  p.h = base + l.h;
  p.qkv = base + l.qkv;
  p.ao = base + l.ao;
  p.ff = base + l.ff;
  p.th = base + l.th;
  p.tw = base + l.tw;
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

// The launch plan of one instantiation on the current device, into out[9]:
// workspace floats (batch samples of seq tokens, n_emb embeddings), grid
// blocks, blocks per SM, grid barriers per step, dynamic shared memory
// bytes, the split-K factors of wo, w_down and w_out, and whether the
// geometry is the aligned one (its own phase instantiations).  Returns a
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
  out[8] = aligned(*w, seq);
  return 0;
}

// x, out: (batch * seq * latent / 256, 256) tile view, float32
// (state_dtype 0), bfloat16 (1) or float16 (2), sample b at flat offset b *
// seq * latent; w: weights of this library's type (w->dtype); temb: (K,
// time_dim) sinusoidal embeddings of the K timesteps, float32 holding
// values of the state's type; rope_cos / rope_sin: (seq, head_dim / 2),
// float32 (holding the trunk's values in a 16-bit trunk); coefs: (K, 5)
// rows [c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t]; ws: the plan's
// workspace floats (repro_megastep_plan with n_emb = K); trace: null, or 2
// + K (2 + 5 n_layers) uint64 for the phase stamps.  All device pointers,
// 16-byte aligned.  Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for weights of another library's type).
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
