#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from anywhere inside a checkout:  python3 chip_smoke.py

    python3 chip_smoke.py --launch-probe OTHER/src

times only the launch floor and the B1 / B2 pairs of phase 6 for another
checkout's ``src`` (the parent commit, unpacked with git archive), with
the timers of this script, and prints them as JSON lines.

    python3 chip_smoke.py --lm-probe OTHER/src

runs only phase 10's smollm-135m and llama3.2-3b generations, checks and
step profiles for another checkout's ``src``, with this script's code.

    python3 chip_smoke.py --draw-probe OTHER/src

times, for another checkout's ``src``, one scheduler x_T draw, a steady
U-Net scheduler tick, serve samples/s and slot-steps/s at CIFAR10 width,
as one JSON line (the cost of phase 11's draws against the parent).

    python3 chip_smoke.py --tick-probe OTHER/src

times, for another checkout's ``src``, the steady tick of phases 4-9's
unsharded engines (the U-Net scheduler eta 0, eta 1 and order 2 with
preview, probed; the diffusion-LM mega and unfused ticks), as one JSON
line (the engine's state as a list of row blocks against the parent).

It needs one CUDA device and ``nvcc`` (the kernels are built from the
sources in the checkout into build/repro_torch_kernels/).  Phases:

  1. card     name and power limit (nvidia-smi); TF32 off for cuDNN and
              matmul, so float32 convolutions and products are float32
  2. build    every CUDA source of the port (one nvcc each, in parallel),
              timed, with ptxas's register / shared memory / spill lines
              for the megakernel and the B5 / B6 sources
  3. kernels  each kernel against its plain PyTorch version on the card,
              with stated tolerances:
              B1/B2 over det/stoch x clip x float32/bfloat16 x R in {16,
              768 and the main path's 96 and 128} (+ want_x0 for B2);
              B6 rms_norm over f32/bf16 x rows {256, 1000} x d {576, 192,
              190} (190 takes the scalar row path; so does an unaligned
              x at d 576), the row path checked from the launch plan;
              B5 flash_attention over f32/bf16 x causal/not at (36, 64, 64),
              (9, 2048, 64) and (8, 1024, 128) (one-, four- and two-warp
              blocks), with the launch plan printed; B3 megastep_call at
              the slice's shape
              (smollm width, 2 layers, batch 4 x 64 tokens) over
              exact/flash x clip none/1.0 x K {1, 8}; B4 megastep_rows_call
              at the same shape (every slot its own t and coefficient row,
              one idle slot) over exact/flash x clip none/1.0; each of the
              8 megakernel instantiations launched twice on the same
              inputs must give the same bits; B7
              ddim_step_2d over f32/bf16 x R {256, 1024}, C = 256
  4. main     each path with the launch counters zeroed just before it and
              read just after:
              the sampling service at CIFAR10 width: DiffusionSampler
              (tile_resident=True) serves 16 requests (eta=0, S=20) and 8
              (eta=1, S=10), plan.run(backend='rows') runs one batch; B1/B2
              must grow by exactly S per batch; outputs are checked against
              the eager path and the U-Net against its own CPU forward;
              diffusion-LM generate(tile_resident=True) at S=20, batch 4 x
              64 tokens: DLM_SMOLLM_MEGA (2 layers, eligible) must launch B3
              exactly ceil(20/8) = 3 times and B1 0 times, DLM_SMOLLM (30
              layers, not eligible) B3 0 times and B1 20 times, with the
              eligibility reason printed; plan.run 'mega' (exact and flash)
              against 'tile_resident' on the card;
              the attention / norm ops at smollm width and prefill length
              (rms_norm, gqa_flash causal), against the model's plain ones;
              the continuous-batching scheduler on the CIFAR10 U-Net:
              svc.continuous(slots=8, stochastic, max_order 2, preview)
              serves 24 requests (S {10, 20, 50} x tau uniform/quadratic x
              eta 0 order 1 / eta 0 order 2 / eta 1, and 6 whose deadline
              expires in the queue) submitted in two waves; B2 must launch
              once per tick and B1/B3/B4 never; every eta=0 x0 against a
              lone plan.run(backend='eager') of the same x_T;
              the scheduler's mega tick on DLM_SMOLLM_MEGA (4 slots x 64
              tokens, 8 requests S {10, 20}): B4 once per tick, B2 never,
              against a use_mega=False engine, rounded to tokens
  5. times    B1 / B2 alone (det and stoch, R = 96 / 128 and 768),
              graph-replayed and per Python call, beside their bytes bound;
              CUDA-graph-replayed kernel times at the main path's shapes
              beside their bound, the plain versions' and the library
              call's times (B6 at (256, 576), (2048, 576) and (16384, 576);
              B5 at (36, 64, 64) full and (9, 2048, 64) causal, that one
              in bf16 too, with the bound at the float32 SIMT rate beside
              the bound on the units it uses; each with its launch plan);
              the U-Net forward at batch 8; samples/s from
              serve and from generate on 'mega' and 'tile_resident';
              torch.profiler breakdowns of one steady serve batch and of
              one generate call on each of the two backends; B4 per tick,
              B7, the unfused rows tick at the DLM shape; B3 and B4 must
              take less device time than the unfused path of the same
              work, and print their grid, blocks per SM, grid barriers per
              step and a per-phase trace of one launch; the scheduler
              engines' steady slot-steps/s, a profile (device idle share)
              of one steady tick of each engine, and the host time of each
              piece of the mega tick's work before B4
  6. new paths, run after every rate of phase 5 so that those are timed
              from the state they were timed in before these paths existed,
              each counted as in phase 4:
              the paper's encode / decode / interpolation at CIFAR10 width,
              batch 8: plan.encode, then a 'tile_resident' decode at S=20
              and S=50 (B1 exactly S times each) against an 'eager' decode
              of the same latent (1e-5 of max|x|), with the reconstruction
              MSE printed; 8 slerp points between two encodings decoded as
              one batch (B1 S times), whose ends must match the decodes of
              the two latents (1e-5 of max|x|);
              DLM_SMOLLM_MEGA at (2, 128), eligible by the JAX rule but
              past the CUDA megakernel's 64 tokens: generate returns tokens
              through B1 (B3 0 times, run_mega.last_reason printed) and
              'mega' equals 'tile_resident' within 1e-3;
              a torch.profiler breakdown of one decode;
              the launch floor: the sampler-step library's empty kernel,
              graph-replayed and per Python call, at 1 block and at every
              grid B1 / B2 take, beside B1 / B2 alone at that grid; the
              pair "the op that produces eps on the path, then B1 / B2",
              graph-replayed, beside the producer alone (--launch-probe
              times the same for another checkout)
  7. autotuner, run after phase 6 so that every rate of phase 5 is timed
              as before, each path counted as in phase 4, on the CIFAR10
              U-Net: build_objective (grid 16, batch 16, chunk 8) over 16
              seeded x0 images in [-1, 1] (trans against a table rebuilt
              from the same noise within 1e-5, adjacent defects 0);
              search_bank for S in (5, 10), DP then refinement (eta 0 / 1,
              order 1 / 2) scored by fid_proxy through one PlanExecutor at
              batch 16: B1 exactly the sum of S over the deterministic
              rollouts (a stochastic one runs the eager loop, JAX's
              executor's noise), one rollout function per statics, every
              refined score at most its DP plan's, one det rollout bitwise
              equal to plan.run(backend='tile_resident') and one stoch
              rollout to plan.run(backend='eager'); the bank's JSON round
              trip; DiffusionSampler(tile_resident, plan_bank).serve(16,
              "auto") (B1 S per batch, bitwise equal to serve(bank.best()));
              svc.continuous(slots=8, stochastic, order 2, plan_bank)
              serving 8 warm-up requests, then 16 auto_plan requests whose
              deadlines, set from the measured tick EWMA, give 'fit',
              'degraded' and 'quality' admissions: each admitted NFE equal
              to bank.select at the EWMA of its admission, B2 once per
              tick, every eta=0 x0 within SCHED_VS_EAGER_TOL of a lone
              eager run; the objective's and the search's walls, ms per
              rollout and the outcome counters printed, then a
              torch.profiler breakdown of one build_objective and of one
              rollout
  8. telemetry and the fleet, run after phase 7 so that every earlier
              rate is timed as before, each path counted as in phase 4:
              the phase 4 U-Net scheduler (8 slots, stochastic, order 2,
              preview) with probes and a FlightRecorder serves 16 mixed
              requests (S {10, 20} x eta {0, 1}): x0 bitwise a probe-less
              engine's, B2 once per tick, one (8, 6) float32 frame per
              tick, finite_frac 1, each request's quality recomputed from
              its frames with the k = 0 defect discarded; set_probes off /
              on keeps compiled_ticks <= 2; the median tick wall of 24
              probed and 24 plain ticks alternated on one engine, and the
              device time of device_frame and its copy (torch.profiler);
              an Observability(profile=True) engine under torch.profiler:
              each of 3 steady ticks one repro/tick/<variant> range
              holding its B2, the share of device time inside the ranges,
              and format_hbm_table(modeled_hbm_table(engine)) beside B2's
              time; PoolFleet.build (2 pools x 8 slots, stochastic, order
              2, probes, flight_dir) serves 32 requests (8 with an
              affinity key), pool 1 drained mid-run and restored: B2 ==
              the pools' ticks, every request retired once,
              check_spans == [], eta=0 x0 within SCHED_VS_EAGER_TOL of an
              eager run of its x_T, the stats key sets, pool series in
              render_prometheus; render_dashboard and render_summary
              printed, and the fleet's steady slot-steps/s beside one
              8-slot engine's; an eps_params fleet (2 U-Net pools, order
              1): install on an ACTIVE pool refused, a NaN in
              conv_out.weight installed on drained pool 1 shows in its
              frames and the dump's attribution (pool 1, the slot, step
              0), the original weights re-installed give the pre-swap x0
              bitwise, compiled_ticks unmoved; a fleet of 2 DLM_SMOLLM_MEGA
              pools x 4 slots: every pool on the mega tick, B4 == the
              pools' ticks, B2 0, tokens equal one mega engine's (x0 within
              1e-3); probes with use_mega=None raise on that trunk, and
              with use_mega=False serve with B2 once per tick
  9. the gateway, resilience and the serving CLI, run after phase 8 so
              that every earlier rate is timed as before, each path
              counted as in phase 4: GatewayCore.build over the CIFAR10
              U-Net with two models (the seeded weights and a seed-1
              copy), one 8-slot pool each, probes on, supervised, driven
              through EngineBridge by an asyncio client in this process
              (bridge.acall(core.submit, spec, on_event), what every HTTP
              handler calls): 24 requests of S 10 / 20, every third
              streaming previews, the last with a 1 ms deadline submitted
              once every slot is resident: exactly one terminal event
              each, previews before it, 504 for the expired one, every
              x0 bitwise a lone unsupervised 8-slot engine's, B2 == the
              pools' ticks; hot_swap('base', the alt weights) with 8
              requests resident: they finish bitwise on the old weights,
              4 submitted during the walk bitwise on the new ones,
              compiled_ticks unmoved, the version bumped; slot-steps/s of
              the gateway (a warmed engine thread) against the gateway
              core and the same fleet, each pumped in this thread (3
              rounds alternated, medians), p50 / p99 request latency
              through the bridge, the host time per event of copying and
              encoding one x0; a chaos replay on a supervised gateway
              (checkpoint every tick) through the bridge, one FaultPlan:
              nan-eps, tick-latency and corrupted-weights on pool 0 and a
              tick-error on pool 1 right after a dispatch: pool 1
              quarantined, its queued and resident work migrated, a submit
              for its model refused 503 while OPEN, the resumed requests'
              x0 bitwise their uninterrupted lone runs, the NaN request a
              typed 500 with nothing non-finite streamed, health degraded
              then ok after the backoff probe (pumps and seconds from the
              trip to re-admission printed), detect_weight_corruption on
              pool 0's frames naming pool 0, the bridge alive, B2 == the
              pools' ticks; an unsupervised core whose tick raises poisons
              its bridge; python -m repro_torch.launch.serve --arch unet
              --scheduler (slots 4, S 4 / 6 / 8, tau mix, order 2) on the
              card with B2 == its ticks, and --gateway --smoke where
              aiohttp is importable (a line says which)
 10. autoregressive serving, run last so that every earlier rate is
              timed as before: serving.ARGenerator (the card by default) on
              smollm-135m (30 layers, prompt 64) and llama3.2-3b (full
              width, prompt 128), float32 weights drawn on the card, batch
              4 (rows greedy, greedy, T 0.8 top-k 50, T 1.0), 32 new
              tokens, the seven kernels' counters zeroed before each run
              and 0 after it (the path launches none of them): prefill ms,
              decode ms per step, tokens/s; the cache's k / v pointers and
              torch.cuda.memory_allocated the same before every decode
              step; the cache path's logits at every step against the
              cache-free forward over prompt + generated tokens within
              1e-4 of max|logits|, greedy rows equal to forward's argmax
              except near ties (counted); the decode step (its slot,
              rotary tables and mask computed once per step) against the
              per-layer attention.gqa_decode_step composition, JAX's
              decode_step structure (bitwise, or within 1e-6 of
              max|logits|, printed); threefry split / random_bits of every
              step's keys on the card bitwise the CPU's, gumbel within
              ulps, and a CPU replay of _sample_tokens on the copied logits
              equal to the card's tokens except Gumbel near ties; one
              steady decode step (the model, then the generate loop's whole
              step) under torch.profiler: wall, device kernel ms, idle
              share, device ops launched, beside the step's bytes bound
              (weights + KV over the HBM rate); the peak allocated memory;
              then python -m repro_torch.launch.serve --arch smollm-135m
              --batch 4 --new-tokens 16 --device cuda at full width
 11. JAX's draws and training, run last so that every earlier rate is
              timed as before: threefry normal, randint (1, 1001) and
              (0, 2^31 - 1) and truncated_normal(-3, 3) on the card against
              the same keys on the CPU (bitwise; the CPU tests hold the CPU
              bitwise against jax.random); one int seed on the card against
              the port on the CPU at TOY_UNET width, S = 10, the same
              weights: a seeded eta=1 serve (B1), a stochastic 'rows'
              plan.run (B2) and one stochastic scheduler request (B2), each
              within 1e-4 of scale; the CIFAR10 U-Net trained at full width
              (AdamW, warmup_cosine, EMA 0.999, SyntheticImages(32), batch
              32, 30 steps): its first step at batch 2 on the card against
              the CPU (loss and grad norm within 1e-4), first and steady
              step ms, images/s, one step's profile, peak memory, the FLOP
              bound; its init, trained and EMA weights served through B1
              (S=20, 16 samples) and scored with fid_proxy and mmd_rbf
              against a held-out batch; smollm-135m at full width, batch 8
              x 128, accum_steps 2 against 1 from one state (loss and grad
              norm within 1e-4), step ms, tokens/s, peak, bound, profile;
              3 diffusion-LM training_loss steps on DLM_SMOLLM_MEGA; the
              seven counters 0 across every train step; python -m
              repro_torch.launch.train --arch unet --steps 20 writing a
              checkpoint, and python -m repro_torch.launch.serve --arch
              unet --ckpt serving it on the card
 12. the rest of core, JAX's inits and the moe / vlm families, run last
              so that every earlier rate is timed as before: (a) the
              retired fused_ddim_step shim (B1 == calls) against the eager
              Eq. 12 step + noise, and sample(step_impl=) at S=10 against
              the eager plan run; (b) a CFG eps (two CIFAR10 U-Nets) and a
              v-prediction eps served on B1 against the eager service;
              (c) discrete.reverse_sample (K 8, batch 64, S 10) on the card
              replayed step by step on the CPU (every token equal but
              Gumbel near ties, counted); (d) the smoke inits of every
              family bitwise the CPU's; (e) deepseek-v2-236b at full width
              cut to 3 layers (every init leaf's windows redrawn on the
              CPU), (f) llava-next-mistral-7b at full width with 2,880 stub
              image embeddings and (g) kimi-k2-1t-a32b's smoke config
              through ARGenerator: the seven counters 0, the cache path
              against the cache-free model (a moe one routing as the
              server routes) within 1e-4 of max|logits|, one decode step
              profiled, peak memory, the MLA cache against the dense cache
              it replaces; (h) the diffusion-LM on a 2-layer deepseek-width
              MoE trunk: generate(tile_resident=True) B1 once per step,
              'mega' (not eligible) against 'eager'; (j) the serve and
              train CLIs for the moe and vlm smoke ids.  --p12-probe runs
              only the build and this phase
 13. the ssm, hybrid and audio families, run last so that every
              earlier rate is timed as before: (a) rwkv6-7b (its drawn init
              leaves' windows redrawn on the CPU), (b) seamless-m4t-large-v2
              over 1,024 stub frames and (c) zamba2-2.7b, each at full width
              and depth in float32 through ARGenerator, batch 4, 32 new
              tokens: the seven counters 0, the cache path against the
              cache-free model within 1e-4 of max|logits| (each family;
              zamba2's cached recurrence against its chunked SSD
              forward), one prefill and one decode step profiled, peak
              memory; (d) / (e) the
              diffusion-LM on a 2-layer rwkv6-width and a 4-layer
              zamba2-width trunk: generate(tile_resident=True) B1 once per
              step, 'mega' (not eligible) against 'eager'; (f) the serve CLI
              for the three smoke ids.  --p13-probe runs only the build and
              this phase
 14. the examples and the launch tools, run last so that every earlier
              rate is timed as before: each of repro_torch.examples' six
              main()s on the card at the example's own widths and sample
              sizes, the seven counters zeroed before each and read after:
              quickstart (GMM: backends within 1e-4 of eager, B1 == B2 ==
              the check's S; images: TOY_UNET, no kernel), interpolation
              (B1 == its decode's S, DDIM spread at a fixed x_T 0),
              reconstruction (Table 2: MSE falls with S), discrete_ddim,
              lm_diffusion for dense / moe / ssm / hybrid, and gateway_sse
              in process where aiohttp imports (B2 == the pools' ticks + one
              warm-up tick each; every stream previews and a result); every
              printed number finite, each cut of JAX's train steps printed;
              [roofline] phase 10's smollm-135m and llama3.2-3b decode steps
              counted on meta (launch.roofline.count: flops, bytes, terms)
              against their measured device ms; [shapes] every --arch x
              shape id's float32 params + cache bytes (meta) against the
              card's memory.  --p14-probe runs only the build and this phase
 15. mesh-sharded slot pools, run last so that every earlier rate is
              timed as before: (a) the fleet bench's demo trunk
              (state_dim 512, hidden 1024, 4 slots, S in {5, 10, 20}) as a
              PoolFleet on the (1, 1) mesh of the card (make_fleet_mesh,
              make_sharded_eps), x0 bitwise the unsharded engine's; (b) the
              same fleet of 2 pools on simulated (1, 2) and (2, 2) pool
              meshes over [cuda:0] * k (devices=), within rtol / atol 1e-5,
              mesh / state_sharded / compiled_ticks as JAX reports them;
              (c) the CIFAR10 U-Net in one engine with mesh= on a
              simulated (2, 1) mesh through sharded_eps_from_apply, within
              1e-5 of max|x| of the unsharded engine.  The B2 counter is
              zeroed before each path and must read ticks x data shards
              after it; each path's steady tick wall is printed beside the
              unsharded one, labelled simulated (no scaling figure).
              --p15-probe runs only the build and this phase

Every time is printed beside the card's name and power limit.  Any failure
raises and the script exits nonzero with no result line.  On success the
second-to-last line is the kernels' JSON record (B1 / B2 with floor_ms and
the pair's times) and the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_ULP = 2.0 ** -23
BF16_ULP = 2.0 ** -7
CARD_SHAPE = (32, 32, 3)
BATCH = 8
KERNEL_SOURCE = "src/repro_torch/kernels/sampler_step/csrc/sampler_step.cu"
TPU_KERNEL = "src/repro/kernels/sampler_step/kernel.py"
DLM_BATCH, DLM_SEQ, DLM_S, DLM_K = 4, 64, 20, 8
MEGA_FALLBACK = (2, 128)       # (batch, seq_len) past the megakernel's limits
ODE_S = (20, 50)               # encode / decode trajectory lengths
ODE_VS_EAGER_TOL = 1e-5        # of max|x|, the U-Net tolerance on the card
SLERP_POINTS = 8
SCHED_SLOTS = 8
SCHED_VS_EAGER_TOL = 1e-5      # of max|x|, scheduler eta=0 vs a lone eager run
DLM_SCHED_S = (10, 20)
B7_COEFS = (0.93, 0.31, 0.27, 0.61, 0.79)
# name -> (source, the TPU kernel's function file:line) of the DLM slice
DLM_KERNELS = {
    "megastep_call": ("src/repro_torch/kernels/megastep/csrc/megastep.cu",
                      "src/repro/kernels/megastep/kernel.py:232"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:118"),
    "rms_norm_2d": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:38"),
}
# name -> (source, the TPU kernel's function file:line) of the scheduler slice
SCHED_KERNELS = {
    "megastep_rows_call": (
        "src/repro_torch/kernels/megastep/csrc/megastep.cu",
        "src/repro/kernels/megastep/kernel.py:269"),
    "ddim_step_2d": ("src/repro_torch/kernels/ddim_step/csrc/ddim_step.cu",
                     "src/repro/kernels/ddim_step/kernel.py:43"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ----------------------------------------------------------------- timing
def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def loop_ms(fn, iters: int = 200) -> float:
    """Time of one call of ``fn`` issued from Python in a loop (CUDA
    events): what the step loop pays per launch, host overhead included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ``repro_torch.launch.roofline``: the card's data-sheet rates (H100 SXM,
# dense, 700 W) as HBM_BW and PEAK_FLOPS_*, and the step counter.  Imported
# in ``main`` once the checkout's ``src`` is on the path.
RL = None


def bound_ms(n_elems: int, elem_bytes: int, n_streams: int,
             extra_bytes: int, ops_per_elem: int):
    """Least time for the step: bytes over HBM rate vs ops over fp32 rate."""
    t_bytes = (n_elems * elem_bytes * n_streams + extra_bytes) \
        / RL.HBM_BW * 1e3
    t_ops = n_elems * ops_per_elem / RL.PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Operations per element of the timed variants (no clip), counted from the
# body of csrc/sampler_step.cu.  An FMA counts 2, logf / sqrtf / cosf 1
# each; the PRNG's integer ops are counted at the float32 rate (the data
# sheet gives none for int32), which can only shorten the bound.  Index
# arithmetic and the per-launch coefficients and keys are not counted.
#   step:  b*eps, fma(a, x, .)                                       =  3
#   noise: 2 draws x 11 (xor, mul, add; fmix32: 3 shift, 3 xor, 2 mul)
#          + Box-Muller 13 (2 shift, 2 cvt, add, 5 mul, log, sqrt, cos)
#          + fma(c_noise, z, out) 2                                  = 37
OPS_STEP, OPS_NOISE = 3, 37


def main_rows():
    """Rows of the (R, 256) state the main path gives each kernel at batch
    BATCH: the tile layout (B1) and the slot layout (B2)."""
    from repro_torch.kernels.sampler_step import ops
    r_main = ops.to_tile_layout(
        torch.empty((BATCH,) + CARD_SHAPE, device="meta"))[0].shape[0]
    return r_main, BATCH * ops.slot_rows(CARD_SHAPE)


# ----------------------------------------------------------------- phases
def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} built/loaded in "
          f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name in ("megastep", "flash_attention", "rmsnorm", "ddim_step"):
        lines = [ln.strip() for ln in build.build_log(name).splitlines()
                 if "Used" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        spills = [ln for ln in lines if "spill" in ln and not re.search(
            r"(?<!\d)0 bytes spill stores, 0 bytes spill loads", ln)]
        print(f"[build] {name}: {len(lines)} ptxas lines, {len(spills)} "
              f"with spills")
        full = name in ("megastep", "flash_attention", "rmsnorm")
        for ln in (lines if full else spills)[:96]:
            print(f"[build]   {ln}")


def _tolerance(dtype, exact: bool, scale: float) -> float:
    if dtype == torch.bfloat16:
        return BF16_ULP * scale          # one bf16 ulp of max|out|
    return 0.0 if exact else 4 * F32_ULP * scale


def _report(errs, name, got, want, dtype, exact) -> None:
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = _tolerance(dtype, exact, scale)
    ok = bool(torch.isfinite(got).all()) and err <= tol
    print(f"[kernels] {name:<44} max|d|={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: max|d| {err} > tol {tol}")
    errs.append(err)


def phase_kernels():
    """B1 and B2 against their plain versions on the card."""
    from repro_torch.kernels.sampler_step import kernel, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    coefs = torch.tensor([0.9, 0.3, 1.0, 0.6, 0.8])   # c_noise = 1.0
    errs = {"sampler_step_2d": [], "sampler_step_rows_2d": []}
    # the 8-row granule, the main path's shapes (B1's and B2's), 256-row tiles
    for R in sorted({16, *main_rows(), 768}):
        x32 = torch.randn(R, 256, generator=gen, device=dev) * 2
        e32 = torch.randn(R, 256, generator=gen, device=dev)
        row_coefs = torch.rand(R, 8, generator=gen, device=dev) * 0.9 + 0.1
        row_coefs[:, 2] = 1.0
        row_seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (R,),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            x, e = x32.to(dtype), e32.to(dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"
            for clip in (None, 1.0):
                for stoch in (False, True):
                    name = (f"R={R} {tag} clip={clip} "
                            f"{'stoch' if stoch else 'det'}")
                    exact = not stoch and clip is None
                    got = kernel.sampler_step_2d(
                        x, e, coefs, -98765, clip=clip, stochastic=stoch)
                    want = ref.sampler_step_2d(
                        x, e, coefs.to(dev), -98765, clip=clip,
                        stochastic=stoch)
                    _report(errs["sampler_step_2d"], "B1 " + name, got,
                            want, dtype, exact)
                    for want_x0 in (False, True):
                        kw = dict(clip=clip, stochastic=stoch,
                                  want_x0=want_x0)
                        got = kernel.sampler_step_rows_2d(
                            x, e, row_coefs, row_seeds, **kw)
                        want = ref.sampler_step_rows_2d(
                            x, e, row_coefs, row_seeds, **kw)
                        sub = f"B2 {name}{' x0' if want_x0 else ''}"
                        if want_x0:
                            _report(errs["sampler_step_rows_2d"],
                                    sub + " [x0]", got[1], want[1], dtype,
                                    exact=dtype == torch.float32)
                            got, want = got[0], want[0]
                        _report(errs["sampler_step_rows_2d"], sub, got,
                                want, dtype, exact and not want_x0)
    torch.cuda.synchronize()
    return {k: max(v) for k, v in errs.items()}


def _cifar10_model(seed: int = 0):
    """The CIFAR10-width U-Net, JAX's init of PRNGKey(seed), with the
    near-zero leaves re-drawn at fan-in scale so that eps is O(1)."""
    from repro_torch import prng
    from repro_torch.configs import CIFAR10_UNET
    from repro_torch.models.unet import init_params
    gen = torch.Generator().manual_seed(seed)
    model = init_params(prng.PRNGKey(seed), CIFAR10_UNET, device="cuda")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("conv2.weight", "wo.weight",
                              "conv_out.weight")):
                w = torch.nn.init.trunc_normal_(
                    torch.empty(p.shape), 0.0, 1.0, -3.0, 3.0,
                    generator=gen)
                p.copy_(w * p[0].numel() ** -0.5)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] CIFAR10_UNET: {n_params / 1e6:.2f} M parameters")
    return model.eval()


def phase_main(model):
    from repro_torch import prng
    from repro_torch.core.schedules import make_schedule
    from repro_torch.kernels.sampler_step import kernel
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.sampling import SamplerPlan
    from repro_torch.serving import DiffusionSampler
    dev = torch.device("cuda")
    eps_fn = make_eps_fn(model)
    schedule = make_schedule("linear", 1000)
    svc = DiffusionSampler(schedule, eps_fn, CARD_SHAPE, batch_size=BATCH,
                           tile_resident=True)
    det = SamplerPlan.build(schedule, 20)
    sto = SamplerPlan.build(schedule, 10, sigma=1.0)
    gen = torch.Generator(device=dev).manual_seed(5)
    x_rows = torch.randn((BATCH,) + CARD_SHAPE, generator=gen, device=dev)

    # --- the main path, counted
    kernel.sampler_step_2d.launches = 0
    kernel.sampler_step_rows_2d.launches = 0
    out_det, st_det = svc.serve(16, det, seed=1)
    n1 = kernel.sampler_step_2d.launches
    out_sto, st_sto = svc.serve(8, sto, seed=2)
    n2 = kernel.sampler_step_2d.launches - n1
    out_rows = sto.run(eps_fn, x_rows, prng.PRNGKey(5), backend="rows")
    torch.cuda.synchronize()
    launches = {"sampler_step_2d": kernel.sampler_step_2d.launches,
                "sampler_step_rows_2d": kernel.sampler_step_rows_2d.launches}
    print(f"[main] launches: {launches} (serve det {n1}, serve eta=1 {n2})")
    check(n1 == 2 * det.S, f"det serve launched B1 {n1} times, want "
          f"{2 * det.S}")
    check(n2 == sto.S, f"eta=1 serve launched B1 {n2} times, want {sto.S}")
    check(launches["sampler_step_rows_2d"] == sto.S,
          f"rows run launched B2 {launches['sampler_step_rows_2d']} times")
    for name, out, n in (("serve det", out_det, 16),
                         ("serve eta=1", out_sto, 8),
                         ("rows eta=1", out_rows, BATCH)):
        ok = out.shape == (n,) + CARD_SHAPE and bool(torch.isfinite(out)
                                                     .all())
        print(f"[main] {name}: shape {tuple(out.shape)} finite "
              f"{bool(torch.isfinite(out).all())} max|x| "
              f"{float(out.abs().max()):.4g}")
        check(ok, f"{name}: bad shape or non-finite output")
    print(f"[main] serve det stats: {st_det}")
    print(f"[main] serve eta=1 stats: {st_sto}")

    # --- correctness against the repo's own references
    x_T = torch.randn((BATCH,) + CARD_SHAPE, generator=gen, device=dev)
    a = det.run(eps_fn, x_T, backend="tile_resident")
    b = det.run(eps_fn, x_T, backend="eager")
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"[main] tile_resident vs eager, eta=0 S=20 batch {BATCH}: "
          f"max|d|/max|x| = {rel:.3e} (tol 1e-3)")
    check(rel <= 1e-3, f"tile_resident vs eager: {rel} > 1e-3")
    t = torch.tensor([999], device=dev, dtype=torch.int32)
    with torch.no_grad():
        on_card = model(x_T[:1], t).cpu()
        on_cpu = copy.deepcopy(model).cpu()(x_T[:1].cpu(), t.cpu())
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    print(f"[main] U-Net forward card vs CPU, batch 1: max|d|/max|eps| = "
          f"{rel:.3e} (tol 1e-4), max|eps| = {float(on_cpu.abs().max()):.3g}")
    check(rel <= 1e-4, f"U-Net card vs CPU: {rel} > 1e-4")
    return launches, st_det, svc, det


def phase_main_ode(smi, model):
    """The paper's encode -> decode (Table 2) and slerp interpolation
    (Fig. 6) at CIFAR10 width, counted: every decode runs 'tile_resident'
    and launches B1 exactly S times, and is held against an 'eager' decode
    of the same latent on the card, within ODE_VS_EAGER_TOL of max|x|."""
    from repro_torch.core import slerp
    from repro_torch.core.schedules import make_schedule
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.sampling import SamplerPlan
    eps_fn = make_eps_fn(model)
    sch = make_schedule("linear", 1000)
    gen = torch.Generator(device="cuda").manual_seed(41)
    x0 = torch.randn((BATCH,) + CARD_SHAPE, generator=gen,
                     device="cuda").clamp(-1.0, 1.0)      # image-scale data

    def decode(plan, z, what):
        _zero_counts()
        out = plan.run(eps_fn, z, backend="tile_resident")
        torch.cuda.synchronize()
        counts = _counts()
        check(counts == {"B1": plan.S, "B2": 0, "B3": 0, "B4": 0},
              f"{what}: launches {counts}, want B1 == S == {plan.S}")
        return out, counts["B1"]

    launches = 0
    for S in ODE_S:
        plan = SamplerPlan.build(sch, S)
        z = plan.encode(eps_fn, x0)
        rec, n1 = decode(plan, z, f"decode S={S}")
        launches += n1
        want = plan.run(eps_fn, z, backend="eager")
        rel = float((rec - want).abs().max() / want.abs().max())
        mse = float(((rec - x0) ** 2).mean())
        print(f"[main] {smi} | encode -> decode CIFAR10_UNET batch "
              f"{BATCH}, S={S} (uniform tau): B1 launches {n1}; decode "
              f"tile_resident vs eager max|d|/max|x| = {rel:.3e} (tol "
              f"{ODE_VS_EAGER_TOL:g});"
              f" max|z| {float(z.abs().max()):.4g}; reconstruction MSE per "
              f"dimension {mse:.4e} (random weights: not a quality figure)")
        check(bool(torch.isfinite(rec).all()) and rec.shape == x0.shape
              and rel <= ODE_VS_EAGER_TOL,
              f"decode S={S}: tile_resident vs eager {rel}")
    plan = SamplerPlan.build(sch, ODE_S[0])
    z = plan.encode(eps_fn, x0[:2])
    alphas = torch.linspace(0.0, 1.0, SLERP_POINTS, device="cuda")
    path, n1 = decode(plan, slerp(z[0], z[1], alphas), "slerp decode")
    launches += n1
    ends = plan.run(eps_fn, z, backend="tile_resident")
    rel = max(float((path[i] - ends[j]).abs().max() / ends[j].abs().max())
              for i, j in ((0, 0), (-1, 1)))
    print(f"[main] {smi} | slerp: {SLERP_POINTS} points between two "
          f"encodings, decoded as one batch (S={plan.S}): B1 launches {n1}; "
          f"alpha 0 / 1 vs the decodes of the two latents: max|d|/max|x| "
          f"= {rel:.3e} (tol {ODE_VS_EAGER_TOL:g}); path shape "
          f"{tuple(path.shape)}")
    check(bool(torch.isfinite(path).all()) and rel <= ODE_VS_EAGER_TOL,
          f"slerp endpoints: {rel} > {ODE_VS_EAGER_TOL}")
    return launches


def profile_call(smi: str, label: str, fn, marker: str) -> None:
    """torch.profiler over one steady call of ``fn``: device kernel time by
    kernel, and the device's idle share of the same call's wall time
    measured without the profiler (its host cost slows the loop).
    ``marker`` picks the port's kernel out of the kernel names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows) / 1e3
    if busy_ms == 0:
        print(f"[profile] {smi} | {label}: the profiler saw no device "
              "time: device busy/idle share not measured")
        return
    mine_ms = sum(r[1] for r in rows if marker in r[0]) / 1e3
    print(f"[profile] {smi} | {label}: wall {wall_ms:.1f} ms unprofiled "
          f"({prof_wall_ms:.1f} ms profiled), device kernels "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{marker} {mine_ms:.3f} ms, {len(rows)} kernels")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile]   {us / 1e3:8.3f} ms  {count:5d}x  {key[:90]}")


def phase_times(smi: str, model, errs, launches, st_det):
    """B1 / B2 alone at the main path's R and at 768, the U-Net forward and
    serve's samples/s.  Returns B1 / B2's records, and their times alone by
    (name, R, stochastic) for phase_launch."""
    from repro_torch.kernels.sampler_step import kernel, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    coefs = torch.tensor([0.9, 0.3, 1.0, 0.6, 0.8])
    coefs_dev = coefs.to(dev)
    records, alone = {}, {}
    r_main, rows_main = main_rows()
    for kname, shapes in (("sampler_step_2d", (r_main, 768)),
                          ("sampler_step_rows_2d", (rows_main, 768))):
        for R in shapes:
            x = torch.randn(R, 256, generator=gen, device=dev)
            e = torch.randn(R, 256, generator=gen, device=dev)
            rc = torch.rand(R, 8, generator=gen, device=dev) + 0.1
            rs = torch.randint(0, 2 ** 31 - 1, (R,), generator=gen,
                               device=dev, dtype=torch.int32)
            for stoch in (False, True):
                if kname == "sampler_step_2d":
                    fn = lambda: kernel.sampler_step_2d(  # noqa: E731
                        x, e, coefs, 7, stochastic=stoch)
                    plain = lambda: ref.sampler_step_2d(  # noqa: E731
                        x, e, coefs_dev, 7, stochastic=stoch)
                    extra = 0
                else:
                    fn = lambda: kernel.sampler_step_rows_2d(  # noqa: E731
                        x, e, rc, rs, stochastic=stoch)
                    plain = lambda: ref.sampler_step_rows_2d(  # noqa: E731
                        x, e, rc, rs, stochastic=stoch)
                    extra = R * (8 * 4 + (4 if stoch else 0))
                n = R * 256
                ops_pe = OPS_STEP + (OPS_NOISE if stoch else 0)
                b_ms, b_by = bound_ms(n, 4, 3, extra, ops_pe)
                t = {"ms": graph_ms(fn), "plain_ms": graph_ms(plain),
                     "call_ms": loop_ms(fn), "bound_ms": b_ms,
                     "bound_by": b_by}
                alone[kname, R, stoch] = t
                variant = "stoch" if stoch else "det"
                print(f"[times] {smi} | {kname} R={R} f32 {variant}: "
                      f"kernel {t['ms'] * 1e3:.2f} us (graph), "
                      f"{t['call_ms'] * 1e3:.2f} us per Python call; "
                      f"plain {t['plain_ms'] * 1e3:.2f} us; bound "
                      f"{b_ms * 1e3:.3f} us ({b_by})")
                if R == shapes[0] and not stoch:
                    records[kname] = dict(t, R=R, variant="f32 det")
    x = torch.randn((BATCH,) + CARD_SHAPE, generator=gen, device=dev)
    t = torch.full((BATCH,), 500, device=dev, dtype=torch.int32)
    with torch.no_grad():
        unet_ms = loop_ms(lambda: model(x, t), iters=20)
    print(f"[times] {smi} | U-Net CIFAR10 forward batch {BATCH}: "
          f"{unet_ms:.3f} ms")
    print(f"[times] {smi} | serve eta=0 S=20 batch {BATCH}: steady "
          f"{st_det['steady_batch_s'] * 1e3:.1f} ms/batch, "
          f"{st_det['samples_per_s']:.2f} samples/s")
    kernels = []
    for kname, line in (("sampler_step_2d", 200),
                        ("sampler_step_rows_2d", 288)):
        r = records[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_KERNEL}:{line}",
            "launches": launches[kname], "max_abs_err": errs[kname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "call_ms": r["call_ms"], "R": r["R"],
            "variant": r["variant"]})
    return kernels, alone


# ------------------------------------------------------- the autotuner slice
AUTO_BUDGETS = (5, 10)         # the searched step budgets
AUTO_N = 16                    # x0 images, rollout batch, served requests
AUTO_SLOTS = 8


def phase_autotuner(smi, model):
    """The trajectory autotuner at CIFAR10 width (phase 7), each path
    counted as in phase 4: the objective over 16 seeded x0 images, the DP +
    refinement search of a bank for S in AUTO_BUDGETS scored by fid_proxy
    through one PlanExecutor (B1 S times per deterministic rollout; a
    stochastic one runs the eager loop), the bank's JSON round
    trip, ``serve(16, "auto")`` (B1 S times per batch) and a bank-driven
    scheduler (B2 once per tick) whose deadlines, set from its measured
    tick EWMA, give 'fit', 'degraded' and 'quality' admissions.  Returns
    (B1, B2) launches of the counted paths."""
    from repro_torch import prng
    import tempfile
    from repro_torch.autoplan import (ObjectiveConfig, PlanBank,
                                      PlanExecutor, RefineConfig,
                                      SearchConfig, build_objective,
                                      search_bank)
    from repro_torch.core.schedules import make_schedule
    from repro_torch.eval import fid_proxy, transition_elbo_table
    from repro_torch.kernels.sampler_step import ops as sops
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.obs import ListSink, Observability
    from repro_torch.sampling import SamplerPlan, TauSpec
    from repro_torch.serving import (DiffusionSampler, SampleRequest,
                                     SlotCheckpoint)
    dev = torch.device("cuda")
    sch = make_schedule("linear", 1000)
    eps_fn = make_eps_fn(model)
    gen = torch.Generator(device=dev).manual_seed(71)
    x0 = torch.rand((AUTO_N,) + CARD_SHAPE, generator=gen,
                    device=dev) * 2.0 - 1.0           # images in [-1, 1]
    x_T = torch.randn((AUTO_N,) + CARD_SHAPE, generator=gen, device=dev)

    # --- objective (no step kernel on this path)
    cfg = ObjectiveConfig(grid_size=16, batch=AUTO_N, chunk=8)
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = build_objective(sch, eps_fn, x0, cfg)
    torch.cuda.synchronize()
    objective_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _counts()
    check(counts == {"B1": 0, "B2": 0, "B3": 0, "B4": 0},
          f"objective launched {counts}")
    noise = prng.normal(prng.PRNGKey(cfg.seed, dev),
                        (len(table.grid),) + tuple(x0.shape))
    again = transition_elbo_table(sch, eps_fn, x0, grid=table.grid,
                                  eta=cfg.eta, recon_sigma=cfg.recon_sigma,
                                  chunk=cfg.chunk, noise=noise)
    const = 0.5 * math.log(2.0 * math.pi * cfg.recon_sigma ** 2)
    a, b = table.elbo.trans.copy(), again.trans.copy()
    a[0, 1:] -= const                 # compare the mse-scaled part
    b[0, 1:] -= const
    fin = [(i, j) for i in range(a.shape[0]) for j in range(a.shape[1])
           if math.isfinite(b[i, j])]
    same_inf = all((math.isinf(a[i, j]) == math.isinf(b[i, j]))
                   for i in range(a.shape[0]) for j in range(a.shape[1]))
    rel = max(abs(a[i, j] - b[i, j]) / max(abs(b[i, j]), 1e-300)
              for i, j in fin)
    adjacent = [float(table.defect[j - 1, j])
                for j in range(1, table.defect.shape[0])]
    n_pairs = sum(1 for j in range(2, len(table.grid) + 1)
                  for _ in range(j - 1))
    print(f"[auto] {smi} | objective CIFAR10_UNET: grid {len(table.grid)} "
          f"({cfg.grid_kind}), batch {cfg.batch}, chunk {cfg.chunk}: "
          f"{len(table.grid)} timestep evals + {n_pairs} pair evals "
          f"({n_pairs * cfg.batch} images in one U-Net call) in "
          f"{objective_s:.3f} s, peak device memory {peak_gb:.2f} GB; "
          f"trans vs a table rebuilt from the same "
          f"noise: max rel {rel:.3e} (tol 1e-5); adjacent defects "
          f"{set(adjacent)}; max defect {float(table.defect.max()):.4g}")
    check(same_inf and rel <= 1e-5, f"objective trans vs rebuilt: {rel}")
    check(all(v == 0.0 for v in adjacent), "adjacent defects not 0")
    check(bool((table.defect >= 0).all()) and table.defect.max() > 0,
          "defect table empty or negative")

    # --- search: DP + refinement, every candidate a PlanExecutor rollout
    ex = PlanExecutor(eps_fn)
    rollouts = []

    def score(plan):
        g = prng.PRNGKey(77, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ex.run(plan, x_T, g if plan.stochastic else None)
        torch.cuda.synchronize()
        rollouts.append((plan, time.perf_counter() - t1))
        return fid_proxy(out, x0)

    refine = RefineConfig(eta_grid=(0.0, 1.0), orders=(1, 2))
    _zero_counts()
    t0 = time.perf_counter()
    bank = search_bank(sch, table, SearchConfig(budgets=AUTO_BUDGETS,
                                                refine=refine),
                       score_fn=score, model_digest="chip_smoke:71")
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    counts = _counts()
    statics = {(p.S, p.order, p.stochastic, p.x0.clip) for p, _ in rollouts}
    # deterministic rollouts run the tile-resident loop (B1 per step);
    # stochastic ones the eager loop, JAX's executor's noise
    sum_s = sum(p.S for p, _ in rollouts if not p.stochastic)
    ms = [dt * 1e3 for _, dt in rollouts]
    print(f"[auto] {smi} | search_bank budgets {AUTO_BUDGETS}, refine "
          f"eta {refine.eta_grid} orders {refine.orders}: {len(rollouts)} "
          f"rollouts (batch {AUTO_N}, sum of S over the deterministic "
          f"ones {sum_s}) in {search_s:.3f} s;"
          f" ms per rollout {statistics.median(ms):.2f} median "
          f"({min(ms):.2f}-{max(ms):.2f}); executor compiled {ex.compiled} "
          f"for {len(statics)} statics; launches {counts}")
    check(counts == {"B1": sum_s, "B2": 0, "B3": 0, "B4": 0},
          f"search launched {counts}, want B1 == {sum_s}")
    check(ex.compiled == ex.traces == len(statics) and ex.calls
          == len(rollouts), f"executor compiled {ex.compiled} traces "
          f"{ex.traces} calls {ex.calls}, statics {len(statics)}")
    b1_auto = counts["B1"]
    for e in bank.entries:
        dp_plan = SamplerPlan.build(sch, TauSpec.explicit(e.meta["dp_taus"]))
        dp_score = score(dp_plan)
        print(f"[auto] {smi} | bank row nfe {e.nfe}: taus {list(e.taus)}, "
              f"sigma {e.sigma.kind} eta {e.sigma.eta}, order {e.order}, "
              f"DP objective {e.objective:.6g}, score {e.score:.6g} (the DP "
              f"plan's {dp_score:.6g}), {e.meta['refine_trials']} trials")
        check(e.score <= dp_score, f"nfe {e.nfe}: refined {e.score} > DP "
              f"plan {dp_score}")
    det = next(p for p, _ in rollouts if not p.stochastic)
    sto = next((p for p, _ in rollouts if p.stochastic), None)
    for p in [det] + ([sto] if sto is not None else []):
        got = ex.run(p, x_T, prng.PRNGKey(5, dev) if p.stochastic else None)
        backend = "eager" if p.stochastic else "tile_resident"
        want = p.run(eps_fn, x_T, prng.PRNGKey(5, dev) if p.stochastic
                     else None, backend=backend)
        same = torch.equal(got, want)
        print(f"[auto] executor vs plan.run(backend='{backend}'), "
              f"{'stoch' if p.stochastic else 'det'} S={p.S}: bitwise {same}")
        check(same, f"executor vs {backend} ({p})")
    check(sto is not None, "the search ran no stochastic candidate")
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/bank.json"
        bank.save(path)
        loaded = PlanBank.load(path, sch)
    check(loaded.to_json() == bank.to_json()
          and all(loaded.plan(n) == bank.plan(n) for n in bank.nfes),
          "bank JSON round trip")
    print(f"[auto] bank JSON round trip: {len(loaded)} rows, nfes "
          f"{loaded.nfes}, search wall_s {bank.search_config['wall_s']:.3f}")

    # --- lockstep service: serve(16, "auto")
    svc = DiffusionSampler(sch, eps_fn, CARD_SHAPE, batch_size=BATCH,
                           tile_resident=True, plan_bank=bank, device=dev)
    best = bank.best()
    _zero_counts()
    out, st = svc.serve(AUTO_N, "auto", seed=13)
    torch.cuda.synchronize()
    counts = _counts()
    want_b1 = st["batches"] * best.S
    print(f"[auto] {smi} | serve({AUTO_N}, 'auto'): S={best.S}, "
          f"{st['batches']} batches, {st['samples_per_s']:.2f} samples/s "
          f"steady; launches {counts}")
    check(counts == {"B1": want_b1, "B2": 0, "B3": 0, "B4": 0},
          f"serve auto launched {counts}, want B1 == {want_b1}")
    b1_auto += counts["B1"]
    ref, _ = svc.serve(AUTO_N, best, seed=13)
    check(torch.equal(out, ref) and bool(torch.isfinite(out).all()),
          "serve('auto') vs serve(bank.best())")

    # --- scheduler: bank-driven admission at the measured tick EWMA
    obs = Observability()
    sink = obs.add_sink(ListSink())
    eng = svc.continuous(slots=AUTO_SLOTS, stochastic=True, max_order=2,
                         obs=obs)
    gen = torch.Generator(device=dev).manual_seed(72)
    _zero_counts()
    warm = [SampleRequest(request_id=1000 + i, plan=bank.plan(min(
        bank.nfes)), seed=1000 + i) for i in range(AUTO_SLOTS)]
    eng.serve(warm)
    e0 = eng.tick_ewma_s
    check(e0 is not None and e0 > 0, "no tick EWMA after the warm-up")
    t_sub = time.perf_counter()
    reqs, x_nat = [], {}
    # EDF: 'degraded' (3 ticks) < 'fit' to the small row (7.8) < 'fit' to
    # the large row (44) < no deadline ('quality')
    for i, ticks in enumerate([3.0] * 4 + [7.8] * 4 + [44.0] * 4
                              + [None] * 4):
        x = torch.randn((1,) + CARD_SHAPE, generator=gen, device=dev)
        x_nat[i] = x
        reqs.append(SampleRequest(
            request_id=i, auto_plan=True, seed=i,
            deadline=None if ticks is None else t_sub + ticks * e0
            / eng.select_margin,
            resume=SlotCheckpoint(request_id=i, k=0, hist_rows=None,
                                  x_rows=sops.to_slot_tile_layout(x)[0])))
    for r in reqs:
        eng.submit(r, now=t_sub)
    ewma_at, results = {}, []
    while len(eng.queue) or eng.active:
        now = time.perf_counter()
        ewma_at[round(now, 9)] = eng.tick_ewma_s
        results += eng.tick(now=now)
    torch.cuda.synchronize()
    counts = _counts()
    st = eng.stats()
    selects = {e["req"]: e for e in sink.events if e["ev"] == "select"}
    outcomes = {}
    for r in reqs:
        e = selects[r.request_id]
        outcomes[e["outcome"]] = outcomes.get(e["outcome"], 0) + 1
        headroom = (math.inf if r.deadline is None
                    else max(r.deadline - e["t"], 0.0))
        want = bank.select(headroom, ewma_at[e["t"]],
                           margin=eng.select_margin, max_order=2, clip=None)
        check(r.plan is not None and r.plan.S == want.S == e["nfe"],
              f"request {r.request_id}: admitted NFE {r.plan.S}, "
              f"select says {want.S}")
    by_id = {r.request_id: r for r in results}
    worst, n_det = 0.0, 0
    for r in reqs:
        res = by_id[r.request_id]
        check(res.x0 is not None and res.x0.shape == CARD_SHAPE
              and bool(torch.isfinite(res.x0).all()) and res.auto_plan
              and res.nfe == r.plan.S, f"request {r.request_id}: bad result")
        if r.plan.stochastic:
            continue
        lone = r.plan.run(eps_fn, x_nat[r.request_id], backend="eager")[0]
        worst = max(worst, float((res.x0 - lone).abs().max()
                                 / lone.abs().max()))
        n_det += 1
    reg = {dict(i.labels).get("outcome"): int(i.value)
           for i in obs.registry.instruments()
           if i.name == "engine_bank_outcome_total"}
    nfes = {dict(i.labels)["nfe"]: int(i.value)
            for i in obs.registry.instruments()
            if i.name == "engine_bank_nfe_total"}
    print(f"[auto] {smi} | scheduler CIFAR10_UNET slots {AUTO_SLOTS} "
          f"(stochastic, order 2), {len(warm)} warm-up + {len(reqs)} "
          f"auto_plan requests: EWMA after warm-up {e0 * 1e3:.2f} ms, "
          f"{st['ticks']} ticks, bank_selected {st['bank_selected']}, "
          f"outcomes {reg}, NFE {nfes}, deadline_missed "
          f"{st['deadline_missed']}, compiled_ticks {st['compiled_ticks']}; "
          f"launches {counts}")
    print(f"[auto] scheduler eta=0 x0 vs lone plan.run(backend='eager') of "
          f"the same x_T, {n_det} requests: worst max|d|/max|x| = "
          f"{worst:.3e} (tol {SCHED_VS_EAGER_TOL:g})")
    check(counts == {"B1": 0, "B2": st["ticks"], "B3": 0, "B4": 0},
          f"scheduler launched {counts}, want B2 == ticks {st['ticks']}")
    check(st["bank_selected"] == len(reqs) and st["compiled_ticks"] == 1
          and st["completed"] == len(reqs) + len(warm),
          f"scheduler stats {st}")
    check(all(outcomes.get(k, 0) > 0 for k in ("fit", "degraded",
                                               "quality"))
          and outcomes == reg, f"outcomes {outcomes} / counters {reg}")
    check(n_det > 0 and worst <= SCHED_VS_EAGER_TOL,
          f"scheduler vs lone eager: {worst} > {SCHED_VS_EAGER_TOL:g}")
    # after every counted path
    profile_call(smi, f"build_objective (grid {cfg.grid_size}, batch "
                 f"{cfg.batch}, chunk {cfg.chunk})",
                 lambda: build_objective(sch, eps_fn, x0, cfg), "step_kernel")
    p = next(p for p, _ in rollouts
             if p.S == max(AUTO_BUDGETS) and not p.stochastic)
    profile_call(smi, f"one PlanExecutor rollout (S={p.S}, batch {AUTO_N}, "
                 f"eta=0)", lambda: ex.run(p, x_T), "step_kernel")
    return b1_auto, counts["B2"]


# ------------------------------------------- phase 8: telemetry and fleet
P8_SLOTS = 8
P8_COST_TICKS = 24             # probed and plain ticks alternated, each
P8_FLEET_N = 32                # requests the U-Net fleet serves
P8_RATE_ROUNDS = 3             # fleet / one-engine rate rounds, alternated


def _p8_requests(n, base=0, key_every=0):
    """``n`` U-Net requests, S {10, 20} x eta {0, 1}, x_T drawn by the
    engine from the request's seed; every ``key_every``-th carries an
    affinity key (3 or 8 in turn)."""
    from repro_torch.serving import SampleRequest
    return [SampleRequest(
        request_id=base + i, S=(10, 20)[i % 2], eta=float(i // 2 % 2),
        seed=base + i,
        affinity_key=((3, 8)[i // key_every % 2]
                      if key_every and i % key_every == 0 else None))
        for i in range(n)]


def _x_T(seed):
    """The x_T an engine on the card draws for ``seed``."""
    from repro_torch import prng
    return prng.normal(prng.PRNGKey(int(seed)), (1,) + CARD_SHAPE)


def _vs_eager(eps_fn, sch, results, reqs):
    """Worst max|d|/max|x| of the eta=0 results against eager runs of
    their x_T (one batch per S)."""
    by_id = {r.request_id: r for r in results}
    worst, n = 0.0, 0
    for S in sorted({r.S for r in reqs}):
        det = [r for r in reqs if r.S == S and r.eta == 0.0]
        if not det:
            continue
        x_T = torch.cat([_x_T(r.seed) for r in det])
        lone = det[0].resolved_plan(sch, None).run(eps_fn, x_T,
                                                   backend="eager")
        for r, want in zip(det, lone):
            got = by_id[r.request_id].x0
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max()))
            n += 1
    return worst, n


def _quality_from_frames(frames, rid):
    """frames / defect max / defect mean of one request, recomputed from
    its flight frames with the k == 0 defect discarded."""
    from repro_torch.obs.schema import PROBE_COLUMNS
    i_def = PROBE_COLUMNS.index("defect")
    rows = [(ent["k"], fr["values"][b]) for fr in frames
            for b, ent in enumerate(fr["slots"])
            if ent is not None and ent["request_id"] == rid]
    d = [v[i_def] for k, v in rows if k >= 1 and math.isfinite(v[i_def])]
    return len(rows), (max(d) if d else None), (sum(d) / len(d) if d
                                                 else None)


def phase_telemetry(smi, model):
    """Phase 8, items 1-2: device probes and profiling ranges on the
    CIFAR10 U-Net scheduler (8 slots, stochastic, order 2, preview).
    Returns the B2 launches of the counted paths."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.schedules import make_schedule
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.obs import (FlightRecorder, Observability, ProbeSpec,
                                 format_hbm_table, modeled_hbm_table)
    from repro_torch.obs.probes import device_frame
    from repro_torch.obs.schema import PROBE_COLUMNS
    from repro_torch.serving import DiffusionSampler, SampleRequest
    sch = make_schedule("linear", 1000)
    eps_fn = make_eps_fn(model)
    svc = DiffusionSampler(sch, eps_fn, CARD_SHAPE, batch_size=BATCH,
                           tile_resident=True)
    kw = dict(slots=P8_SLOTS, stochastic=True, max_order=2, preview=True)
    fl = FlightRecorder(1024, pool_id=0)
    eng = svc.continuous(probes=ProbeSpec(), flight=fl, **kw)
    plain = svc.continuous(**kw)

    def reqs(base=0):
        out = _p8_requests(16, base)
        for r in out[::5]:
            r.preview_every, r.on_preview = 4, lambda *a: None
        return out

    # --- 1. the probed engine, counted
    _zero_counts()
    res = {r.request_id: r for r in eng.serve(reqs())}
    torch.cuda.synchronize()
    counts = _counts()
    st = eng.stats()
    ref = {r.request_id: r for r in plain.serve(reqs())}
    torch.cuda.synchronize()
    frames = fl.frames()
    vals = [np.asarray(f["values"], np.float64) for f in frames]
    f32 = all(np.array_equal(v, v.astype(np.float32).astype(np.float64),
                             equal_nan=True) for v in vals)
    i_fin = PROBE_COLUMNS.index("finite_frac")
    fin = min(v[b, i_fin] for v, f in zip(vals, frames)
              for b, e in enumerate(f["slots"]) if e is not None)
    bitwise = sorted(res) == sorted(ref) and all(
        torch.equal(res[i].x0, ref[i].x0) for i in ref)
    requant = all(
        _quality_from_frames(frames, i) == (
            res[i].quality["frames"], res[i].quality["defect_max"],
            res[i].quality["defect_mean"]) for i in res)
    print(f"[probe] {smi} | scheduler CIFAR10_UNET slots {P8_SLOTS} "
          f"(stochastic, order 2, preview) probes {st['probes']}: 16 "
          f"requests, {st['ticks']} ticks, probe_frames "
          f"{st['probe_frames']}, frames {len(frames)} of shape "
          f"{vals[0].shape} float32 {f32}, min finite_frac {fin}, "
          f"probe_defect_max {st['probe_defect_max']:.4g}, compiled_ticks "
          f"{st['compiled_ticks']}; launches {counts}; x0 bitwise vs a "
          f"probe-less engine {bitwise}; quality recomputed from the "
          f"frames (defect at k = 0 discarded) {requant}")
    check(counts == {"B1": 0, "B2": st["ticks"], "B3": 0, "B4": 0},
          f"probed engine launched {counts}, want B2 == ticks {st['ticks']}")
    check(bitwise, "probed engine x0 differs from the probe-less engine")
    check(st["probe_frames"] == st["ticks"] == len(frames) and f32
          and all(v.shape == (P8_SLOTS, 6) for v in vals),
          f"probe frames {st['probe_frames']} / ticks {st['ticks']}")
    check(fin == 1.0 and requant
          and all(r.quality is not None for r in res.values()),
          "probe frames or quality summaries wrong")
    n_b2 = counts["B2"]
    # toggling picks one of two tick functions, never a third
    _zero_counts()
    for on in (False, True):
        eng.set_probes(on)
        eng.serve(_p8_requests(4, 100 + 10 * on))
    n_b2 += _counts()["B2"]
    ct = eng.stats()["compiled_ticks"]
    print(f"[probe] set_probes(False) then (True): compiled_ticks {ct}")
    check(ct <= 2, f"compiled_ticks {ct} > 2 after toggling")

    # --- probe cost: probed and plain ticks alternated on one engine
    for r in _p8_requests(P8_SLOTS, 200):
        r.S = 2 * P8_COST_TICKS + 8
        eng.submit(r)
    walls = {True: [], False: []}
    for i in range(2 * P8_COST_TICKS + 4):
        on = bool(i % 2)
        eng.set_probes(on)
        t0 = time.perf_counter()
        eng.tick()
        if i >= 4:
            walls[on].append((time.perf_counter() - t0) * 1e3)
    eng.run()
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"[probe] {smi} | tick wall, {P8_COST_TICKS} probed and "
          f"{P8_COST_TICKS} plain ticks alternated (8 slots busy): median "
          f"probed {med[True]:.3f} ms, plain {med[False]:.3f} ms, cost "
          f"{med[True] - med[False]:.3f} ms "
          f"({(med[True] / med[False] - 1) * 100:.1f}%)")
    # device time of the frame's reductions and its copy, on the engine's
    # own tensors
    states = eng._states()
    x2 = eng._x2[0]                     # the one row block off a mesh
    eps2 = torch.randn_like(x2)
    prev = eng._hist2[0][0]
    spec = eng.probe_spec

    def frame_and_copy():
        return device_frame(spec, x2, x2, eps2, prev, states, rps=eng._rps,
                            n_live=eng._n).cpu()
    frame_and_copy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame_and_copy()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in dev)
    copy_us = sum(e.self_device_time_total for e in dev
                  if "Memcpy" in e.key or "memcpy" in e.key)
    print(f"[probe] {smi} | device_frame + copy to the host: "
          f"{dev_us / 1e3:.4f} ms of device time in {sum(e.count for e in dev)}"
          f" device ops (copy {copy_us / 1e3:.4f} ms)")

    # --- 2. profiling ranges
    prof_eng = svc.continuous(obs=Observability(profile=True), **kw)
    for r in _p8_requests(P8_SLOTS, 300):
        r.S = 20
        prof_eng.submit(r)
    prof_eng.tick()
    prof_eng.tick()
    _zero_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            prof_eng.tick()
        torch.cuda.synchronize()
    n_b2 += _counts()["B2"]
    prof_eng.run()
    name = f"repro/tick/{prof_eng.tick_variant}"
    evs = list(prof.events())
    ranges = [e for e in evs if e.name == name
              and e.device_type == DeviceType.CPU]
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA]

    def inside(k, r):
        return (r.time_range.start <= k.time_range.start
                and k.time_range.end <= r.time_range.end)
    b2_in = [sum(1 for k in kernels if "step_rows_kernel" in k.name
                 and inside(k, r)) for r in ranges]
    busy = sum(k.time_range.elapsed_us() for k in kernels)
    held = sum(k.time_range.elapsed_us() for k in kernels
               if any(inside(k, r) for r in ranges))
    b2_us = [k.time_range.elapsed_us() for k in kernels
             if "step_rows_kernel" in k.name]
    print(f"[range] {smi} | 3 steady ticks under torch.profiler: "
          f"{len(ranges)} '{name}' ranges, B2 inside each {b2_in}; "
          f"device time inside the ranges {held / 1e3:.3f} of "
          f"{busy / 1e3:.3f} ms ({held / max(busy, 1e-9):.4f})")
    check(len(ranges) == 3 and b2_in == [1, 1, 1],
          f"profiling ranges {len(ranges)}, B2 inside {b2_in}")
    b2_med = statistics.median(b2_us) if b2_us else float("nan")
    print(f"[range] modeled per-tick device-memory traffic of this engine, "
          f"beside B2's measured {b2_med:.2f} us per tick ({smi}):")
    print(format_hbm_table(modeled_hbm_table(prof_eng)))
    return n_b2


def phase_fleet(smi, model):
    """Phase 8, items 3-4: the U-Net fleet (2 pools x 8 slots, probes,
    flight recorders, a drain and restore) and the hot-swap postmortem on
    an eps_params fleet.  Returns the B2 launches of the counted paths."""
    import tempfile
    from torch.func import functional_call
    from repro_torch.core.schedules import make_schedule
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.obs import (FLEET_STATS_KEYS, POOL_STATS_KEYS,
                                 ListSink, Observability, attribute_nonfinite,
                                 check_spans, read_flight, render_dashboard,
                                 render_summary, summarize_results)
    from repro_torch.serving import PoolFleet, PoolState, SampleRequest
    from repro_torch.serving.fleet import affinity_pool
    sch = make_schedule("linear", 1000)
    eps_fn = make_eps_fn(model)
    tmp = tempfile.mkdtemp(prefix="repro_flight_")

    # --- 3. the U-Net fleet, counted
    o = Observability()
    sink = o.add_sink(ListSink())
    fleet = PoolFleet.build(sch, eps_fn, CARD_SHAPE, n_pools=2,
                            slots=P8_SLOTS, stochastic=True, max_order=2,
                            probes=True, flight_dir=tmp, obs=o)
    reqs = _p8_requests(P8_FLEET_N, key_every=4)
    _zero_counts()
    for r in reqs:
        fleet.submit(r)
    results = []
    for _ in range(5):
        results += fleet.tick()
    # drain pool 1 right after a dispatch gave it work it has not admitted
    # yet, so that the drain hands work back to the global queue
    for _ in range(40):
        results += fleet.dispatch(time.perf_counter())
        if len(fleet.pools[1].engine.queue) or not len(fleet.queue):
            break
        results += fleet.tick()
    moved = fleet.drain_pool(1)
    while fleet.pools[1].state is not PoolState.STOPPED:
        results += fleet.tick()
    stopped_at = fleet.stats()["ticks"]
    fleet.restore_pool(1)
    results += fleet.run()
    torch.cuda.synchronize()
    counts = _counts()
    st = fleet.stats()
    ids = sorted(r.request_id for r in results)
    worst, n_det = _vs_eager(eps_fn, sch, results, reqs)
    text = fleet.render_prometheus()
    spans = check_spans(sink.events)
    print(f"[fleet] {smi} | PoolFleet CIFAR10_UNET 2 pools x {P8_SLOTS} "
          f"slots (stochastic, order 2, probes), {len(reqs)} requests (8 "
          f"with an affinity key), pool 1 drained mid-run ({moved} "
          f"re-routed, STOPPED at pool tick {stopped_at}) and restored: "
          f"pool ticks {[p['ticks'] for p in st['pools']]}, completed "
          f"{st['completed']}, launches {counts}, span errors {len(spans)}, "
          f"eta=0 x0 vs eager of the same x_T ({n_det} requests) worst "
          f"max|d|/max|x| = {worst:.3e} (tol {SCHED_VS_EAGER_TOL:g})")
    check(counts == {"B1": 0, "B2": st["ticks"], "B3": 0, "B4": 0},
          f"fleet launched {counts}, want B2 == pool ticks {st['ticks']}")
    check(ids == [r.request_id for r in reqs] and not spans,
          f"fleet results {ids} / span errors {spans[:3]}")
    check(n_det > 0 and worst <= SCHED_VS_EAGER_TOL,
          f"fleet vs eager: {worst} > {SCHED_VS_EAGER_TOL:g}")
    check(set(st) == FLEET_STATS_KEYS
          and all(set(p) == POOL_STATS_KEYS for p in st["pools"]),
          "fleet / pool stats keys differ from the schema")
    check('pool="0"' in text and 'pool="1"' in text
          and "engine_tick_seconds_bucket{" in text,
          "render_prometheus lacks the pool series")
    n_b2 = counts["B2"]
    print(render_dashboard(st))
    print(render_summary(summarize_results(results)))
    # steady slot-steps/s: the fleet beside one 8-slot engine (pool 0's),
    # alternated over P8_RATE_ROUNDS rounds in this call (host walls
    # spread between runs)
    one = fleet.pools[0].engine

    def rate(serve, n, base):
        t0 = time.perf_counter()
        out = serve([dataclasses.replace(r, S=20)
                     for r in _p8_requests(n, base)])
        torch.cuda.synchronize()
        return len(out) * 20 / (time.perf_counter() - t0)
    fleet.serve(_p8_requests(2 * P8_SLOTS, 1000))      # warm every slot
    rates = {"fleet": [], "one": []}
    for i in range(P8_RATE_ROUNDS):
        rates["fleet"].append(rate(fleet.serve, 4 * P8_SLOTS,
                                   2000 + 100 * i))
        rates["one"].append(rate(one.serve, 2 * P8_SLOTS, 3000 + 100 * i))
    med = {k: statistics.median(v) for k, v in rates.items()}
    print(f"[fleet] {smi} | steady slot-steps/s (S=20, every slot busy, "
          f"2 waves), {P8_RATE_ROUNDS} rounds alternated: fleet of 2 x "
          f"{P8_SLOTS} slots median {med['fleet']:.1f} "
          f"({', '.join(f'{r:.1f}' for r in rates['fleet'])}), one "
          f"{P8_SLOTS}-slot engine median {med['one']:.1f} "
          f"({', '.join(f'{r:.1f}' for r in rates['one'])}), ratio of "
          f"medians {med['fleet'] / med['one']:.3f}")

    # --- 4. hot-swap and postmortem on an eps_params fleet, counted
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def eps_p(p, x, t):
        return functional_call(model, p, (x, t))
    swap = PoolFleet.build(sch, eps_p, CARD_SHAPE, n_pools=2,
                           slots=P8_SLOTS, eps_params=params, probes=True,
                           flight_dir=tmp)
    key1 = next(k for k in range(64) if affinity_pool(k, 2) == 1)
    pool = swap.pools[1]

    def one_request(rid):
        return SampleRequest(request_id=rid, S=10, seed=4242,
                             affinity_key=key1)
    _zero_counts()
    (pre,) = swap.serve([one_request(0)])
    ct0 = pool.stats()["compiled_ticks"]
    bad = dict(params)
    bad["conv_out.weight"] = params["conv_out.weight"].clone()
    bad["conv_out.weight"][0, 0, 0, 0] = float("nan")
    try:
        pool.install(bad)
        refused = False
    except RuntimeError:
        refused = True
    swap.drain_pool(1)
    swap.run()
    pool.install(bad)
    swap.restore_pool(1)
    (poisoned,) = swap.serve([one_request(1)])
    path = pool.engine.flight.dump("nonfinite", request_id=1)
    header, frames = read_flight(path)
    attr = attribute_nonfinite(frames)
    fin = min(f["values"][b][4] for f in frames
              for b, e in enumerate(f["slots"])
              if e is not None and e["request_id"] == 1)
    swap.drain_pool(1)
    swap.run()
    pool.install(params)
    swap.restore_pool(1)
    (post,) = swap.serve([one_request(2)])
    torch.cuda.synchronize()
    counts = _counts()
    sst = swap.stats()
    print(f"[swap] {smi} | eps_params fleet 2 x {P8_SLOTS} slots (order 1, "
          f"probes): install on ACTIVE refused {refused}; NaN in "
          f"conv_out.weight installed on drained pool 1 "
          f"(weight_swaps {pool.weight_swaps}): request on pool "
          f"{poisoned.pool_id}, min finite_frac {fin}, x0 finite "
          f"{bool(torch.isfinite(poisoned.x0).all())}; dump {path} -> "
          f"attribution {header['attribution']}; original weights "
          f"re-installed: x0 bitwise the pre-swap one "
          f"{torch.equal(post.x0, pre.x0)}; compiled_ticks {ct0} -> "
          f"{pool.stats()['compiled_ticks']}; launches {counts}")
    check(refused, "install on an ACTIVE pool was not refused")
    check(pre.pool_id == poisoned.pool_id == post.pool_id == 1,
          "the affinity request did not reach pool 1")
    ent = (next(f for f in frames if f["tick"] == attr["tick"])["slots"][
        attr["slot"]] if attr is not None else None)
    check(fin < 1.0 and attr is not None and header["attribution"] == attr
          and (attr["pool"], attr["step"], attr["request_id"]) == (1, 0, 1)
          and ent == {"slot": attr["slot"], "request_id": 1, "k": 0},
          f"non-finite attribution {attr}")
    check(torch.equal(post.x0, pre.x0), "x0 after the restore differs from "
          "the pre-swap x0")
    check(pool.stats()["compiled_ticks"] == ct0 and pool.weight_swaps == 2,
          "an install built a tick function")
    check(counts == {"B1": 0, "B2": sst["ticks"], "B3": 0, "B4": 0},
          f"swap fleet launched {counts}, want B2 == ticks {sst['ticks']}")
    return n_b2 + counts["B2"]


def phase_mega_fleet(params2):
    """Phase 8, item 5: a fleet of two mega pools (B4 per pool tick)
    against one mega engine, and probes on that trunk.  Returns (B2, B4)
    launches of the counted paths."""
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.core.schedules import make_schedule
    from repro_torch.diffusion_lm import make_tile_eps_fn, round_to_tokens
    from repro_torch.serving import (ContinuousBatchingEngine, PoolFleet,
                                     SampleRequest)
    sch = make_schedule("linear", 1000)
    eps = make_tile_eps_fn(params2, cfg, DLM_BATCH, DLM_SEQ)
    shape = (DLM_SEQ, cfg.latent_dim)

    def reqs():
        return [SampleRequest(request_id=i, S=DLM_SCHED_S[i % 2],
                              seed=400 + i) for i in range(8)]
    fleet = PoolFleet.build(sch, eps, shape, n_pools=2, slots=DLM_BATCH)
    single = ContinuousBatchingEngine(sch, eps, shape, slots=DLM_BATCH)
    _zero_counts()
    res_f = {r.request_id: r for r in fleet.serve(reqs())}
    torch.cuda.synchronize()
    counts = _counts()
    st = fleet.stats()
    res_s = {r.request_id: r for r in single.serve(reqs())}
    xf = torch.stack([res_f[i].x0 for i in sorted(res_s)])
    xs = torch.stack([res_s[i].x0 for i in sorted(res_s)])
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(xf, xs))
    same_tokens = torch.equal(round_to_tokens(params2, xf),
                              round_to_tokens(params2, xs))
    print(f"[fleet] PoolFleet {cfg.arch.name} 2 pools x {DLM_BATCH} slots x "
          f"{DLM_SEQ} tokens, use_mega=None: mega_tick "
          f"{[p['mega_tick'] for p in st['pools']]}, pool ticks "
          f"{[p['ticks'] for p in st['pools']]}, mega_tick_ratio "
          f"{st['mega_tick_ratio']}, launches {counts}; vs one mega engine: "
          f"tokens equal {same_tokens}, worst max|d|/max|x| {rel:.3e} "
          f"(tol 1e-3)")
    check(all(p["mega_tick"] for p in st["pools"])
          and counts == {"B1": 0, "B2": 0, "B3": 0, "B4": st["ticks"]},
          f"mega fleet launched {counts}, want B4 == pool ticks "
          f"{st['ticks']}")
    check(same_tokens and rel <= 1e-3, f"mega fleet vs one mega engine: "
          f"tokens equal {same_tokens}, {rel} > 1e-3")
    try:
        ContinuousBatchingEngine(sch, eps, shape, slots=DLM_BATCH,
                                 probes=True)
        why = None
    except ValueError as e:
        why = str(e)
    probed = ContinuousBatchingEngine(sch, eps, shape, slots=DLM_BATCH,
                                      probes=True, use_mega=False)
    _zero_counts()
    res_p = probed.serve(reqs()[:4])
    torch.cuda.synchronize()
    counts_p = _counts()
    pst = probed.stats()
    print(f"[fleet] probes=True, use_mega=None on {cfg.arch.name}: "
          f"{'raises: ' + why[:60] + '...' if why else 'NO ERROR'}; "
          f"use_mega=False: {pst['ticks']} ticks, probe_frames "
          f"{pst['probe_frames']}, launches {counts_p}")
    check(why is not None and "probes are unavailable on the mega tick" in why,
          "mega + probes did not raise")
    check(counts_p == {"B1": 0, "B2": pst["ticks"], "B3": 0, "B4": 0}
          and len(res_p) == 4 and pst["probe_frames"] == pst["ticks"],
          f"probed unfused DLM engine launched {counts_p}")
    return counts_p["B2"], counts["B4"]


# ------------------------------------------- the launch floor and the pairs
PAIR_ROUNDS = 5


def launch_floor():
    """The sampler-step library's empty kernel at 1 block and at every grid
    that B1 and B2 take at the main path's R and at 768: {blocks:
    (graph_ms, loop_ms)}."""
    from repro_torch.kernels.sampler_step import kernel
    grids = {1} | {kernel.grid(R, stoch) for R in (*main_rows(), 768)
                   for stoch in (False, True)}
    out = {}
    for blocks in sorted(grids):
        fn = lambda: kernel.empty_kernel(blocks)  # noqa: E731
        out[blocks] = (graph_ms(fn), loop_ms(fn))
    return out


def launch_pairs(seed: int = 99):
    """B1 and B2 (det and stoch) at the main path's R, each alone and after
    the op that produces eps on its path, graph-replayed, beside that op
    alone: PAIR_ROUNDS rounds in turns; the median and the range of each.
    B1's producer is the copy that ``to_tile_layout`` makes of the U-Net's
    NHWC eps view (``sampling.backends._loop_tiles``), B2's the copy and pad
    of ``to_slot_tile_layout`` (``_loop_rows``)."""
    from repro_torch.kernels.sampler_step import kernel, ops
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r_b1, r_b2 = main_rows()
    # the U-Net's eps as it leaves the model: an NHWC view of NCHW data
    eps_nhwc = torch.randn((BATCH, CARD_SHAPE[2]) + CARD_SHAPE[:2],
                           generator=gen, device="cuda").permute(0, 2, 3, 1)
    rc = torch.rand(r_b2, 8, generator=gen, device="cuda") + 0.1
    rs = torch.randint(0, 2 ** 31 - 1, (r_b2,), generator=gen,
                       device="cuda", dtype=torch.int32)
    coefs = [0.9, 0.3, 1.0, 0.6, 0.8]
    x_b1 = torch.randn(r_b1, 256, generator=gen, device="cuda")
    x_b2 = torch.randn(r_b2, 256, generator=gen, device="cuda")
    produce = {"sampler_step_2d": lambda: ops.to_tile_layout(eps_nhwc)[0],
               "sampler_step_rows_2d":
                   lambda: ops.to_slot_tile_layout(eps_nhwc)[0]}

    def step(name, stoch, e):
        if name == "sampler_step_2d":
            return kernel.sampler_step_2d(x_b1, e, coefs, 7,
                                          stochastic=stoch)
        return kernel.sampler_step_rows_2d(x_b2, e, rc, rs,
                                           stochastic=stoch)
    cases = [(name, stoch, produce[name]()) for name in produce
             for stoch in (False, True)]
    times = [{"alone": [], "pair": [], "producer": []} for _ in cases]
    for _ in range(PAIR_ROUNDS):
        for (name, stoch, e), t in zip(cases, times):
            t["alone"].append(graph_ms(lambda: step(name, stoch, e)))
            t["pair"].append(graph_ms(
                lambda: step(name, stoch, produce[name]())))
            t["producer"].append(graph_ms(produce[name]))
    out = []
    for (name, stoch, _), t in zip(cases, times):
        rec = {"kernel": name, "R": r_b1 if name == "sampler_step_2d"
               else r_b2, "variant": "stoch" if stoch else "det"}
        for k, vals in t.items():
            rec[f"{k}_ms"] = statistics.median(vals)
            rec[f"{k}_ms_range"] = [min(vals), max(vals)]
        rec["step_in_pair_ms"] = rec["pair_ms"] - rec["producer_ms"]
        out.append(rec)
    return out


def _pair_line(smi, r) -> str:
    lo, hi = r["pair_ms_range"]
    return (f"[times] {smi} | pair {r['kernel']} R={r['R']} {r['variant']}: "
            f"alone {r['alone_ms'] * 1e3:.3f} us, producer "
            f"{r['producer_ms'] * 1e3:.3f} us, producer + step "
            f"{r['pair_ms'] * 1e3:.3f} us (range {lo * 1e3:.3f}-"
            f"{hi * 1e3:.3f}), step in the pair "
            f"{r['step_in_pair_ms'] * 1e3:.3f} us (graph, median of "
            f"{PAIR_ROUNDS} rounds)")


def phase_launch(smi, b_kernels, alone) -> None:
    """The launch floor and the producer + step pairs, run last, so that
    every end-to-end rate is measured before their CUDA graph captures, as
    in the trees before them.  Prints B1 / B2 alone beside the empty kernel
    at their grid and adds floor_ms and the pair's times to their
    records."""
    from repro_torch.kernels.sampler_step import kernel
    floors = launch_floor()
    for blocks, (g_ms, l_ms) in floors.items():
        print(f"[times] {smi} | floor: empty kernel, {blocks} blocks x 256 "
              f"threads: {g_ms * 1e3:.3f} us (graph), {l_ms * 1e3:.2f} us "
              "per Python call")
    recs = {r["name"]: r for r in b_kernels}
    for (kname, R, stoch), t in alone.items():
        blocks = kernel.grid(R, stoch)
        g_ms, l_ms = floors[blocks]
        print(f"[times] {smi} | {kname} R={R} f32 "
              f"{'stoch' if stoch else 'det'} ({blocks} blocks): kernel "
              f"{t['ms'] * 1e3:.3f} us (graph) beside the empty kernel at "
              f"that grid, {g_ms * 1e3:.3f} us (graph) and "
              f"{l_ms * 1e3:.2f} us per Python call; bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
        if not stoch and recs[kname]["R"] == R:
            recs[kname].update(floor_ms=g_ms, floor_call_ms=l_ms)
    for r in launch_pairs():
        print(_pair_line(smi, r))
        if r["variant"] == "det":
            recs[r["kernel"]].update(
                pair_ms=r["pair_ms"], producer_ms=r["producer_ms"],
                step_in_pair_ms=r["step_in_pair_ms"])


def launch_probe(smi) -> None:
    """``--launch-probe SRC``: the floor (where SRC's library has the empty
    kernel) and the pairs of SRC's step kernels, as JSON lines, so that
    another checkout (the parent commit, unpacked with git archive) is
    timed by this script's timers in the same call."""
    from repro_torch.kernels.sampler_step import kernel
    if hasattr(kernel, "empty_kernel"):
        for blocks, (g_ms, l_ms) in launch_floor().items():
            print(json.dumps({"card": smi, "probe": "floor", "blocks": blocks,
                              "graph_ms": g_ms, "loop_ms": l_ms}))
    for r in launch_pairs():
        print(json.dumps({"card": smi, "probe": "pair", **r}))


# ------------------------------------------------- the diffusion-LM slice
def _dlm_params(cfg):
    """JAX's init of ``cfg`` for PRNGKey(0), drawn on the card."""
    from repro_torch import prng
    from repro_torch.diffusion_lm import init_params
    from repro_torch.kernels.megastep.kernel import leaves
    t0 = time.perf_counter()
    params = init_params(prng.PRNGKey(0), cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    print(f"[main] {cfg.arch.name} (diffusion-LM, time_dim {cfg.time_dim}, "
          f"latent {cfg.latent_dim}): {n / 1e6:.2f} M parameters, init "
          f"{time.perf_counter() - t0:.2f} s")
    return params


def _plan_rows(S: int):
    """(coefs (S, 5) float32, ts (S,) int32) of the S-step eta=0 plan, on
    the card, in sampling order."""
    from repro_torch.core.schedules import make_schedule
    from repro_torch.sampling import SamplerPlan
    tab = SamplerPlan.build(make_schedule("linear", 1000), S).steps()
    cols = ("c_x0", "c_dir", "c_noise", "sqrt_a_t", "sqrt_1m_a_t")
    coefs = torch.stack([torch.from_numpy(tab[c].copy()) for c in cols], 1)
    return (coefs.cuda(), torch.from_numpy(tab["t"].copy()).cuda())


def _check_rel(errs, name, got, want, rel_tol) -> None:
    """max|got - want| <= rel_tol * max|want|, all finite."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = rel_tol * scale
    ok = bool(torch.isfinite(got).all()) and err <= tol
    print(f"[kernels] {name:<44} max|d|={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: max|d| {err} > tol {tol}")
    errs.append(err)


def _check_repeat(name, first, second) -> None:
    """A second launch on the same inputs gives the same bits (split-K
    partials are summed in a fixed order; no sum uses atomics)."""
    torch.cuda.synchronize()
    same = torch.equal(first, second)
    print(f"[kernels] {name:<44} second launch bitwise equal: "
          f"{'ok' if same else 'FAIL'}")
    check(same, f"{name}: two launches on the same inputs differ")


def _check_row_path(plan, vector: bool) -> None:
    """B6 took the vector (16-byte) row path or the scalar one."""
    print(f"[kernels]   plan {plan}")
    check(plan["vector"] == int(vector), f"B6 took the "
          f"{'vector' if plan['vector'] else 'scalar'} row path, want the "
          f"{'vector' if vector else 'scalar'} one")


def _fa_plan(p):
    """B5's launch plan as the records keep it: grid, blocks per SM,
    dynamic shared bytes, threads per block, KV tile rows, the warps that
    share 16 query rows."""
    return {"grid": p["grid_x"] * p["grid_y"], "grid_xy": [p["grid_x"],
            p["grid_y"]], "blocks_per_sm": p["blocks_per_sm"],
            "smem_bytes": p["smem_bytes"], "threads": p["threads"],
            "kv_tile": p["kv_tile"], "kv_split": p["kv_split"]}


def _check_fa_plan(plan, BH, S, D, dtype) -> None:
    """B5 launched with the KV tile and split that the CPU emulation
    (``ref.flash_attention_tiles_ref``) assumes for this shape."""
    from repro_torch.kernels.flash_attention import ref as fref
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    want = (fref.kernel_kv_tile(D, dtype), fref.kernel_kv_split(BH, S, n_sm))
    print(f"[kernels]   plan {_fa_plan(plan)}")
    check((plan["kv_tile"], plan["kv_split"]) == want,
          f"B5 ({BH}, {S}, {D}) launched KV tile {plan['kv_tile']} and "
          f"split {plan['kv_split']}; the emulation assumes {want}")


def _vs_float64(q, k, v, causal, got, want) -> None:
    """Print the float32 kernel's and its plain version's distance from
    attention in float64, of max|out|."""
    from repro_torch.kernels.flash_attention import ref as fref
    exact = fref.attention_ref(q.double()[None], k.double()[None],
                               v.double()[None], causal=causal)[0]
    scale = float(exact.abs().max())
    e_k = float((got.double() - exact).abs().max()) / scale
    e_p = float((want.double() - exact).abs().max()) / scale
    print(f"[kernels]   vs float64 attention: kernel {e_k:.3e}, plain "
          f"{e_p:.3e} of max|out|")


def phase_kernels_dlm(params2):
    """B6, B5 and B3 against their plain versions on the card."""
    from repro_torch.configs import DLM_SMOLLM_MEGA
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.megastep import kernel as mk
    from repro_torch.kernels.megastep import ref as mref
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    errs = {k: [] for k in DLM_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        ulps = 4 * F32_ULP if dtype == torch.float32 else BF16_ULP
        for R in (256, 1000):            # 1000 goes through ops' padding
            for d in (576, 192, 190):    # 190: the scalar row path
                x = (torch.randn(R, d, generator=gen, device=dev) * 3
                     ).to(dtype)
                sc = (torch.rand(d, generator=gen, device=dev) + 0.5
                      ).to(dtype)
                _check_rel(errs["rms_norm_2d"], f"B6 R={R} d={d} {tag}",
                           rops.rms_norm(x, sc), rref.rms_norm_body(x, sc,
                                                                    1e-5),
                           ulps)
                _check_row_path(rk.rms_norm_2d.last_plan, d != 190)
        # rows that start one element past a 16-byte boundary: scalar path
        buf = (torch.randn(256 * 576 + 1, generator=gen, device=dev) * 3
               ).to(dtype)
        x = buf[1:].view(256, 576)
        sc = (torch.rand(576, generator=gen, device=dev) + 0.5).to(dtype)
        _check_rel(errs["rms_norm_2d"], f"B6 R=256 d=576 {tag} unaligned",
                   rk.rms_norm_2d(x, sc), rref.rms_norm_body(x, sc, 1e-5),
                   ulps)
        _check_row_path(rk.rms_norm_2d.last_plan, False)
        rel = 2e-5 if dtype == torch.float32 else 2e-2
        # every launch variant: head dim 64 and 128, each with 1, 2 and 4
        # warps splitting the KV columns (the split on 132 SMs in [])
        variants = set()
        for BH, S, D, blk in ((36, DLM_SEQ, 64, 64),      # [4]
                              (36, 128, 64, 64),          # [2]
                              (9, 2048, 64, 128),         # [1]
                              (2, 64, 128, 64),           # [4]
                              (8, 1024, 128, 128),        # [2]
                              (24, 2048, 128, 128)):      # [1]
            q, k, v = (torch.randn(BH, S, D, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            for causal in (False, True):
                got = fk.flash_attention(q, k, v, causal=causal,
                                         block_q=blk, block_k=blk)
                want = fref.flash_attention_ref(q, k, v, causal=causal,
                                                block_k=blk)
                _check_rel(errs["flash_attention"],
                           f"B5 ({BH}, {S}, {D}) {tag} "
                           f"{'causal' if causal else 'full'}", got, want,
                           rel)
                _check_fa_plan(fk.flash_attention.last_plan, BH, S, D,
                               dtype)
                variants.add((D, fk.flash_attention.last_plan["kv_split"]))
                if dtype == torch.float32:
                    _vs_float64(q, k, v, causal, got, want)
        check(variants == {(d, p) for d in (64, 128) for p in (1, 2, 4)},
              f"B5 {tag}: the checks ran the variants {sorted(variants)}, "
              f"not every head dim with every KV split")
    coefs, ts = _plan_rows(DLM_S)
    n = DLM_BATCH * DLM_SEQ * DLM_SMOLLM_MEGA.latent_dim
    x2 = torch.randn(n // 256, 256, generator=gen, device=dev)
    for impl in ("exact", "flash"):
        for clip in (None, 1.0):
            for K in (1, DLM_K):
                args = (x2, params2, DLM_SMOLLM_MEGA, DLM_BATCH, DLM_SEQ,
                        coefs[:K], ts[:K])
                got = mk.megastep_call(*args, clip=clip, attn_impl=impl)
                want = mref.megastep_ref(*args, clip=clip, attn_impl=impl)
                _check_rel(errs["megastep_call"],
                           f"B3 {impl} clip={clip} K={K}", got, want, 1e-4)
                if K == DLM_K:
                    _check_repeat(f"B3 {impl} clip={clip} K={K}", got,
                                  mk.megastep_call(*args, clip=clip,
                                                   attn_impl=impl))
    torch.cuda.synchronize()
    return {k: max(v) for k, v in errs.items()}


def phase_main_dlm(params2, params30):
    """generate() on the eligible 2-layer and the ineligible 30-layer
    smollm-width trunk, counted; 'mega' against 'tile_resident'."""
    from repro_torch import prng
    from repro_torch.configs import DLM_SMOLLM, DLM_SMOLLM_MEGA
    from repro_torch.core import SamplerConfig
    from repro_torch.core.schedules import make_schedule
    from repro_torch.diffusion_lm import generate, make_tile_eps_fn
    from repro_torch.kernels.megastep import kernel as mk
    from repro_torch.kernels.sampler_step import kernel as sk
    from repro_torch.sampling import backends
    sch = make_schedule("linear", 1000)
    sampler = SamplerConfig(S=DLM_S)
    b3_launches = None
    for cfg, params, want_b3, want_b1 in (
            (DLM_SMOLLM_MEGA, params2, math.ceil(DLM_S / DLM_K), 0),
            (DLM_SMOLLM, params30, 0, DLM_S)):
        mk.megastep_call.launches = 0
        sk.sampler_step_2d.launches = 0
        tokens = generate(params, cfg, sch, prng.PRNGKey(11), DLM_BATCH,
                          DLM_SEQ, sampler, tile_resident=True)
        torch.cuda.synchronize()
        n3 = mk.megastep_call.launches
        n1 = sk.sampler_step_2d.launches
        print(f"[main] generate {cfg.arch.name} (S={DLM_S}, eta=0, batch "
              f"{DLM_BATCH} x {DLM_SEQ} tokens, tile_resident=True): mega "
              f"eligibility: {backends.run_mega.last_reason!r}; launches "
              f"megastep_call {n3} (want {want_b3}), sampler_step_2d {n1} "
              f"(want {want_b1}); tokens {tuple(tokens.shape)} "
              f"{tokens.dtype}, first row {tokens[0, :8].tolist()}")
        check(n3 == want_b3 and n1 == want_b1,
              f"{cfg.arch.name}: B3 {n3} / B1 {n1} launches, want "
              f"{want_b3} / {want_b1}")
        check(tokens.shape == (DLM_BATCH, DLM_SEQ)
              and tokens.dtype == torch.int32
              and 0 <= int(tokens.min()) and int(tokens.max())
              < cfg.arch.vocab, f"{cfg.arch.name}: bad tokens")
        if want_b3:
            b3_launches = n3

    gen = torch.Generator(device="cuda").manual_seed(12)
    x_T = torch.randn(DLM_BATCH, DLM_SEQ, DLM_SMOLLM_MEGA.latent_dim,
                      generator=gen, device="cuda")
    eps = make_tile_eps_fn(params2, DLM_SMOLLM_MEGA, DLM_BATCH, DLM_SEQ)
    plan = sampler.to_plan(sch)
    want = plan.run(eps, x_T, backend="tile_resident")
    spec = eps.mega_spec
    for impl in ("exact", "flash"):
        eps.mega_spec = dataclasses.replace(spec, attn_impl=impl)
        got = plan.run(eps, x_T, backend="mega")
        rel = float((got - want).abs().max() / want.abs().max())
        print(f"[main] plan.run mega ({impl}) vs tile_resident, "
              f"{DLM_SMOLLM_MEGA.arch.name} S={DLM_S}: max|d|/max|x| = "
              f"{rel:.3e} (tol 1e-3), max|x| {float(want.abs().max()):.4g}")
        check(backends.run_mega.last_reason == "ok" and rel <= 1e-3,
              f"mega {impl} vs tile_resident: {rel} > 1e-3")
    eps.mega_spec = spec
    return b3_launches


def phase_mega_fallback(smi, params2):
    """(2, 128) over DLM_SMOLLM_MEGA: eligible by the JAX rule, but past
    the CUDA megakernel's 64 tokens, so 'mega' runs the tile-resident loop
    (B1 S times, B3 never) and returns what 'tile_resident' returns."""
    from repro_torch import prng
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.core import SamplerConfig
    from repro_torch.core.schedules import make_schedule
    from repro_torch.diffusion_lm import generate, make_tile_eps_fn
    from repro_torch.sampling import backends
    batch, seq = MEGA_FALLBACK
    sch, sampler = make_schedule("linear", 1000), SamplerConfig(S=DLM_S)
    gen = torch.Generator(device="cuda").manual_seed(13)
    _zero_counts()
    tokens = generate(params2, cfg, sch, prng.PRNGKey(13), batch, seq,
                      sampler, tile_resident=True)
    torch.cuda.synchronize()
    counts, why = _counts(), backends.run_mega.last_reason
    print(f"[main] {smi} | generate {cfg.arch.name} (S={DLM_S}, batch "
          f"{batch} x {seq} tokens, tile_resident=True): run_mega.last_reason "
          f"{why!r}; launches {counts}; tokens {tuple(tokens.shape)}, first "
          f"row {tokens[0, :8].tolist()}")
    check(counts == {"B1": DLM_S, "B2": 0, "B3": 0, "B4": 0}
          and "seq_len" in why, f"(2, 128) generate: launches {counts}, "
          f"reason {why!r}")
    check(tokens.shape == (batch, seq) and 0 <= int(tokens.min())
          and int(tokens.max()) < cfg.arch.vocab, "(2, 128): bad tokens")
    x_T = torch.randn(batch, seq, cfg.latent_dim, generator=gen,
                      device="cuda")
    eps = make_tile_eps_fn(params2, cfg, batch, seq)
    plan = sampler.to_plan(sch)
    got = plan.run(eps, x_T, backend="mega")
    want = plan.run(eps, x_T, backend="tile_resident")
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"[main] {smi} | plan.run mega vs tile_resident at ({batch}, "
          f"{seq}): max|d|/max|x| = {rel:.3e} (tol 1e-3)")
    check(rel <= 1e-3, f"(2, 128) mega vs tile_resident: {rel} > 1e-3")


def phase_ops_path():
    """The public norm / attention ops at smollm width and prefill
    length, counted, against the model's plain versions."""
    from repro_torch.configs import SMOLLM_135M as a
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.models.attention import _grouped_attention
    from repro_torch.models.common import causal_mask, rms_norm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    S, d, D = 2048, a.d_model, a.hd()
    h = torch.randn(1, S, d, generator=gen, device=dev)
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    w = {n: torch.randn(d, m * D, generator=gen, device=dev) * d ** -0.5
         for n, m in (("q", a.n_heads), ("k", a.n_kv_heads),
                      ("v", a.n_kv_heads))}
    fk.flash_attention.launches = 0
    rk.rms_norm_2d.launches = 0
    xn = rops.rms_norm(h, scale)
    q, k, v = ((xn @ w[n]).view(1, S, -1, D) for n in "qkv")
    out = fops.gqa_flash(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = {"flash_attention": fk.flash_attention.launches,
                "rms_norm_2d": rk.rms_norm_2d.launches}
    xn_plain = rms_norm(h, scale)
    want = _grouped_attention(q, k, v, torch.clamp(causal_mask(S, device=dev),
                                                   min=-1e30))
    e_n = float((xn - xn_plain).abs().max() / xn_plain.abs().max())
    e_a = float((out - want).abs().max() / want.abs().max())
    print(f"[main] ops path (smollm width, 1 x {S} tokens): rms_norm + "
          f"gqa_flash causal ({a.n_heads}/{a.n_kv_heads} heads); launches "
          f"{launches}; vs models.common.rms_norm {e_n:.3e} (tol 4 f32 "
          f"ulps = {4 * F32_ULP:.3e}), vs _grouped_attention {e_a:.3e} "
          f"(tol 1e-4) of max|out|")
    check(launches == {"flash_attention": 1, "rms_norm_2d": 1},
          f"ops path launches {launches}")
    check(e_n <= 4 * F32_ULP and e_a <= 1e-4, "ops path disagrees")
    return launches


def mega_ops(cfg, batch: int, seq: int, K: int) -> int:
    """Operations of one K-step megastep launch, counted from the body of
    csrc/megastep.cu: 2 per multiply-add of a product, 1 per other float
    operation (exp, divide, add, ...), index arithmetic not counted."""
    a = cfg.arch
    d, T, L, F = a.d_model, cfg.time_dim, cfg.latent_dim, a.d_ff
    H, D = a.n_heads, a.hd()
    hq, hkv, S = H * D, a.n_kv_heads * D, seq
    per = 2 * T * T + 4 * T + 2 * T * d          # time MLP, silu
    per += 2 * S * L * d + S * d                 # w_in + temb
    lay = 2 * 4 * S * d                          # two RMSNorms
    lay += 2 * S * d * (hq + 2 * hkv)            # q, k, v
    lay += 3 * S * (hq + hkv)                    # RoPE: 6 per pair
    lay += H * (4 * S * S * D + 5 * S * S)       # q k^T, p v, softmax
    lay += 2 * S * hq * d + S * d                # wo, residual
    lay += 4 * S * d * F + 5 * S * F             # gate, up, silu * up
    lay += 2 * S * F * d + S * d                 # down, residual
    per += a.n_layers * lay + 4 * S * d + 2 * S * d * L + 3 * S * L
    return batch * K * per


def _bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / RL.HBM_BW * 1e3
    t_ops = n_ops / RL.PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_line(smi, label, rec):
    lib = ("none" if rec["library_ms"] is None
           else f"{rec['library_ms'] * 1e3:.2f} us")
    grid = (f"; grid {rec['grid']} blocks ({rec['blocks_per_sm']} per SM)"
            if "grid" in rec else "")
    if "barriers_per_step" in rec:
        grid += f", {rec['barriers_per_step']} grid barriers per step"
    if "smem_bytes" in rec:
        grid += (f", {rec['threads']} threads, {rec['smem_bytes']} B "
                 f"dynamic shared memory")
    print(f"[times] {smi} | {label}: kernel {rec['ms'] * 1e3:.2f} us "
          f"({rec.get('timed_by', 'graph')}), plain "
          f"{rec['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
          f"{rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}), "
          f"{rec['bound_ms'] / rec['ms']:.3f} of it{grid}")


def _rn_plan(wrapper):
    """B6's launch plan as the records keep it."""
    p = wrapper.last_plan
    return {"grid": p["grid"], "blocks_per_sm": p["blocks_per_sm"],
            "smem_bytes": p["smem_bytes"], "threads": p["threads"],
            "rows_per_block": p["rows_per_block"],
            "vector": bool(p["vector"])}


def _add_shape(recs, name, rec, primary: bool) -> None:
    """Keep ``rec`` as ``name``'s record when ``primary``, and every timed
    shape under the record's ``shapes``."""
    shapes = recs.get(name, {}).get("shapes", []) + [rec]
    if primary or name not in recs:
        recs[name] = dict(rec)
    recs[name]["shapes"] = shapes


def _record(name, where, launches, err, rec):
    """One kernel's entry of the kernels JSON line (with the launch plan
    for the megakernels)."""
    return {"name": name, "route": "cuda", "source": where[0],
            "replaces": where[1], "launches": launches, "max_abs_err": err,
            **rec}


def _plan_keys(plan):
    """The launch plan of a megakernel launch, as kept in its record."""
    return {k: plan[k] for k in ("grid", "blocks_per_sm", "barriers_per_step",
                                 "split_wo", "split_down", "split_out")}


def _mega_timer(fn):
    """(timer, how): graph_ms when a CUDA graph captures the cooperative
    megakernel launch, else loop_ms, for the megakernel and for the
    unfused path it is held against alike (never one of each)."""
    try:
        graph_ms(fn, iters=1, reps=1)
        return graph_ms, "graph"
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"[times] CUDA graph capture of the cooperative launch refused "
              f"({e}); the megakernels and the unfused paths are timed by "
              f"loop_ms")
        return (lambda f, iters, reps: loop_ms(f, iters=iters * reps)), "loop"


MEGA_PHASES = ("qkv", "attn", "wo", "mlp", "down")


def _phase_trace(smi, label, wrapper, fn, steps, n_layers):
    """Device time of each phase of one launch, from the kernel's
    %globaltimer stamps (block 0, after each grid barrier): the time MLP,
    then per step w_in, per layer qkv / attn / wo / mlp / down, and out
    (the last step's out is block 0's alone: no barrier follows it)."""
    wrapper.trace = torch.zeros(2 + steps * (2 + 5 * n_layers),
                                dtype=torch.int64, device="cuda")
    try:
        fn()
        fn()
        torch.cuda.synchronize()
        st = wrapper.trace.tolist()
    finally:
        wrapper.trace = None
    us = [(b - a) / 1e3 for a, b in zip(st, st[1:])]
    names = ["time"] + (["w_in"] + [f"L{i} {n}" for i in range(n_layers)
                                    for n in MEGA_PHASES] + ["out"]) * steps
    kinds = {}
    for name, t in zip(names[1:], us[1:]):
        kinds.setdefault(name.split()[-1], []).append(t)
    mean = ", ".join(f"{k} {sum(v) / len(v):.1f}" for k, v in kinds.items())
    step0 = ", ".join(f"{n} {t:.1f}" for n, t in
                      zip(names[:3 + 5 * n_layers], us))
    print(f"[trace] {smi} | {label}: {(st[-1] - st[0]) / 1e3:.1f} us in "
          f"{len(us)} phases; step 0 (us): {step0}; mean per phase kind "
          f"(us): {mean}")


def phase_times_dlm(smi, params2, errs, b3_launches, ops_launches):
    import torch.nn.functional as F

    from repro_torch import prng
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.core import SamplerConfig, sample
    from repro_torch.core.schedules import make_schedule
    from repro_torch.diffusion_lm import (generate, make_tile_eps_fn,
                                          round_to_tokens)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.megastep import kernel as mk
    from repro_torch.kernels.megastep import ref as mref
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rref
    from repro_torch.kernels.sampler_step import kernel as sk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    recs = {}

    # B6 at the trunk's norm shape (256 tokens), the ops path's (2048)
    # and a prefill of 8 x 2048 tokens, whose 75.5 MB do not fit the L2;
    # the ops path's shape is the record, the others ride along
    d = cfg.arch.d_model
    for R in (DLM_BATCH * DLM_SEQ, 2048, 16384):
        x = torch.randn(R, d, generator=gen, device=dev)
        sc = torch.rand(d, generator=gen, device=dev) + 0.5
        b_ms, b_by = _bound((2 * R * d + d) * 4, 4 * R * d)
        rec = dict(
            ms=graph_ms(lambda: rk.rms_norm_2d(x, sc)),
            plain_ms=graph_ms(lambda: rref.rms_norm_body(x, sc, 1e-5)),
            library_ms=graph_ms(lambda: F.rms_norm(x, (d,), sc, 1e-5)),
            bound_ms=b_ms, bound_by=b_by, shape=f"({R}, {d}) f32",
            **_rn_plan(rk.rms_norm_2d))
        _time_line(smi, f"B6 rms_norm_2d {rec['shape']}", rec)
        _add_shape(recs, "rms_norm_2d", rec, primary=R == 2048)

    # B5 at the trunk's attention shape and at the ops path's prefill
    # (the record).  bound_ms: bytes, or the operations at the rate of the
    # inputs' type (float32 on the SIMT units; bfloat16: one pass on the
    # tensor cores, the softmax at the float32 rate).  bound_tc_ms: on
    # the units the float32 kernel uses, 3 TF32 passes for the products
    # plus the softmax at the float32 rate (bfloat16: as bound_ms)
    for BH, S, blk, causal, dtype in (
            (DLM_BATCH * cfg.arch.n_heads, DLM_SEQ, 64, False,
             torch.float32),
            (9, 2048, 128, True, torch.float32),
            (9, 2048, 128, True, torch.bfloat16)):
        q, k, v = (torch.randn(BH, S, 64, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        pairs = BH * (S * (S + 1) // 2 if causal else S * S)
        t_bytes = 4 * BH * S * 64 * q.element_size() / RL.HBM_BW * 1e3
        t_soft = pairs * 5 / RL.PEAK_FLOPS_F32 * 1e3
        if dtype == torch.float32:
            t_ops = pairs * 4 * 64 / RL.PEAK_FLOPS_F32 * 1e3 + t_soft
            t_tc = pairs * 4 * 64 * 3 / RL.PEAK_FLOPS_TF32 * 1e3 + t_soft
        else:
            t_ops = t_tc = pairs * 4 * 64 / RL.PEAK_FLOPS_BF16 * 1e3 + t_soft
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops \
            else (t_ops, "operations")
        tag = "f32" if dtype == torch.float32 else "bf16"
        rec = dict(
            ms=graph_ms(lambda: fk.flash_attention(
                q, k, v, causal=causal, block_q=blk, block_k=blk)),
            plain_ms=graph_ms(lambda: fref.flash_attention_ref(
                q, k, v, causal=causal, block_k=blk), iters=10),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=causal)),
            bound_ms=b_ms, bound_by=b_by, bound_tc_ms=max(t_bytes, t_tc),
            shape=f"({BH}, {S}, 64) {tag} "
                  f"{'causal' if causal else 'full'}",
            **_fa_plan(fk.flash_attention.last_plan))
        _time_line(smi, f"B5 flash_attention {rec['shape']}", rec)
        print(f"[times]   B5 bound on the units the kernel uses "
              f"{rec['bound_tc_ms'] * 1e3:.3f} us, "
              f"{rec['bound_tc_ms'] / rec['ms']:.3f} of it; kernel / "
              f"library {rec['ms'] / rec['library_ms']:.3f}")
        _add_shape(recs, "flash_attention", rec,
                   primary=causal and dtype == torch.float32)

    # B3: one 8-step launch at the slice's shape
    coefs, ts = _plan_rows(DLM_S)
    n = DLM_BATCH * DLM_SEQ * cfg.latent_dim
    x2 = torch.randn(n // 256, 256, generator=gen, device=dev)
    eps = make_tile_eps_fn(params2, cfg, DLM_BATCH, DLM_SEQ)
    n_bytes = (eps.mega_spec.weight_bytes() + 2 * n * 4
               + DLM_K * (5 * 4 + cfg.time_dim * 4) + DLM_SEQ * 64 * 4)
    b_ms, b_by = _bound(n_bytes, mega_ops(cfg, DLM_BATCH, DLM_SEQ, DLM_K))
    args = (x2, params2, cfg, DLM_BATCH, DLM_SEQ, coefs[:DLM_K],
            ts[:DLM_K])
    timer, how = _mega_timer(lambda: mk.megastep_call(*args))
    for impl in ("exact", "flash"):
        rec = dict(
            ms=timer(lambda: mk.megastep_call(*args, attn_impl=impl),
                     iters=3, reps=2),
            plain_ms=timer(lambda: mref.megastep_ref(
                *args, attn_impl=impl), iters=3, reps=2),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"{cfg.arch.name} batch {DLM_BATCH} x {DLM_SEQ}, K="
                  f"{DLM_K}, {impl}", timed_by=how,
            **_plan_keys(mk.megastep_call.last_plan))
        _time_line(smi, f"B3 megastep_call {rec['shape']}", rec)
        recs.setdefault("megastep_call", rec)
    _phase_trace(smi, f"B3 megastep_call {cfg.arch.name} K={DLM_K} exact",
                 mk.megastep_call, lambda: mk.megastep_call(*args), DLM_K,
                 cfg.arch.n_layers)
    t_vecs = [torch.full((DLM_BATCH,), int(t), dtype=torch.int32,
                         device=dev) for t in ts[:DLM_K].tolist()]
    c_host = coefs[:DLM_K].cpu().numpy()

    def unfused():
        y = x2
        for j in range(DLM_K):
            y = sk.sampler_step_2d(y, eps(y, t_vecs[j]), c_host[j])
        return y
    tile_ms = timer(unfused, iters=3, reps=2)
    b3 = recs["megastep_call"]["ms"]
    print(f"[times] {smi} | unfused tile_resident, the same {DLM_K} steps "
          f"(eager trunk + B1 per step): {tile_ms * 1e3:.2f} us ({how}), "
          f"{tile_ms / DLM_K * 1e3:.2f} us per step; B3 / unfused = "
          f"{b3 / tile_ms:.3f}")
    check(b3 < tile_ms, f"B3 {b3 * 1e3:.1f} us is not below the unfused "
          f"{DLM_K} steps {tile_ms * 1e3:.1f} us")

    # generate samples/s, 'mega' (the entry point) and 'tile_resident'
    sch = make_schedule("linear", 1000)
    sampler = SamplerConfig(S=DLM_S)

    def gen_mega():
        return generate(params2, cfg, sch, prng.PRNGKey(5), DLM_BATCH,
                        DLM_SEQ, sampler, tile_resident=True)

    def gen_tile():
        x_T = torch.randn(DLM_BATCH, DLM_SEQ, cfg.latent_dim,
                          generator=torch.Generator(
                              device="cuda").manual_seed(5), device=dev)
        return round_to_tokens(params2, sample(sch, eps, x_T, sampler,
                                               backend="tile_resident"))
    for label, fn in (("mega", gen_mega), ("tile_resident", gen_tile)):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        print(f"[times] {smi} | generate {cfg.arch.name} S={DLM_S} batch "
              f"{DLM_BATCH} on '{label}': {wall * 1e3:.1f} ms median of 3, "
              f"{DLM_BATCH / wall:.2f} samples/s (walls "
              f"{[round(w * 1e3, 1) for w in walls]} ms)")

    profile_call(smi, f"generate {cfg.arch.name} S={DLM_S} batch "
                 f"{DLM_BATCH} on 'mega'", gen_mega, "megastep_kernel")
    profile_call(smi, f"generate {cfg.arch.name} S={DLM_S} batch "
                 f"{DLM_BATCH} on 'tile_resident'", gen_tile, "step_kernel")

    launches = {"megastep_call": b3_launches, **ops_launches}
    return [_record(name, DLM_KERNELS[name], launches[name], errs[name], r)
            for name, r in recs.items()]


# ------------------------------------------------ the scheduler slice
def _slot_states(clip, idle_slot=None):
    """Per-slot (t (B,) int32, coefficient rows (B, 5) float32) on the
    card: slot b at its own position of its own plan; ``idle_slot`` takes
    the engine's idle row (t = 1, the identity update)."""
    from repro_torch.core.schedules import make_schedule
    from repro_torch.sampling import SamplerPlan
    sch = make_schedule("linear", 1000)
    cols = ("c_x0", "c_dir", "c_noise", "sqrt_a_t", "sqrt_1m_a_t")
    ts, rows = [], []
    for b, (S, k) in enumerate([(10, 1), (20, 13), (50, 47), (7, 3)]
                               [:DLM_BATCH]):
        tab = SamplerPlan.build(sch, S, x0=clip).steps()
        ts.append(int(tab["t"][k]))
        rows.append([float(tab[c][k]) for c in cols])
        if b == idle_slot:
            ts[-1] = 1
            rows[-1] = [1.0, 0.0, 0.0, 1.0, 1.0 if clip is not None else 0.0]
    return (torch.tensor(ts, dtype=torch.int32, device="cuda"),
            torch.tensor(rows, dtype=torch.float32, device="cuda"))


def phase_kernels_sched(params2):
    """B4 at the slice's shape and B7, against their plain versions."""
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.kernels.ddim_step import kernel as dk
    from repro_torch.kernels.ddim_step import ref as dref
    from repro_torch.kernels.megastep import kernel as mk
    from repro_torch.kernels.megastep import ref as mref
    from repro_torch.kernels.sampler_step import ops as sops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2468)
    errs = {k: [] for k in SCHED_KERNELS}
    n = DLM_BATCH * DLM_SEQ * cfg.latent_dim
    x2 = torch.randn(n // 256, 256, generator=gen, device=dev)
    rps = x2.shape[0] // DLM_BATCH
    for impl in ("exact", "flash"):
        for clip in (None, 1.0):
            ts, c = _slot_states(clip, idle_slot=3 if impl == "exact" else None)
            args = (x2, params2, cfg, DLM_BATCH, DLM_SEQ,
                    sops.expand_slot_coefs(c, rps), ts)
            got = mk.megastep_rows_call(*args, clip=clip, attn_impl=impl)
            want = mref.megastep_rows_ref(*args, clip=clip, attn_impl=impl)
            _check_rel(errs["megastep_rows_call"],
                       f"B4 {impl} clip={clip} t={ts.tolist()}", got, want,
                       1e-4)
            _check_repeat(f"B4 {impl} clip={clip}", got,
                          mk.megastep_rows_call(*args, clip=clip,
                                                attn_impl=impl))
    coefs = torch.tensor(B7_COEFS)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for R in (256, 1024):
            x, e, z = (torch.randn(R, 256, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            _report(errs["ddim_step_2d"], f"B7 R={R} C=256 {tag}",
                    dk.ddim_step_2d(x, e, z, coefs),
                    dref.ddim_step_body(x, e, z, coefs), dtype, exact=True)
    torch.cuda.synchronize()
    return {k: max(v) for k, v in errs.items()}


def _zero_counts():
    from repro_torch.kernels.megastep import kernel as mk
    from repro_torch.kernels.sampler_step import kernel as sk
    for fn in (sk.sampler_step_2d, sk.sampler_step_rows_2d, mk.megastep_call,
               mk.megastep_rows_call):
        fn.launches = 0


def _counts():
    from repro_torch.kernels.megastep import kernel as mk
    from repro_torch.kernels.sampler_step import kernel as sk
    return {"B1": sk.sampler_step_2d.launches,
            "B2": sk.sampler_step_rows_2d.launches,
            "B3": mk.megastep_call.launches,
            "B4": mk.megastep_rows_call.launches}


def phase_main_sched(model):
    """The continuous-batching scheduler at CIFAR10 width, counted: mixed
    plans admitted mid-flight, previews, deadlines expiring in the queue;
    every eta=0 result against a lone eager run of the same x_T, within
    SCHED_VS_EAGER_TOL of max|x| (measured 8.8e-7 on an H100: the
    batch-8 and batch-1 forwards may take other cuDNN algorithms)."""
    from repro_torch.core.schedules import make_schedule
    from repro_torch.kernels.sampler_step import ops as sops
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.sampling import SamplerPlan
    from repro_torch.sampling.specs import TauSpec
    from repro_torch.serving import (DiffusionSampler, SampleRequest,
                                     SlotCheckpoint)
    dev = torch.device("cuda")
    sch = make_schedule("linear", 1000)
    eps_fn = make_eps_fn(model)
    svc = DiffusionSampler(sch, eps_fn, CARD_SHAPE, batch_size=BATCH,
                           tile_resident=True)
    eng = svc.continuous(slots=SCHED_SLOTS, stochastic=True, max_order=2,
                         preview=True)
    gen = torch.Generator(device=dev).manual_seed(31)
    previews, reqs, x_T = [], [], {}
    for S in (10, 20, 50):
        for tau in ("uniform", "quadratic"):
            for eta, order in ((0.0, 1), (0.0, 2), (1.0, 1)):
                i = len(reqs)
                x = torch.randn((1,) + CARD_SHAPE, generator=gen, device=dev)
                x_T[i] = x
                reqs.append(SampleRequest(
                    request_id=i, seed=i,
                    plan=SamplerPlan.build(sch, TauSpec(kind=tau, S=S),
                                           sigma=eta, order=order),
                    preview_every=5 if i % 4 == 0 else 0,
                    on_preview=lambda rid, k, x0: previews.append(
                        (rid, k, bool(torch.isfinite(x0).all()))),
                    resume=SlotCheckpoint(
                        request_id=i, k=0, x_rows=sops.to_slot_tile_layout(
                            x)[0], hist_rows=None)))
    late = [SampleRequest(request_id=100 + j, S=20, eta=1.0, seed=100 + j)
            for j in range(6)]
    _zero_counts()
    t0 = time.perf_counter()
    for r in reqs[:12]:
        eng.submit(r)
    results = eng.tick() + eng.tick() + eng.tick()
    for r in reqs[12:]:
        eng.submit(r)
    for r in late:      # deadlines that pass while they wait in the queue
        eng.submit(dataclasses.replace(r, deadline=time.perf_counter()
                                       + 1e-3))
    time.sleep(2e-3)
    results += eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    st = eng.stats()
    print(f"[main] scheduler CIFAR10_UNET slots {SCHED_SLOTS}: {st['ticks']} "
          f"ticks, completed {st['completed']}, dropped {st['dropped']}, "
          f"deadline_missed {st['deadline_missed']}, previews "
          f"{st['previews_sent']}, occupancy {st['occupancy']:.3f}, "
          f"compiled_ticks {st['compiled_ticks']}, tick_variant "
          f"{st['tick_variant']}; launches {counts}; wall {wall:.2f} s")
    check(counts == {"B1": 0, "B2": st["ticks"], "B3": 0, "B4": 0},
          f"scheduler launches {counts}, want B2 == ticks {st['ticks']} "
          "and nothing else")
    check(st["compiled_ticks"] == 1 and st["completed"] == len(reqs)
          and st["dropped"] == len(late) and st["deadline_missed"]
          >= len(late) and not st["mega_tick"],
          f"scheduler stats {st}")
    check(len(previews) == st["previews_sent"] > 0
          and all(p[2] for p in previews), "previews missing or non-finite")
    by_id = {r.request_id: r for r in results}
    check(sorted(by_id) == sorted([r.request_id for r in reqs]
                                  + [r.request_id for r in late]),
          "a request has no result")
    worst = 0.0
    for r in reqs:
        res = by_id[r.request_id]
        check(res.x0.shape == CARD_SHAPE and bool(torch.isfinite(res.x0)
                                                  .all()),
              f"request {r.request_id}: bad x0")
        if r.plan.stochastic:
            continue
        lone = r.plan.run(eps_fn, x_T[r.request_id], backend="eager")[0]
        rel = float((res.x0 - lone).abs().max() / lone.abs().max())
        worst = max(worst, rel)
    print(f"[main] scheduler eta=0 x0 vs lone plan.run(backend='eager') of "
          f"the same x_T, 12 requests (S 10/20/50, order 1/2): worst "
          f"max|d|/max|x| = {worst:.3e} (tol {SCHED_VS_EAGER_TOL:g})")
    check(worst <= SCHED_VS_EAGER_TOL,
          f"scheduler vs lone eager: {worst} > {SCHED_VS_EAGER_TOL:g}")
    return counts, eng


def phase_main_dlm_sched(params2):
    """The scheduler's mega tick (B4) on the eligible 2-layer trunk,
    counted, against the unfused tick."""
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.core.schedules import make_schedule
    from repro_torch.diffusion_lm import make_tile_eps_fn, round_to_tokens
    from repro_torch.serving import ContinuousBatchingEngine, SampleRequest
    sch = make_schedule("linear", 1000)
    eps = make_tile_eps_fn(params2, cfg, DLM_BATCH, DLM_SEQ)
    shape = (DLM_SEQ, cfg.latent_dim)

    def requests():
        return [SampleRequest(request_id=i, S=DLM_SCHED_S[i % 2],
                              seed=200 + i) for i in range(8)]
    mega = ContinuousBatchingEngine(sch, eps, shape, slots=DLM_BATCH)
    plain = ContinuousBatchingEngine(sch, eps, shape, slots=DLM_BATCH,
                                     use_mega=False)
    check(mega.stats()["mega_tick"] and not plain.stats()["mega_tick"],
          "mega tick eligibility")
    _zero_counts()
    res_m = mega.serve(requests())
    torch.cuda.synchronize()
    counts = _counts()
    res_p = plain.serve(requests())
    torch.cuda.synchronize()
    st = mega.stats()
    print(f"[main] scheduler {cfg.arch.name} mega tick, slots {DLM_BATCH} x "
          f"{DLM_SEQ} tokens, 8 requests S {DLM_SCHED_S}: {st['ticks']} "
          f"ticks, completed {st['completed']}, tick_variant "
          f"{st['tick_variant']}, compiled_ticks {st['compiled_ticks']}; "
          f"launches {counts}")
    check(counts == {"B1": 0, "B2": 0, "B3": 0, "B4": st["ticks"]}
          and st["completed"] == 8 and st["compiled_ticks"] == 1,
          f"mega-tick launches {counts}, want B4 == ticks {st['ticks']}")
    xm = torch.stack([r.x0 for r in sorted(res_m, key=lambda r: r.request_id)])
    xp = torch.stack([r.x0 for r in sorted(res_p, key=lambda r: r.request_id)])
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(xm, xp))
    tokens = round_to_tokens(params2, xm)
    agree = float((tokens == round_to_tokens(params2, xp)).float().mean())
    print(f"[main] mega tick vs unfused tick, per request: worst "
          f"max|d|/max|x| = {rel:.3e} (tol 1e-3); tokens "
          f"{tuple(tokens.shape)} {tokens.dtype}, token agreement {agree:.4f}"
          f", first row {tokens[0, :8].tolist()}")
    check(rel <= 1e-3 and bool(torch.isfinite(xm).all()),
          f"mega vs unfused tick: {rel} > 1e-3")
    check(tokens.shape == (8, DLM_SEQ) and 0 <= int(tokens.min())
          and int(tokens.max()) < cfg.arch.vocab, "bad tokens")
    return counts, mega, plain


def _steady(eng, make_requests, label, smi, marker):
    """Steady slot-steps/s of ``eng`` over a second wave of requests, then
    a profile of one tick with every slot busy."""
    eng.reset_stats()
    eng.serve(make_requests(0))
    torch.cuda.synchronize()
    st = eng.stats()
    print(f"[times] {smi} | {label}: {st['slot_steps']} slot-steps in "
          f"{st['ticks']} ticks, {st['steps_per_s']:.1f} slot-steps/s, tick "
          f"EWMA {st['tick_ewma_s'] * 1e3:.2f} ms, occupancy "
          f"{st['occupancy']:.3f}")
    for r in make_requests(1000):
        eng.submit(r)
    eng.tick()
    profile_call(smi, f"one steady tick, {label}", eng.tick, marker)
    eng.run()
    return st


def _host_prep(smi, eng, label):
    """Host time per call of each piece of work the mega tick does before
    B4 starts (host clock, 100 calls, no synchronisation inside: what the
    host spends issuing it), with every slot of ``eng`` busy."""
    import ctypes
    from repro_torch.kernels.megastep import kernel as mk
    from repro_torch.kernels.sampler_step import ops as sops
    from repro_torch.models.common import (rope_freqs,
                                           sinusoidal_time_embedding)
    from repro_torch.serving import SampleRequest
    spec = eng.eps_fn.mega_spec
    cfg, params, B, S = spec.cfg, spec.params, spec.batch, spec.seq_len
    for i in range(eng.slots):
        eng.submit(SampleRequest(request_id=5000 + i, S=20, seed=i))
    eng.tick()                                  # admits: every slot busy
    states = eng._states()
    rows = sops.expand_slot_coefs(states.coef_matrix(), eng._rps)
    x2 = eng._x2[0]                     # the one row block off a mesh
    dev = x2.device
    w = mk._weights(params, cfg)
    plan = (ctypes.c_longlong * len(mk._PLAN))()
    lib = mk._lib()
    pieces = (
        ("engine _states", lambda: eng._states()),
        ("expand_slot_coefs", lambda: sops.expand_slot_coefs(
            states.coef_matrix(), eng._rps)),
        ("wrapper checks", lambda: mk._check_kernel_inputs(
            x2, mk._check_state(x2, params, cfg, B, S, spec.attn_impl), cfg,
            S)),
        ("sinusoid", lambda: sinusoidal_time_embedding(
            states.t, cfg.time_dim).contiguous()),
        ("RoPE table", lambda: rope_freqs(torch.arange(S, device=dev),
                                          mk.KERNEL_HEAD_DIM,
                                          cfg.arch.rope_theta)),
        ("ctypes weight struct", lambda: mk._weights(params, cfg)),
        ("plan query", lambda: lib.repro_megastep_plan(
            ctypes.byref(w), B, B, 1, eng.clip_x0 is not None,
            spec.attn_impl == "flash", plan)),
        ("workspace + output alloc", lambda: (
            torch.empty(plan[0], device=dev), torch.empty_like(x2))),
        ("whole megastep_rows_call", lambda: mk.megastep_rows_call(
            x2, params, cfg, B, S, rows, states.t, clip=eng.clip_x0,
            attn_impl=spec.attn_impl)),
        ("whole tick (states + expand + call)", lambda: eng._tick(False)(
            eng._x2, None, eng._states(), None)),
    )
    out = []
    for name, fn in pieces:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        us = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        out.append(f"{name} {us:.1f}")
    print(f"[host] {smi} | {label}, host time per call (us, host clock, "
          f"issue only): {'; '.join(out)}")
    eng.run()


def phase_times_sched(smi, params2, errs, b4_launches, eng_unet, dlm_mega,
                      dlm_plain):
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.core import StepStates, slot_tile_step
    from repro_torch.diffusion_lm import make_tile_eps_fn
    from repro_torch.kernels.ddim_step import kernel as dk
    from repro_torch.kernels.ddim_step import ref as dref
    from repro_torch.kernels.megastep import kernel as mk
    from repro_torch.kernels.megastep import ref as mref
    from repro_torch.kernels.sampler_step import ops as sops
    from repro_torch.serving import SampleRequest
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1357)
    recs = {}

    # B4: one scheduler tick at the slice's shape
    n = DLM_BATCH * DLM_SEQ * cfg.latent_dim
    x2 = torch.randn(n // 256, 256, generator=gen, device=dev)
    rps = x2.shape[0] // DLM_BATCH
    ts, c = _slot_states(None)
    rows = sops.expand_slot_coefs(c, rps)
    eps = make_tile_eps_fn(params2, cfg, DLM_BATCH, DLM_SEQ)
    n_bytes = (eps.mega_spec.weight_bytes() + 2 * n * 4 + rows.numel() * 4
               + DLM_BATCH * (4 + cfg.time_dim * 4) + DLM_SEQ * 64 * 4)
    b_ms, b_by = _bound(n_bytes, mega_ops(cfg, DLM_BATCH, DLM_SEQ, 1)
                        + 3 * n)
    args = (x2, params2, cfg, DLM_BATCH, DLM_SEQ, rows, ts)
    timer, how = _mega_timer(lambda: mk.megastep_rows_call(*args))
    for impl in ("exact", "flash"):
        rec = dict(
            ms=timer(lambda: mk.megastep_rows_call(*args, attn_impl=impl),
                     iters=5, reps=2),
            plain_ms=timer(lambda: mref.megastep_rows_ref(
                *args, attn_impl=impl), iters=5, reps=2),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"{cfg.arch.name} {DLM_BATCH} slots x {DLM_SEQ}, one "
                  f"tick, {impl}", timed_by=how,
            **_plan_keys(mk.megastep_rows_call.last_plan))
        _time_line(smi, f"B4 megastep_rows_call {rec['shape']}", rec)
        recs.setdefault("megastep_rows_call", rec)
    _phase_trace(smi, f"B4 megastep_rows_call {cfg.arch.name} exact",
                 mk.megastep_rows_call, lambda: mk.megastep_rows_call(*args),
                 1, cfg.arch.n_layers)
    states = StepStates(t=ts, c_x0=c[:, 0], c_dir=c[:, 1], c_noise=c[:, 2],
                        sqrt_a_t=c[:, 3], sqrt_1m_a_t=c[:, 4])
    shape = (DLM_SEQ, cfg.latent_dim)
    rows_ms = timer(lambda: slot_tile_step(eps, x2, states, shape),
                    iters=5, reps=2)
    b4 = recs["megastep_rows_call"]["ms"]
    print(f"[times] {smi} | unfused rows tick at the same shape (eager "
          f"trunk + B2): {rows_ms * 1e3:.2f} us ({how}); B4 / unfused = "
          f"{b4 / rows_ms:.3f}")
    check(b4 < rows_ms, f"B4 {b4 * 1e3:.1f} us is not below the unfused "
          f"rows tick {rows_ms * 1e3:.1f} us")

    # B7 at R = 1024, C = 256 (the wrapper reads host coefficients, the
    # plain version device ones: a graph captures no host-device copy)
    coefs = torch.tensor(B7_COEFS)
    coefs_dev = coefs.to(dev)
    for dtype, esz in ((torch.float32, 4), (torch.bfloat16, 2)):
        x, e, z = (torch.randn(1024, 256, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        b_ms, b_by = _bound(4 * x.numel() * esz, 5 * x.numel())
        tag = "f32" if dtype == torch.float32 else "bf16"
        rec = dict(ms=graph_ms(lambda: dk.ddim_step_2d(x, e, z, coefs)),
                   plain_ms=graph_ms(lambda: dref.ddim_step_body(
                       x, e, z, coefs_dev)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   shape=f"(1024, 256) {tag}")
        _time_line(smi, f"B7 ddim_step_2d {rec['shape']}", rec)
        recs.setdefault("ddim_step_2d", rec)

    # the engines: steady slot-steps/s and one profiled tick each
    def unet_requests(base):
        return [SampleRequest(request_id=base + i, S=50, seed=base + i)
                for i in range(SCHED_SLOTS)]

    def dlm_requests(base):
        return [SampleRequest(request_id=base + i, S=20, seed=base + i)
                for i in range(DLM_BATCH)]
    _steady(eng_unet, unet_requests, f"scheduler CIFAR10_UNET {SCHED_SLOTS} "
            "slots (stochastic, order 2, preview), S=50", smi,
            "step_rows_kernel")
    _steady(dlm_mega, dlm_requests, f"scheduler {cfg.arch.name} mega tick "
            f"{DLM_BATCH} slots, S=20", smi, "megastep_kernel")
    _host_prep(smi, dlm_mega, f"scheduler {cfg.arch.name} mega tick "
               f"{DLM_BATCH} slots")
    _steady(dlm_plain, dlm_requests, f"scheduler {cfg.arch.name} unfused tick"
            f" {DLM_BATCH} slots, S=20", smi, "step_rows_kernel")

    launches = {"megastep_rows_call": b4_launches, "ddim_step_2d": 0}
    return [_record(name, SCHED_KERNELS[name], launches[name], errs[name], r)
            for name, r in recs.items()]


# ------------------------------------------------------------------ phase 9
P9_SLOTS = 8
P9_N = 24                      # requests of the gateway run (one expires)
P9_SWAP_N = (8, 4)             # hot swap: in flight, submitted during it
P9_RATE_N = 32                 # requests per rate round: 2 waves per pool
P9_RATE_ROUNDS = 3             # gateway / core / direct rounds, alternated
P9_CHAOS_N = 32                # requests of the chaos replay
P9_BACKOFF = 4                 # the chaos breaker's backoff, pumps
P9_EVENT_REPS = 200            # repetitions of the per-event copy timing


def _p9_weights(model):
    """The two models of the gateway (the seeded CIFAR10 U-Net and a
    differently seeded one, as state dicts on the card) and the shared
    trunk ``eps_apply(params, x, t)``."""
    from torch.func import functional_call
    base = {k: v.detach().clone() for k, v in model.state_dict().items()}
    alt = {k: v.detach().clone()
           for k, v in _cifar10_model(seed=1).state_dict().items()}

    def eps_apply(params, x, t):
        return functional_call(model, params, (x, t))
    return base, alt, eps_apply


def _p9_specs(n, seed0, S=(10, 20), preview_every=0, model=None):
    """``n`` wire specs alternating models base / alt (or all ``model``)
    and S; every third streams previews when ``preview_every``."""
    return [{"model": model or ("base", "alt")[i % 2],
             "S": S[i // 2 % len(S)], "seed": seed0 + i,
             **({"preview_every": preview_every}
                if preview_every and i % 3 == 0 else {})}
            for i in range(n)]


def _lone_x0(eng, specs):
    """x0 by seed of the specs served by a lone engine (no fleet, no
    supervisor), 8 slots like the pools: the same tick shape."""
    from repro_torch.serving import SampleRequest
    res = eng.serve([SampleRequest(request_id=i, S=s["S"], seed=s["seed"])
                     for i, s in enumerate(specs)])
    return {specs[r.request_id]["seed"]: r.x0 for r in res}


class _Client:
    """An asyncio client in this process: every call goes through
    ``bridge.acall(core.submit, spec, on_event)``, as each HTTP handler
    does, and the events come back through ``call_soon_threadsafe``."""

    def __init__(self, bridge):
        self.bridge, self.core = bridge, bridge.core

    async def submit(self, spec):
        import asyncio
        q, loop = asyncio.Queue(), asyncio.get_running_loop()
        t0 = time.perf_counter()
        rid = await self.bridge.acall(
            self.core.submit, dict(spec),
            lambda ev: loop.call_soon_threadsafe(q.put_nowait, ev))
        return rid, q, t0, spec

    @staticmethod
    async def collect(rid, q, t0, spec):
        events = []
        while not events or events[-1]["event"] not in ("result", "error"):
            events.append(await q.get())
        return {"rid": rid, "spec": spec, "events": events, "q": q,
                "latency_s": time.perf_counter() - t0}

    async def run(self, specs):
        import asyncio
        subs = await asyncio.gather(*(self.submit(s) for s in specs))
        return await asyncio.gather(*(self.collect(*s) for s in subs))

    async def idle(self):
        import asyncio
        while await self.bridge.acall(lambda: self.core.busy):
            await asyncio.sleep(0.01)


def _check_streams(runs, what):
    """Exactly one terminal event per request, previews before it in step
    order, as many as the result counts."""
    for r in runs:
        kinds = [e["event"] for e in r["events"]]
        steps = [e["step"] for e in r["events"] if e["event"] == "preview"]
        check(r["q"].empty() and kinds[-1] in ("result", "error")
              and set(kinds[:-1]) <= {"preview"} and steps == sorted(steps),
              f"{what}: request {r['rid']} events {kinds}")
        if kinds[-1] == "result":
            check(r["events"][-1]["previews"] == len(steps),
                  f"{what}: request {r['rid']} counted "
                  f"{r['events'][-1]['previews']} previews, sent "
                  f"{len(steps)}")


def phase_gateway(smi, model):
    """Phase 9, items 1-2: the gateway at CIFAR10 width (2 models, one
    8-slot pool each, probes, supervised) driven through the bridge by an
    asyncio client, the rolling hot swap under load, the gateway's rate
    against the same fleet pumped directly, and the per-event copy cost.
    Returns (B2 launches of the counted paths, base, alt, eps_apply,
    the lone engines)."""
    import asyncio
    from repro_torch.core.schedules import make_schedule
    from repro_torch.obs.schema import GATEWAY_STATS_KEYS
    from repro_torch.serving import (ContinuousBatchingEngine, SampleRequest)
    from repro_torch.serving.gateway import (EngineBridge, GatewayCore,
                                             OverloadPolicy)
    from repro_torch.serving.gateway.core import wire_event
    sch = make_schedule("linear", 1000)
    base, alt, eps_apply = _p9_weights(model)
    # margin 0: no feasibility shedding, so that the short-deadline request
    # expires in the queue (504) as in the JAX package's gateway test
    core = GatewayCore.build(sch, eps_apply, CARD_SHAPE,
                             models={"base": base, "alt": alt},
                             slots=P9_SLOTS, probes=True,
                             policy=OverloadPolicy(margin=0.0))
    lone = {name: ContinuousBatchingEngine(
        sch, eps_apply, CARD_SHAPE, P9_SLOTS, eps_params=w, preview=True,
        probes=True) for name, w in (("base", base), ("alt", alt))}
    ticks0 = {p.pool_id: p.stats()["compiled_ticks"]
              for p in core.fleet.pools}

    # --- 1. the gateway run, counted
    specs = _p9_specs(P9_N - 1, 9000, preview_every=5)

    async def main_run(bridge):
        client = _Client(bridge)
        subs = await asyncio.gather(*(client.submit(s) for s in specs))
        # the last request is submitted once every slot is resident: its
        # deadline passes in the queue (EDF puts it first) before a slot
        # frees, so it expires there
        while await bridge.acall(lambda: core.fleet.active) < 2 * P9_SLOTS:
            await asyncio.sleep(0.002)
        subs.append(await client.submit({"model": "alt", "S": 10,
                                         "seed": 9999, "deadline_s": 1e-3}))
        runs = await asyncio.gather(*(client.collect(*s) for s in subs))
        await client.idle()
        return runs

    _zero_counts()
    bridge = EngineBridge(core).start()
    t0 = time.perf_counter()
    runs = asyncio.run(main_run(bridge))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _counts()
    st = core.stats()
    check(bridge.error is None, f"gateway bridge failed: {bridge.error!r}")
    _check_streams(runs, "gateway")
    term = {r["rid"]: r["events"][-1] for r in runs}
    expired = runs[-1]["events"][-1]
    check(expired["event"] == "error" and expired["code"] == "expired"
          and expired["status"] == 504,
          f"the short-deadline request ended {expired}")
    ok = [r for r in runs[:-1] if r["events"][-1]["event"] == "result"]
    check(len(ok) == P9_N - 1, f"{len(ok)} of {P9_N - 1} requests got a "
          f"result: {[r['events'][-1] for r in runs[:-1]]}")
    n_prev = sum(e["event"] == "preview" for r in runs for e in r["events"])
    want = {}
    for name in ("base", "alt"):
        mine = [r["spec"] for r in ok if r["spec"]["model"] == name]
        want.update(_lone_x0(lone[name], mine))
    same = [torch.equal(r["events"][-1]["x0"], want[r["spec"]["seed"]])
            for r in ok]
    print(f"[gateway] {smi} | GatewayCore CIFAR10_UNET 2 models x 1 pool x "
          f"{P9_SLOTS} slots (probes, supervised), {len(runs)} requests "
          f"through EngineBridge from an asyncio client (S 10 / 20, "
          f"{n_prev} previews streamed, one 1 ms deadline) in {wall:.2f} s: "
          f"terminal events {len(term)} ({len(ok)} results, expired "
          f"{expired['status']} {expired['code']}); x0 bitwise a lone "
          f"unsupervised engine's for {sum(same)} of {len(same)}; pool "
          f"ticks {[p['ticks'] for p in st['fleet']['pools']]}, launches "
          f"{counts}")
    check(all(same), "gateway x0 differs from a lone engine's")
    check(n_prev > 0 and st["previews_streamed"] == n_prev,
          f"previews streamed {n_prev}, counted {st['previews_streamed']}")
    check(set(st) == GATEWAY_STATS_KEYS and st["expired"] == 1
          and st["results_streamed"] == P9_N - 1,
          f"gateway stats {dict((k, st[k]) for k in ('expired', 'results_streamed'))}")
    check(counts == {"B1": 0, "B2": st["fleet"]["ticks"], "B3": 0, "B4": 0},
          f"gateway launched {counts}, want B2 == pool ticks "
          f"{st['fleet']['ticks']}")
    n_b2 = counts["B2"]

    # --- 2. the rolling hot swap under load, counted
    pool = next(p for p in core.fleet.pools if p.model == "base")
    v0 = core.registry.version("base")
    inflight = _p9_specs(P9_SWAP_N[0], 9100, S=(20,), model="base")
    during = _p9_specs(P9_SWAP_N[1], 9200, S=(10,), model="base")

    async def swap_run(bridge):
        client = _Client(bridge)
        subs = await asyncio.gather(*(client.submit(s) for s in inflight))
        while await bridge.acall(lambda: pool.engine.active) < P9_SLOTS:
            await asyncio.sleep(0.002)
        n_pools = await bridge.acall(core.hot_swap, "base", alt)
        subs += await asyncio.gather(*(client.submit(s) for s in during))
        runs = await asyncio.gather(*(client.collect(*s) for s in subs))
        await client.idle()
        return n_pools, runs

    _zero_counts()
    n_pools, swap_runs = asyncio.run(swap_run(bridge))
    torch.cuda.synchronize()
    counts = _counts()
    st2 = core.stats()
    _check_streams(swap_runs, "hot swap")
    old = _lone_x0(lone["base"], inflight)
    new = _lone_x0(lone["alt"], during)
    same_old = [torch.equal(r["events"][-1]["x0"], old[r["spec"]["seed"]])
                for r in swap_runs[:len(inflight)]]
    same_new = [torch.equal(r["events"][-1]["x0"], new[r["spec"]["seed"]])
                for r in swap_runs[len(inflight):]]
    ticks1 = {p.pool_id: p.stats()["compiled_ticks"]
              for p in core.fleet.pools}
    print(f"[swap] {smi} | hot_swap('base', alt weights) over {n_pools} "
          f"pool with {len(inflight)} requests resident: in-flight x0 "
          f"bitwise the old weights' (lone engine) {sum(same_old)} of "
          f"{len(same_old)}, {len(during)} submitted during the walk "
          f"bitwise the new weights' {sum(same_new)} of {len(same_new)}; "
          f"version {v0} -> {core.registry.version('base')}, swaps "
          f"{st2['swaps']}, compiled_ticks {ticks0} -> {ticks1}, "
          f"launches {counts}")
    check(all(same_old) and all(same_new) and n_pools == 1,
          "hot swap: x0 differs from the old / new weights' lone runs")
    check(core.registry.version("base") == v0 + 1 and st2["swaps"] == 1
          and core.swapping is None, "hot swap did not promote the version")
    check(ticks1 == ticks0, f"hot swap built a tick: {ticks0} -> {ticks1}")
    check(counts == {"B1": 0, "B2": st2["fleet"]["ticks"] - st["fleet"][
        "ticks"], "B3": 0, "B4": 0},
        f"hot swap launched {counts}, want B2 == pool ticks")
    n_b2 += counts["B2"]
    bridge.stop()

    # --- 3. slot-steps/s: the gateway (bridge thread, supervisor, events)
    # against the same 2-pool fleet pumped directly in this thread, and
    # between them the gateway core pumped in this thread (its tier's cost
    # without the bridge), alternated; S=20, every slot busy, 2 waves per
    # pool
    def gateway_round(i):
        # a fresh engine thread first serves 2 short requests untimed: a
        # thread's first kernels pay for its own cuDNN / cuBLAS handles,
        # which a long-lived gateway thread pays once
        b = EngineBridge(core).start()
        t0 = time.perf_counter()
        asyncio.run(_Client(b).run(_p9_specs(2, 10090 + 100 * i, S=(2,))))
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        rs = asyncio.run(_Client(b).run(_p9_specs(
            P9_RATE_N, 10000 + 100 * i, S=(20,))))
        dt = time.perf_counter() - t0
        b.stop()
        check(b.error is None and all(r["events"][-1]["event"] == "result"
                                      for r in rs), "gateway rate round")
        return P9_RATE_N * 20 / dt, [r["latency_s"] for r in rs], warm

    def core_round(i):               # the gateway tier, no bridge thread
        specs, done = _p9_specs(P9_RATE_N, 30000 + 100 * i, S=(20,)), []
        t0 = time.perf_counter()
        with torch.no_grad():
            for spec in specs:
                core.submit(spec, done.append)
            core.run_until_idle()
        dt = time.perf_counter() - t0
        check(len(done) == P9_RATE_N and all(e["event"] == "result"
                                             for e in done), "core round")
        return P9_RATE_N * 20 / dt

    def direct_round(i):
        reqs = [SampleRequest(request_id=20000 + 100 * i + j, S=20,
                              seed=20000 + 100 * i + j,
                              model=("base", "alt")[j % 2])
                for j in range(P9_RATE_N)]
        t0 = time.perf_counter()
        with torch.no_grad():
            out = core.fleet.serve(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(len(out) == P9_RATE_N and not any(r.dropped for r in out),
              "direct fleet round")
        return P9_RATE_N * 20 / dt

    rates = {"gateway": [], "core": [], "direct": []}
    lat, warms = [], []
    for i in range(P9_RATE_ROUNDS):
        r, ls, warm = gateway_round(i)
        rates["gateway"].append(r)
        lat += ls
        warms.append(warm)
        rates["core"].append(core_round(i))
        rates["direct"].append(direct_round(i))
    med = {k: statistics.median(v) for k, v in rates.items()}
    lat.sort()
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    print(f"[gateway] {smi} | steady slot-steps/s (S=20, 2 x {P9_SLOTS} "
          f"slots busy, {P9_RATE_N} requests a round), {P9_RATE_ROUNDS} "
          f"rounds alternated: gateway through the bridge median "
          f"{med['gateway']:.1f} ({', '.join(f'{r:.1f}' for r in rates['gateway'])}), "
          f"the gateway core pumped in this thread median {med['core']:.1f} "
          f"({', '.join(f'{r:.1f}' for r in rates['core'])}), "
          f"the same fleet pumped in this thread median {med['direct']:.1f} "
          f"({', '.join(f'{r:.1f}' for r in rates['direct'])}), ratio of "
          f"medians {med['gateway'] / med['direct']:.3f}; request latency "
          f"through the bridge over {len(lat)} requests p50 "
          f"{p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms; each new engine "
          f"thread's first 2 requests (S=2, untimed above) "
          f"{', '.join(f'{w * 1e3:.1f}' for w in warms)} ms")

    # --- 4. host cost per event of the transport's copy and encoding of
    # one CIFAR10 x0 (3,072 floats on the card)
    x0 = ok[0]["events"][-1]["x0"]
    ev = dict(ok[0]["events"][-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(P9_EVENT_REPS):
        x0.detach().float().cpu()
    copy_us = (time.perf_counter() - t0) / P9_EVENT_REPS * 1e6
    t0 = time.perf_counter()
    for _ in range(P9_EVENT_REPS):
        body = json.dumps(wire_event(ev))
    enc_us = (time.perf_counter() - t0) / P9_EVENT_REPS * 1e6
    print(f"[event] {smi} | one result event, x0 {tuple(x0.shape)} "
          f"({x0.numel()} floats) on the card: copy to the host "
          f"{copy_us:.1f} us, copy + wire_event + json.dumps {enc_us:.1f} us "
          f"({len(body)} bytes), mean of {P9_EVENT_REPS}")
    return n_b2, base, alt, eps_apply, lone


def phase_chaos(smi, base, alt, eps_apply, lone):
    """Phase 9, item 3: a deterministic chaos replay on a supervised
    gateway (base / alt, one 8-slot pool each, probes, a checkpoint every
    tick) through the bridge, and an unsupervised core that poisons its
    bridge.  Returns the B2 launches of the replay."""
    import tempfile
    from repro_torch.core.schedules import make_schedule
    from repro_torch.obs import ListSink, Observability, \
        detect_weight_corruption
    from repro_torch.serving import RequestError
    from repro_torch.serving.gateway import (EngineBridge, GatewayCore,
                                             OverloadPolicy)
    from repro_torch.serving.resilience import (BreakerPolicy, BreakerState,
                                                Fault, FaultInjector,
                                                FaultPlan, InjectedFault)
    sch = make_schedule("linear", 1000)
    tmp = tempfile.mkdtemp(prefix="repro_p9_chaos_")
    # per-pool busy tick indices; pools follow the sorted model names, so
    # pool 0 serves alt and pool 1 base.  Pool 1 faults at tick 10, right
    # after its S=10 residents retired and their successors were
    # dispatched to it: its local queue and its S=20 residents migrate.
    # The weights are corrupted x4, not JAX's default x8: at x8 this
    # U-Net's activations grow with every scaled layer until GroupNorm's
    # float32 statistics overflow and eps collapses to zero, which
    # detect_weight_corruption (a jump up by `factor`) cannot see.
    plan = FaultPlan([
        Fault(kind="nan-eps", pool=0, tick=3),
        Fault(kind="tick-latency", pool=0, tick=4, delay_s=0.05),
        Fault(kind="corrupted-weights", pool=0, tick=6, scale=4.0),
        Fault(kind="tick-error", pool=1, tick=10)])
    inj = FaultInjector(plan)
    o = Observability()
    sink = o.add_sink(ListSink())
    core = GatewayCore.build(
        sch, eps_apply, CARD_SHAPE, models={"base": base, "alt": alt},
        slots=P9_SLOTS, probes=True, flight_dir=tmp, flight_capacity=256,
        checkpoint_every=1, injector=inj, obs=o,
        breaker=BreakerPolicy(backoff_pumps=P9_BACKOFF, probe_ticks=2),
        policy=OverloadPolicy(margin=0.0))
    sup = core.supervisor
    faulted = core.fleet.pools[1].model
    specs = _p9_specs(P9_CHAOS_N, 7000)
    events, spec_of, done = {}, {}, []

    def handler(box):                 # called on the engine thread
        def on_event(ev):
            events[box[0]].append(ev)
            if ev["event"] in ("result", "error"):
                done.append(box[0])
        return on_event
    for spec in specs:                # a fixed arrival: all before pumping
        box = []
        box.append(core.submit(dict(spec), handler(box)))
        events[box[0]], spec_of[box[0]] = [], spec
    log, seen = [], {}
    orig = core.pump

    def pump(now=None):               # runs on the engine thread
        n = orig(now)
        st = sup.breaker(1).state
        h = core.health()
        log.append((sup.stats()["pumps"], time.perf_counter(), st,
                    h["status"]))
        if h["status"] == "degraded" and "health" not in seen:
            seen["health"] = h
        if st is BreakerState.OPEN and "refusal" not in seen:
            try:
                core.submit({"model": faulted, "S": 10, "seed": 1},
                            lambda ev: None)
                seen["refusal"] = None
            except RequestError as e:
                seen["refusal"] = (e.code.value, e.status, e.retry_after_s)
        return n

    core.pump = pump
    _zero_counts()
    bridge = EngineBridge(core).start()
    t_end = time.perf_counter() + 300.0
    while len(done) < len(specs) and bridge.error is None \
            and time.perf_counter() < t_end:
        time.sleep(0.01)
    while bridge.call(lambda: core.busy).result(30):
        time.sleep(0.01)
    torch.cuda.synchronize()
    counts = _counts()
    alive = bridge.error is None and bridge.call(lambda: 7).result(30) == 7
    bridge.stop()
    st = core.stats()
    sst = st["resilience"]
    check(len(done) == len(specs) and sorted(done) == sorted(events),
          f"chaos: {len(done)} of {len(specs)} requests ended, "
          f"{len(set(done))} distinct")
    check(all(sum(e["event"] in ("result", "error") for e in evs) == 1
              for evs in events.values()), "chaos: a request got two "
          "terminal events")
    # quarantine, migration, resume
    trips = [i for i, (_, _, s, _) in enumerate(log)
             if s is BreakerState.OPEN]
    check(sst["quarantines"] == 1 and inj.fired("tick-error") == 1
          and bool(trips), f"chaos: quarantines {sst['quarantines']}, "
          f"tick errors fired {inj.fired('tick-error')}")
    i_trip = trips[0]
    i_half = next((i for i in range(i_trip, len(log))
                   if log[i][2] is BreakerState.HALF_OPEN), None)
    i_closed = next((i for i in range(i_half or i_trip, len(log))
                     if log[i][2] is BreakerState.CLOSED), None)
    check(i_half is not None and i_closed is not None,
          f"chaos: pool 1 was not re-admitted and closed: "
          f"{[(n, s.value) for n, _, s, _ in log]}")
    rec = {"trip_pump": log[i_trip][0],
           "readmit_pumps": log[i_half][0] - log[i_trip][0],
           "close_pumps": log[i_closed][0] - log[i_trip][0],
           "readmit_s": log[i_half][1] - log[i_trip][1],
           "close_s": log[i_closed][1] - log[i_trip][1]}
    resumed = sorted({e["req"] for e in sink.events
                      if e["ev"] == "requeue" and e.get("resumed")})
    want = _lone_x0(lone[faulted], [spec_of[r] for r in resumed])
    same = [torch.equal(events[r][-1]["x0"], want[spec_of[r]["seed"]])
            for r in resumed if events[r][-1]["event"] == "result"]
    h = seen.get("health", {})
    q = h.get("quarantined") or [{}]
    print(f"[chaos] {smi} | FaultPlan {[(f.kind, f.pool, f.tick) for f in plan]} "
          f"on a supervised gateway (alt / base x 1 pool x {P9_SLOTS} slots, "
          f"probes, checkpoint every tick, backoff {P9_BACKOFF} pumps), "
          f"{len(specs)} requests through the bridge: faults fired "
          f"{[f.kind for f in inj.log]}; pool 1 quarantined at pump "
          f"{rec['trip_pump']} ({q[0].get('last_error')}), requeued "
          f"{sst['requeued']}, migrated {sst['migrated']}, restarted "
          f"{sst['restarted']}; submit while OPEN -> {seen.get('refusal')}; "
          f"re-admitted (HALF_OPEN) {rec['readmit_pumps']} pumps / "
          f"{rec['readmit_s'] * 1e3:.1f} ms after the trip, CLOSED "
          f"{rec['close_pumps']} pumps / {rec['close_s'] * 1e3:.1f} ms after; "
          f"health {h.get('status')} -> {core.health()['status']}; resumed "
          f"requests {resumed}: x0 bitwise their uninterrupted lone run "
          f"{sum(same)} of {len(same)}; launches {counts}, pool ticks "
          f"{[p['ticks'] for p in st['fleet']['pools']]}")
    check(sst["migrated"] >= 1 and resumed and len(same) == len(resumed)
          and all(same), "chaos: resumed x0 differs from the "
          "uninterrupted run")
    check(h.get("status") == "degraded" and q[0].get("pool") == 1
          and "InjectedFault" in str(q[0].get("last_error"))
          and core.health()["status"] == "ok"
          and log[-1][2] is BreakerState.CLOSED,
          f"chaos: health {h} then {core.health()}")
    check(seen.get("refusal") is not None
          and seen["refusal"][:2] == ("model-unavailable", 503)
          and seen["refusal"][2] >= 1,
          f"chaos: submit while OPEN -> {seen.get('refusal')}")
    # the NaN request: a typed 5xx, no garbage streamed anywhere
    [poison] = inj.poisoned
    pev = events[poison["request_id"]]
    finite = all(bool(torch.isfinite(e["x0"]).all())
                 for evs in events.values() for e in evs if "x0" in e)
    print(f"[chaos] {smi} | nan-eps poisoned {poison}: events "
          f"{[(e['event'], e.get('code'), e.get('status')) for e in pev]}, "
          f"every streamed x0 finite {finite}, nonfinite {st['nonfinite']}")
    check(len(pev) == 1 and pev[0]["event"] == "error"
          and pev[0]["code"] == "nonfinite-sample" and pev[0]["status"] == 500
          and "x0" not in pev[0] and finite and st["nonfinite"] == 1,
          f"chaos: the poisoned request ended {pev}")
    # the corrupted weights: every sample finite, the ring names the pool
    hits = {pid: detect_weight_corruption(core.flight_snapshot(pid)["frames"])
            for pid in (0, 1)}

    print(f"[chaos] {smi} | corrupted-weights {inj.corrupted}: "
          f"detect_weight_corruption on pool 0's frames {hits[0]}, on "
          f"pool 1's {hits[1]}; compiled_ticks "
          f"{[p['compiled_ticks'] for p in st['fleet']['pools']]}; bridge "
          f"alive {alive}; tick-latency injected "
          f"{sup.take_injected_delay():.3f} s")
    check(inj.corrupted and hits[0] is not None and hits[0]["pool"] == 0,
          f"chaos: corruption not attributed to pool 0: {hits}")
    check(all(p["compiled_ticks"] == 1 for p in st["fleet"]["pools"]),
          "chaos: an install built a tick")
    check(alive and inj.fired() == 4, f"chaos: bridge alive {alive}, "
          f"faults fired {inj.fired()}")
    check(counts == {"B1": 0, "B2": st["fleet"]["ticks"], "B3": 0, "B4": 0},
          f"chaos launched {counts}, want B2 == pool ticks "
          f"{st['fleet']['ticks']}")

    # the same tick fault without a supervisor poisons the bridge
    bad = GatewayCore.build(sch, eps_apply, CARD_SHAPE, models={"base": base},
                            slots=P9_SLOTS, supervise=False, warm=False)
    eng = bad.fleet.pools[0].engine
    tick, calls = eng.tick, []

    def failing_tick(now=None):
        calls.append(now)
        if len(calls) == 2:
            raise InjectedFault(Fault(kind="tick-error", pool=0, tick=1))
        return tick(now)

    eng.tick = failing_tick
    b2 = EngineBridge(bad).start()
    b2.call(bad.submit, {"model": "base", "S": 10, "seed": 1},
            lambda ev: None).result(30)
    t_end = time.perf_counter() + 60.0
    while b2.error is None and time.perf_counter() < t_end:
        time.sleep(0.01)
    try:
        b2.call(bad.stats)
        refused = False
    except RuntimeError as e:
        refused = "engine thread failed" in str(e)
    b2.stop()
    print(f"[chaos] {smi} | unsupervised core, the same tick fault: bridge "
          f"error {b2.error!r}, later calls refused {refused}")
    check(isinstance(b2.error, InjectedFault) and refused,
          "the unsupervised core did not poison its bridge")
    return counts["B2"]


def phase_serve_cli(smi):
    """Phase 9, item 4: the port's serving CLI on the card, counted."""
    import contextlib
    import io
    from repro_torch.launch import serve
    argv = ["--arch", "unet", "--scheduler", "--slots", "4", "--s-mix",
            "4,6,8", "--tau", "mix", "--order", "2", "--n-samples", "6"]
    buf = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    torch.cuda.synchronize()
    counts = _counts()
    out = buf.getvalue().splitlines()
    reqs = [line for line in out if re.match(r"req\d+: SamplerPlan\(", line)]
    m = next((re.match(r"^\s+-\s+active\s+0/4\s+0\s+(\d+)\s", line)
              for line in out if re.match(r"^\s+-\s+active", line)), None)
    ticks = int(m.group(1)) if m else -1
    print(f"[cli] {smi} | python -m repro_torch.launch.serve "
          f"{' '.join(argv)} (device cuda): launches {counts}, engine ticks "
          f"{ticks}")
    for line in out:
        print(f"[cli]   {line}")
    check(len(reqs) == 6 and counts == {"B1": 0, "B2": ticks, "B3": 0,
                                        "B4": 0},
          f"CLI: {len(reqs)} request lines, launches {counts}, ticks {ticks}")
    try:
        import aiohttp  # noqa: F401
        have = True
    except ImportError:
        have = False
    if have:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--arch", "unet", "--gateway", "--smoke"])
        line = buf.getvalue().strip().splitlines()[-1]
        print(f"[cli] {smi} | aiohttp importable: --gateway --smoke on the "
              f"card: {line}")
        check(line.endswith("(OK)"), f"--gateway --smoke: {line}")
    else:
        print("[cli] aiohttp is not importable here: --gateway --smoke not "
              "run (the HTTP transport is not a device path; the CPU tests "
              "hold it)")
    return counts["B2"]


# ------------------------------------------------- phase 10: AR serving
LM_ROWS = ((0.0, 0), (0.0, 0), (0.8, 50), (1.0, 0))   # (temperature, top_k)
LM_NEW = 32
LM_FORWARD_TOL = 1e-4      # of max|logits|: the cache path against forward
LM_VARIANT_TOL = 1e-6      # of max|logits|: decode_step against per-layer
LM_GUMBEL_TIE = 8          # f32 ulps of max(|z|, 1): a card/CPU Gumbel tie


def _all_counts():
    """Launch counts of all seven kernels."""
    from repro_torch.kernels.ddim_step import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    return dict(_counts(), B5=fk.flash_attention.launches,
                B6=rk.rms_norm_2d.launches, B7=dk.ddim_step_2d.launches)


def _zero_all_counts():
    from repro_torch.kernels.ddim_step import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    _zero_counts()
    for fn in (fk.flash_attention, rk.rms_norm_2d, dk.ddim_step_2d):
        fn.launches = 0


def _lm_requests(cfg, prompt_len, new, seed=0, rows=LM_ROWS):
    import numpy as np
    from repro_torch.serving import GenRequest
    rs = np.random.RandomState(seed)
    return [GenRequest(prompt=rs.randint(0, cfg.vocab, prompt_len)
                       .astype(np.int32), max_new_tokens=new,
                       temperature=t, top_k=k, rng_seed=seed + i)
            for i, (t, k) in enumerate(rows)]


def _lm_run(gen, reqs, record: bool):
    """One counted generate.  Spies on the decode step (cache pointer and
    allocated bytes before every call, no sync) and, with ``record``, on
    the sampler (its logits, keys and tokens, cloned on the card)."""
    import dataclasses as dc
    ptrs, steps = [], []
    decode = gen.api.decode_step

    def spy_decode(params, cfg, tokens, cache):
        ptrs.append((cache["k"].data_ptr(), cache["v"].data_ptr(),
                     torch.cuda.memory_allocated()))
        return decode(params, cfg, tokens, cache)

    def spy_sample(logits, temps, top_ks, subs, max_k):
        nxt = type(gen)._sample_tokens(logits, temps, top_ks, subs, max_k)
        steps.append((logits.clone(), subs.clone(), nxt.clone(), temps,
                      top_ks, max_k))
        return nxt

    api = gen.api
    gen.api = dc.replace(api, decode_step=spy_decode)
    if record:
        gen._sample_tokens = spy_sample
    _zero_all_counts()
    try:
        res = gen.generate(reqs)
    finally:
        gen.api = api
        gen.__dict__.pop("_sample_tokens", None)
    torch.cuda.synchronize()
    return res, ptrs, steps, _all_counts()


def _decode_per_layer(params, cfg, tokens, cache):
    """JAX's decode_step structure: every layer calls the per-layer
    attention.gqa_decode_step, which builds the step's tables itself."""
    from repro_torch.models import dense
    from repro_torch.models.attention import gqa_decode_step
    from repro_torch.models.common import rms_norm
    h = params["embed"][tokens]
    for i in range(cfg.n_layers):
        layer = dense.layer_params(params["layers"], i)
        out, _, _ = gqa_decode_step(
            cache["k"][i], cache["v"][i], cache["idx"], layer["attn"], cfg,
            rms_norm(h, layer["attn_norm"], cfg.norm_eps))
        h = dense._mlp(layer, cfg, h + out)
    cache["idx"].add_(1)
    return dense._logits(params, cfg, h)[:, 0], cache


def _near_tie(row: torch.Tensor, tol: float) -> bool:
    top2 = torch.topk(row.double(), 2).values
    return float(top2[0] - top2[1]) <= tol


def _lm_device_profile(fn):
    """torch.profiler over one steady call: (wall ms unprofiled, device
    busy ms, device ops launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:4]
    return (statistics.median(walls), busy, sum(e.count for e in rows),
            [(e.key[:70], e.self_device_time_total / 1e3, e.count)
             for e in top])


def phase_lm(smi, cfg, prompt_len):
    """Phase 10: ARGenerator on one dense architecture at full width,
    float32, batch 4 (rows greedy, greedy, T 0.8 top-k 50, T 1.0), with
    every check on the card.  Returns the peak allocated bytes."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.models import dense
    from repro_torch.serving import ARGenerator
    dev = torch.device("cuda")
    name = cfg.name
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dense.init_params(prng.PRNGKey(0, dev), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[lm] {smi} | {name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.hd()}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied "
          f"{cfg.tie_embeddings}: {n_params:,} parameters "
          f"({n_params * 4 / 1e9:.3f} GB float32) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    B, P, N = len(LM_ROWS), prompt_len, LM_NEW
    M = P + N
    gen = ARGenerator(cfg, params, batch_size=B, max_len=M)
    reqs = _lm_requests(cfg, P, N)
    gen.generate(_lm_requests(cfg, P, 2))            # warm-up (handles)
    # (1) the timed run: the cache's pointers and allocated bytes per step
    res, ptrs, _, counts = _lm_run(gen, reqs, record=False)
    r = res[0]
    print(f"[lm] {smi} | {name}: generate batch {B}, prompt {P}, {N} new "
          f"tokens: prefill {r.prefill_ms:.3f} ms, decode {r.decode_ms:.3f} "
          f"ms ({r.decode_ms / N:.4f} ms per step), {r.tokens_per_s:.1f} "
          f"tokens/s; launches of the seven kernels {counts}")
    check(all(v == 0 for v in counts.values()),
          f"{name}: the AR path launched a kernel of the seven: {counts}")
    check(len(ptrs) == N and len(set(ptrs)) == 1,
          f"{name}: the cache moved or memory grew across decode steps: "
          f"{sorted(set(ptrs))[:4]}")
    print(f"[lm]   cache k/v pointers and torch.cuda.memory_allocated the "
          f"same before all {N} decode steps ({ptrs[0][2]:,} B)")
    # (2) the checked run: logits, keys and tokens of every step
    res2, _, steps, _ = _lm_run(gen, reqs, record=True)
    toks = torch.tensor(np.stack([x.tokens for x in res2], 1),
                        device=dev, dtype=torch.int64)        # (N, B)
    same = all(np.array_equal(a.tokens, b.tokens) for a, b in zip(res, res2))
    prompts = torch.tensor(np.stack([q.prompt for q in reqs]), device=dev)
    full = torch.cat([prompts.long(), toks.T], dim=1)         # (B, P + N)
    with torch.no_grad():
        fwd = dense.forward(gen.params, cfg, full)            # (B, P+N, V)
    scale = float(fwd.abs().max())
    tol = LM_FORWARD_TOL * scale
    err = max(float((lg - fwd[:, P - 1 + s]).abs().max())
              for s, (lg, *_) in enumerate(steps))
    check(err <= tol, f"{name}: cache logits vs forward {err:.3e} > "
          f"{tol:.3e}")
    # greedy rows against forward's argmax, near ties counted
    greedy_ties = greedy_bad = 0
    for s in range(N):
        want = fwd[:, P - 1 + s].argmax(-1)
        for i, (t, _) in enumerate(LM_ROWS):
            if t > 0 or int(toks[s, i]) == int(want[i]):
                continue
            if _near_tie(fwd[i, P - 1 + s], tol):
                greedy_ties += 1
            else:
                greedy_bad += 1
    check(greedy_bad == 0, f"{name}: {greedy_bad} greedy tokens differ "
          "from forward's argmax outside near ties")
    print(f"[lm]   cache path vs forward over prompt + generated: max "
          f"|dlogits| {err:.3e} = {err / scale:.3e} of max|logits| "
          f"{scale:.3e} (tol {LM_FORWARD_TOL:g}); greedy rows equal "
          f"forward's argmax at every step but {greedy_ties} near ties "
          f"(top-2 gap <= tol); timed and checked runs' tokens equal: "
          f"{same}")
    # (3) the decode step against the per-layer gqa_decode_step
    # composition, step by step until the first token that differs
    api = gen.api
    gen.api = dataclasses.replace(api, decode_step=_decode_per_layer)
    try:
        _, _, steps3, _ = _lm_run(gen, reqs, record=True)
    finally:
        gen.api = api
    d_max, n_cmp, bitwise = 0.0, 0, True
    for (l0, _, t0_, *_), (l1, _, t1_, *_) in zip(steps, steps3):
        d_max = max(d_max, float((l0 - l1).abs().max()))
        bitwise = bitwise and torch.equal(l0, l1)
        n_cmp += 1
        if not torch.equal(t0_, t1_):
            break
    check(d_max <= LM_VARIANT_TOL * scale,
          f"{name}: decode_step vs per-layer gqa_decode_step {d_max:.3e}")
    print(f"[lm]   decode_step vs per-layer gqa_decode_step over {n_cmp} "
          f"steps: "
          f"{'bitwise equal' if bitwise else f'max |dlogits| {d_max:.3e}'}"
          f" (tol {LM_VARIANT_TOL:g} of max|logits|)")
    # (4) threefry on the card against the CPU, and a CPU replay of the
    # sampler on the same logits
    V = cfg.vocab
    bits_eq = True
    g_ulps = 0.0
    ties = bad = 0
    for logits, subs, nxt, temps, top_ks, max_k in steps:
        sc = subs.cpu()
        bits_eq = bits_eq and torch.equal(
            prng.random_bits(subs, V).cpu(), prng.random_bits(sc, V))
        bits_eq = bits_eq and torch.equal(prng.split(subs, 2).cpu(),
                                          prng.split(sc, 2))
        g_dev, g_cpu = prng.gumbel(subs, V).cpu(), prng.gumbel(sc, V)
        sp = torch.finfo(torch.float32).eps * torch.clamp(g_cpu.abs(), min=1)
        g_ulps = max(g_ulps, float(((g_dev - g_cpu).abs() / sp).max()))
        lc = logits.cpu()
        want = ARGenerator._sample_tokens(lc, temps.cpu(), top_ks.cpu(), sc,
                                          max_k)
        for i in torch.nonzero(want != nxt.cpu()).flatten().tolist():
            sc_row = lc[i] / max(float(temps[i]), 1e-6)
            k = int(top_ks[i])
            if k > 0:
                kth = torch.topk(sc_row, k).values[-1]
                sc_row = torch.where(sc_row < kth, float("-inf"), sc_row)
            z = g_cpu[i] + sc_row
            zt = LM_GUMBEL_TIE * torch.finfo(torch.float32).eps * max(
                float(z[torch.isfinite(z)].abs().max()), 1.0)
            if _near_tie(z, zt):
                ties += 1
            else:
                bad += 1
    check(bits_eq, f"{name}: threefry bits or keys on the card differ "
          "from the CPU's")
    check(bad == 0, f"{name}: {bad} sampled tokens differ from the CPU "
          "replay outside Gumbel near ties")
    print(f"[lm]   threefry split and random_bits on the card bitwise the "
          f"CPU's for all {N} steps' keys; gumbel card vs CPU within "
          f"{g_ulps:.2f} f32 ulps of max(|g|, 1); CPU replay of "
          f"_sample_tokens on the copied logits: every token equal but "
          f"{ties} Gumbel near ties")
    # (5) one steady step: the model's decode alone, then the generate
    # loop's whole step (split, sample, copy to the host, decode)
    cache = dense.init_cache(cfg, B, M, device=dev)
    logits, _ = dense.prefill(gen.params, cfg, prompts, cache)
    tok = logits.argmax(-1)[:, None]
    idx0 = int(cache["idx"])

    def decode_only():
        cache["idx"].fill_(idx0)
        dense.decode_step(gen.params, cfg, tok, cache)

    temps = torch.tensor([t for t, _ in LM_ROWS], device=dev)
    top_ks = torch.tensor([k for _, k in LM_ROWS], device=dev)
    keys = torch.stack([prng.PRNGKey(i, dev) for i in range(B)])
    host = torch.empty(B, dtype=torch.int64, pin_memory=True)

    def gen_step():
        split = prng.split(keys, 2)
        nxt = ARGenerator._sample_tokens(logits, temps, top_ks, split[:, 1],
                                         max(k for _, k in LM_ROWS))
        host.copy_(nxt, non_blocking=True)
        cache["idx"].fill_(idx0)
        dense.decode_step(gen.params, cfg, nxt[:, None], cache)

    w_bytes = n_params * 4
    kv_bytes = 2 * cfg.n_layers * B * M * cfg.n_kv_heads * cfg.hd() * 4
    bound = (w_bytes + kv_bytes) / RL.HBM_BW * 1e3
    for label, fn in (("decode step (model)", decode_only),
                      ("generate step (split + sample + copy + decode)",
                       gen_step)):
        wall, busy, n_ops, top = _lm_device_profile(fn)
        print(f"[lm] {smi} | {name}: one steady {label}: wall {wall:.3f} ms "
              f"(median of 5), device kernels {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}, {n_ops} device ops launched; bytes "
              f"bound {bound:.3f} ms ({w_bytes / 1e9:.3f} GB of weights + "
              f"{kv_bytes / 1e9:.4f} GB of KV at M {M} over "
              f"{RL.HBM_BW / 1e12:.2f} TB/s)")
        for key, ms, count in top:
            print(f"[lm]     {ms:8.3f} ms {count:5d}x {key}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm] {smi} | {name}: peak torch.cuda.max_memory_allocated "
          f"{peak / 1e9:.3f} GB")
    del gen, params, cache, fwd, steps, steps3
    torch.cuda.empty_cache()
    return peak


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_lm_cli(smi):
    """Phase 10 (c): the LM CLI at full smollm-135m width on the card."""
    import contextlib
    import io
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-135m", "--batch", "4", "--new-tokens", "16",
            "--device", "cuda"]
    buf = io.StringIO()
    _zero_all_counts()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    torch.cuda.synchronize()
    counts = _all_counts()
    out = buf.getvalue().splitlines()
    for line in out:
        print(f"[cli]   {line}")
    reqs = [line for line in out if re.match(r"req\d: \[", line)]
    rate = [line for line in out if re.match(
        r"prefill=[\d.]+ms decode=[\d.]+ms throughput=[\d.]+ tok/s", line)]
    print(f"[cli] {smi} | python -m repro_torch.launch.serve "
          f"{' '.join(argv)}: {len(reqs)} request lines, launches {counts}")
    check(len(reqs) == 4 and len(rate) == 1
          and all(v == 0 for v in counts.values()),
          f"LM CLI: {len(reqs)} request lines, {rate}, launches {counts}")


# ---------------------------------- phase 11: JAX's draws and training
P11_PARITY_TOL = 1e-4      # of scale: a seeded card run vs the port on the CPU
P11_STEP_RTOL = 1e-4       # card vs CPU: the first train step's loss, gnorm
P11_ACCUM_RTOL = 1e-4      # LM accum_steps 2 vs 1: loss and grad norm
P11_DRAW_N = 1 << 20       # threefry draws per kind, card against CPU
P11_IMG_BATCH, P11_IMG_STEPS = 32, 30
P11_LM_BATCH, P11_LM_SEQ, P11_LM_STEPS = 8, 128, 6
P11_DLM_STEPS = 3
P11_SERVE_N, P11_SERVE_S = 16, 20


def _ulp_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in float32 ulps of max(|want|, 1)."""
    w = want.double()
    spacing = torch.maximum(w.abs(), torch.ones_like(w)) * F32_ULP
    return float(((got.double() - w).abs() / spacing).max())


def phase_draws_card(smi):
    """Phase 11a: threefry normal / randint / truncated_normal on the card
    against the same keys on the CPU (the CPU tests hold the CPU against
    jax.random bitwise)."""
    from repro_torch import prng
    gaps = {}
    for seed in (0, 7):
        kc, kh = prng.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
        for name, fn in (
                ("normal", lambda k: prng.normal(k, (P11_DRAW_N,))),
                ("truncated_normal(-3, 3)", lambda k: prng.truncated_normal(
                    k, -3.0, 3.0, (P11_DRAW_N,)))):
            got, want = fn(kc).cpu(), fn(kh)
            gaps[name] = max(gaps.get(name, 0.0), _ulp_gap(got, want))
            check(torch.isfinite(got).all().item(), f"{name}: non-finite")
            if name.startswith("truncated"):
                check(bool((got > -3).all() and (got < 3).all()),
                      "truncated_normal left (-3, 3)")
        for lo, hi in ((1, 1001), (0, 2 ** 31 - 1)):
            got = prng.randint(kc, (P11_DRAW_N,), lo, hi).cpu()
            want = prng.randint(kh, (P11_DRAW_N,), lo, hi)
            check(torch.equal(got, want), f"randint({lo}, {hi}) card != CPU")
    print(f"[draw] {smi} | threefry on the card vs the CPU, 2 keys x "
          f"{P11_DRAW_N} draws each: randint (1, 1001) and (0, 2^31-1) "
          f"bitwise; max ulp gap of max(|z|, 1): " + ", ".join(
              f"{k} {v:.2f}" for k, v in gaps.items()) + " (tol 0: bitwise)")
    check(all(v == 0.0 for v in gaps.values()),
          f"threefry floats card vs CPU: {gaps}")


def phase_draws_parity(smi):
    """Phase 11b: one int seed on the card against the port on the CPU at
    TOY_UNET width, S = 10, the same weights: a seeded eta=1 serve on
    tile_resident (B1), a stochastic 'rows' plan.run (B2) and one
    stochastic scheduler request (B2).  Returns (B1, B2) launches."""
    from repro_torch import prng
    from repro_torch.configs import TOY_UNET
    from repro_torch.core import make_schedule
    from repro_torch.models.unet import init_params, make_eps_fn
    from repro_torch.sampling import SamplerPlan
    from repro_torch.serving import DiffusionSampler, SampleRequest
    sch = make_schedule("linear", 1000)
    card = init_params(prng.PRNGKey(3), TOY_UNET, device="cuda").eval()
    host = copy.deepcopy(card).cpu()
    shape, plan = (16, 16, 3), SamplerPlan.build(sch, 10, sigma=1.0)
    out = {}
    _zero_counts()
    for dev, m in (("cuda", card), ("cpu", host)):
        eps = make_eps_fn(m)
        svc = DiffusionSampler(sch, eps, shape, batch_size=8,
                               tile_resident=True, device=dev)
        serve, _ = svc.serve(8, plan, seed=7)
        x_T = prng.normal(prng.PRNGKey(3, dev), (8,) + shape)
        rows = plan.run(eps, x_T, prng.PRNGKey(4, dev), backend="rows")
        eng = svc.continuous(slots=2, stochastic=True)
        res = eng.serve([SampleRequest(request_id=0, S=10, eta=1.0,
                                       seed=7)])
        out[dev] = (serve, rows, res[0].x0)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts, ticks = _counts(), eng.stats()["ticks"]
    for i, name in enumerate(("serve(8, eta=1, seed=7) tile_resident",
                              "rows plan.run eta=1", "scheduler request "
                              "eta=1 seed=7")):
        got, want = out["cuda"][i].cpu(), out["cpu"][i]
        rel = float((got - want).abs().max() / want.abs().max())
        print(f"[draw] {smi} | {name}, TOY_UNET S=10: card vs the port on "
              f"the CPU max|d|/max|x| {rel:.3e} (tol {P11_PARITY_TOL})")
        check(rel <= P11_PARITY_TOL, f"{name}: card vs CPU {rel}")
    want = {"B1": plan.S, "B2": plan.S + ticks, "B3": 0, "B4": 0}
    print(f"[draw] launches {counts} (want {want})")
    check(counts == want, f"seeded parity launches {counts}")
    return counts["B1"], counts["B2"]


def _unet_forward_flops(cfg, batch: int, size: int) -> int:
    """Conv, dense and attention-product FLOPs of one U-Net forward,
    counted from the layer shapes of a meta-device forward."""
    from repro_torch.models.unet import AttnBlock, UNet
    model = UNet(cfg, device="meta")
    total = [0]

    def conv(m, inp, out):
        total[0] += (2 * out.numel() * m.in_channels // m.groups
                     * m.kernel_size[0] * m.kernel_size[1])

    def dense_(m, inp, out):
        total[0] += 2 * out.numel() * m.in_features

    def attn(m, inp, out):
        n, c, h, w = inp[0].shape
        total[0] += 4 * n * (h * w) ** 2 * c          # q k^T and att v

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(dense_)
        elif isinstance(m, AttnBlock):
            m.register_forward_hook(attn)
    with torch.no_grad():
        model(torch.empty(batch, size, size, cfg.in_channels, device="meta"),
              torch.zeros(batch, dtype=torch.int32, device="meta"))
    return total[0]


def _lm_forward_flops(cfg, batch: int, seq: int) -> int:
    """Matmul FLOPs of one dense-LM forward: the projections, the full
    (B, H, S, S) attention products, SwiGLU and the vocabulary head."""
    T, d, D = batch * seq, cfg.d_model, cfg.hd()
    per_layer = (2 * T * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * D
                 + 2 * T * cfg.n_heads * D * d
                 + 4 * batch * seq * seq * cfg.n_heads * D
                 + 3 * 2 * T * d * cfg.d_ff)
    return cfg.n_layers * per_layer + 2 * T * d * cfg.vocab


def _timed_steps(step, state, batches, n):
    """n train steps; (state, metrics of each, wall s of each)."""
    metrics, walls = [], []
    for _ in range(n):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
    return state, metrics, walls


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def phase_train_unet(smi):
    """Phase 11c: the CIFAR10 U-Net trained at full width, then its EMA
    served through B1 and scored with eval/metrics.  Returns B1
    launches of the serve."""
    from repro_torch import prng
    from repro_torch.configs import CIFAR10_UNET
    from repro_torch.core import make_schedule, training_loss
    from repro_torch.data import SyntheticImages
    from repro_torch.eval.metrics import fid_proxy, mmd_rbf
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.sampling import SamplerPlan
    from repro_torch.serving import DiffusionSampler
    from repro_torch.training import (AdamWConfig, ema_init, ema_update,
                                      init_train_state,
                                      make_diffusion_train_step, module_loss,
                                      warmup_cosine)
    sch = make_schedule("linear", 1000)
    model = _cifar10_model(seed=2)
    opt = AdamWConfig(lr=2e-4, schedule=warmup_cosine(10, P11_IMG_STEPS))

    def stepper(m):
        return make_diffusion_train_step(module_loss(m, lambda eps, b, r: (
            training_loss(sch, eps, b, r), {})), opt)

    def params_of(m):
        return {k: v.detach() for k, v in m.named_parameters()}

    # the first step at batch 2, card against CPU: same weights, batch, key
    host = copy.deepcopy(model).cpu()
    b2 = SyntheticImages(size=32).sample(prng.PRNGKey(5, "cpu"), 2)
    first = {}
    for dev, m in (("cuda", model), ("cpu", host)):
        st = init_train_state(params_of(m), prng.PRNGKey(9, dev), opt)
        _, mt = stepper(m)(st, b2.to(dev))
        first[dev] = (float(mt["loss"]), float(mt["grad_norm"]))
    rl, rg = (_rel(first["cuda"][i], first["cpu"][i]) for i in (0, 1))
    print(f"[train] {smi} | CIFAR10_UNET first step at batch 2, card vs CPU:"
          f" loss {first['cuda'][0]:.6f} / {first['cpu'][0]:.6f} (rel "
          f"{rl:.2e}), grad norm {first['cuda'][1]:.6f} / "
          f"{first['cpu'][1]:.6f} (rel {rg:.2e}); tol {P11_STEP_RTOL}")
    check(rl <= P11_STEP_RTOL and rg <= P11_STEP_RTOL,
          f"U-Net first step card vs CPU: loss {rl}, gnorm {rg}")
    del host

    # training at batch P11_IMG_BATCH, counted: no kernel of the seven
    params = params_of(model)
    step = stepper(model)
    state = init_train_state(params, prng.PRNGKey(1), opt)
    data = SyntheticImages(size=32, seed=0).batches(P11_IMG_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    next(data)
    torch.cuda.synchronize()
    data_ms = (time.perf_counter() - t0) * 1e3
    _zero_all_counts()
    torch.cuda.reset_peak_memory_stats()
    ema = ema_init(params)
    walls, losses, ema_ms = [], [], []
    for _ in range(P11_IMG_STEPS):
        state, ms, w = _timed_steps(step, state, data, 1)
        t0 = time.perf_counter()
        ema = ema_update(ema, state.params, decay=0.999)
        torch.cuda.synchronize()
        ema_ms.append((time.perf_counter() - t0) * 1e3)
        walls += w
        losses.append(float(ms[0]["loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _all_counts()
    steady = statistics.median(walls[5:]) * 1e3
    flops = 3 * _unet_forward_flops(CIFAR10_UNET, P11_IMG_BATCH, 32)
    bound = flops / RL.PEAK_FLOPS_F32 * 1e3
    print(f"[train] {smi} | CIFAR10_UNET (35.7 M, float32) AdamW + "
          f"warmup_cosine + EMA 0.999 on SyntheticImages(32), batch "
          f"{P11_IMG_BATCH}, {P11_IMG_STEPS} steps: first step "
          f"{walls[0] * 1e3:.1f} ms, steady {steady:.1f} ms/step (median of "
          f"{len(walls) - 5}), {P11_IMG_BATCH / steady * 1e3:.1f} images/s; "
          f"EMA update {statistics.median(ema_ms):.2f} ms, one batch drawn "
          f"{data_ms:.2f} ms; loss first {losses[0]:.4f} last "
          f"{losses[-1]:.4f}; peak {peak_gb:.2f} GB; FLOP bound "
          f"{bound:.2f} ms (3 x {flops / 3 / 1e12:.3f} TFLOP forward at "
          f"the float32 SIMT rate), {bound / steady:.3f} of it; launches "
          f"{counts}")
    check(all(v == 0 for v in counts.values()),
          f"U-Net training launched {counts}")
    check(all(math.isfinite(x) for x in losses), "U-Net loss not finite")
    fixed = next(data)
    profile_call(smi, f"one CIFAR10_UNET train step, batch {P11_IMG_BATCH}",
                 lambda: step(state, fixed), "implicit_gemm")

    # the EMA served through B1, scored against a held-out batch
    held = SyntheticImages(size=32, seed=1).sample(prng.PRNGKey(424242),
                                                   P11_SERVE_N)
    plan = SamplerPlan.build(sch, P11_SERVE_S)
    b1 = 0
    for label, weights in (("init", params_of(model)),
                           ("trained", state.params), ("EMA", ema)):
        served = copy.deepcopy(model)
        served.load_state_dict({**served.state_dict(), **weights})
        svc = DiffusionSampler(sch, make_eps_fn(served.eval()),
                               CARD_SHAPE, batch_size=BATCH,
                               tile_resident=True)
        n1 = _counts()["B1"]
        x, st = svc.serve(P11_SERVE_N, plan, seed=0)
        torch.cuda.synchronize()
        n = _counts()["B1"] - n1
        b1 += n
        fid = fid_proxy(x, held)
        mmd = mmd_rbf(x.reshape(P11_SERVE_N, -1), held.reshape(
            P11_SERVE_N, -1))
        print(f"[train] {smi} | serve {label} weights: {P11_SERVE_N} "
              f"samples, S={plan.S}: {st['samples_per_s']:.1f} samples/s; "
              f"vs a held-out SyntheticImages batch of {P11_SERVE_N}: "
              f"fid_proxy {fid:.4f}, mmd_rbf {mmd:.5f}; B1 {n}")
        check(n == plan.S * 2 and bool(torch.isfinite(x).all()),
              f"EMA serve: B1 {n}, finite {bool(torch.isfinite(x).all())}")
    return b1


def phase_train_lm(smi):
    """Phase 11d: the dense LM (smollm-135m, full width) trained with
    accum_steps 1 and 2, then diffusion-LM steps on DLM_SMOLLM_MEGA."""
    from repro_torch import prng
    from repro_torch.configs import DLM_SMOLLM_MEGA, SMOLLM_135M
    from repro_torch.core import make_schedule
    from repro_torch.data import SyntheticTokens
    from repro_torch.diffusion_lm import model as dlm
    from repro_torch.models import dense
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_diffusion_train_step,
                                      make_lm_train_step)
    cfg = SMOLLM_135M
    params = dense.init_params(prng.PRNGKey(0), cfg)
    opt = AdamWConfig(lr=3e-4)
    data = SyntheticTokens(vocab=cfg.vocab).batches(P11_LM_BATCH, P11_LM_SEQ)
    tokens = next(data)
    state0 = init_train_state(params, prng.PRNGKey(1), opt)
    _zero_all_counts()
    torch.cuda.reset_peak_memory_stats()
    one = make_lm_train_step(cfg, opt, accum_steps=1)
    two = make_lm_train_step(cfg, opt, accum_steps=2)
    _, m1 = one(state0, {"tokens": tokens})
    _, m2 = two(state0, {"tokens": tokens})
    rl, rg = _rel(m2["loss"], m1["loss"]), _rel(m2["grad_norm"],
                                                 m1["grad_norm"])
    print(f"[train] {smi} | {cfg.name} step from one state, accum_steps 2 vs "
          f"1: loss {float(m2['loss']):.6f} / {float(m1['loss']):.6f} (rel "
          f"{rl:.2e}), grad norm {float(m2['grad_norm']):.6f} / "
          f"{float(m1['grad_norm']):.6f} (rel {rg:.2e}); tol "
          f"{P11_ACCUM_RTOL}")
    check(rl <= P11_ACCUM_RTOL and rg <= P11_ACCUM_RTOL,
          f"LM accum 2 vs 1: loss {rl}, gnorm {rg}")
    batches = ({"tokens": t} for t in data)
    state, ms, walls = _timed_steps(one, state0, batches, P11_LM_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _all_counts()
    steady = statistics.median(walls[1:]) * 1e3
    flops = 3 * _lm_forward_flops(cfg, P11_LM_BATCH, P11_LM_SEQ)
    bound = flops / RL.PEAK_FLOPS_F32 * 1e3
    losses = [float(m["loss"]) for m in ms]
    print(f"[train] {smi} | {cfg.name} (float32, AdamW) on SyntheticTokens("
          f"{cfg.vocab}), batch {P11_LM_BATCH} x {P11_LM_SEQ}: first step "
          f"{walls[0] * 1e3:.1f} ms, steady {steady:.1f} ms/step, "
          f"{P11_LM_BATCH * P11_LM_SEQ / steady * 1e3:.0f} tokens/s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak {peak_gb:.2f} GB; FLOP "
          f"bound {bound:.2f} ms (3 x {flops / 3 / 1e12:.3f} TFLOP forward "
          f"at the float32 SIMT rate), {bound / steady:.3f} of it; "
          f"launches {counts}")
    check(all(v == 0 for v in counts.values()), f"LM training: {counts}")
    fixed = {"tokens": tokens}
    profile_call(smi, f"one {cfg.name} train step, batch {P11_LM_BATCH} x "
                 f"{P11_LM_SEQ}", lambda: one(state, fixed), "gemm")
    del state, state0, params

    dcfg, sch = DLM_SMOLLM_MEGA, make_schedule("linear", 1000)
    dparams = _dlm_params(dcfg)
    dstep = make_diffusion_train_step(
        lambda p, b, r: dlm.training_loss(p, dcfg, sch, b, r), opt)
    toks = SyntheticTokens(vocab=dcfg.arch.vocab, seed=1).batches(
        DLM_BATCH, DLM_SEQ)
    _zero_all_counts()
    _, ms, walls = _timed_steps(dstep, init_train_state(
        dparams, prng.PRNGKey(2), opt), toks, P11_DLM_STEPS)
    counts = _all_counts()
    print(f"[train] {smi} | diffusion_lm.training_loss on {dcfg.arch.name}, "
          f"batch {DLM_BATCH} x {DLM_SEQ}, remat: losses "
          f"{[round(float(m['loss']), 4) for m in ms]}, l_eps "
          f"{float(ms[-1]['l_eps']):.4f}, l_round "
          f"{float(ms[-1]['l_round']):.4f}; ms/step "
          f"{[round(w * 1e3, 1) for w in walls]}; launches {counts}")
    check(all(v == 0 for v in counts.values())
          and all(math.isfinite(float(m["loss"])) for m in ms),
          f"diffusion-LM training: {counts}")


def phase_train_cli(smi):
    """Phase 11e: python -m repro_torch.launch.train --arch unet writes a
    checkpoint, python -m repro_torch.launch.serve --arch unet --ckpt
    serves it on the card.  Returns B1 launches of the serve."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import serve, train
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", "unet", "--steps", "20", "--log-every", "10",
                "--ckpt-dir", tmp]
        buf = io.StringIO()
        _zero_all_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_counts()
        out = buf.getvalue().splitlines()
        print(f"[cli] {smi} | python -m repro_torch.launch.train "
              f"{' '.join(argv[:-1])} <tmp>: {wall:.2f} s, launches "
              f"{counts}")
        for line in out:
            print(f"[cli]   {line}")
        check(out[-1].startswith("final checkpoint: ")
              and all(v == 0 for v in counts.values()),
              f"train CLI: {out[-1]!r}, launches {counts}")
        path = out[-1].split(": ", 1)[1]
        argv = ["--arch", "unet", "--ckpt", path, "--S", "10",
                "--n-samples", "8", "--batch", "8"]
        buf = io.StringIO()
        _zero_counts()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        torch.cuda.synchronize()
        counts = _counts()
        line = buf.getvalue().strip().splitlines()[-1]
        print(f"[cli] {smi} | python -m repro_torch.launch.serve --arch unet "
              f"--ckpt <that file> --S 10 --n-samples 8 --batch 8: {line}; "
              f"launches {counts}")
        check(line.startswith("sampled (8, 16, 16, 3)")
              and counts["B2"] == counts["B3"] == counts["B4"] == 0,
              f"serve --ckpt: {line!r}, launches {counts}")
    return counts["B1"]


# ----------------- phase 12: App. A, the shim, inits, the MoE and VLM
P12_EAGER_TOL = 1e-5       # of max|x|: B1 paths against the eager loop
P12_DLM_TOL = 1e-3         # of max|x0|: the MoE trunk on B1 vs eager
P12_WINDOW = 4096          # init elements compared per window, card vs CPU
P12_DS_LAYERS = 3          # deepseek-v2 cut: layer 0 dense + 2 MoE layers
P12_DLM_LAYERS = 2         # the diffusion-LM's deepseek-width MoE trunk
P12_LM_NEW, P12_VLM_NEW = 32, 16
P12_SMOKES = ("smollm-135m", "deepseek-v2-236b", "kimi-k2-1t-a32b",
              "llava-next-mistral-7b")


def phase_shim_and_adapters(smi, model):
    """Phase 12 (a), (b): the retired StepImpl shim and the eps adapters,
    each served through B1 on the card.  Returns B1's launches."""
    from repro_torch import prng
    from repro_torch.core import (SamplerConfig, cfg_eps_fn,
                                  eps_fn_from_v_fn, make_schedule, sample)
    from repro_torch.core.sampler import _jnp_step
    from repro_torch.kernels.ddim_step import fused_ddim_step
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.sampling import SamplerPlan
    from repro_torch.serving import DiffusionSampler
    import warnings
    dev = torch.device("cuda")
    sch = make_schedule("linear", 1000)
    gen = torch.Generator(device=dev).manual_seed(120)
    shape = (BATCH,) + CARD_SHAPE
    x, eps, noise = (torch.randn(shape, generator=gen, device=dev)
                     for _ in range(3))
    ab = sch.alpha_bar
    c = [float(v) for v in (ab[600].sqrt(), (1 - ab[600]).sqrt() * 0.8,
                            (1 - ab[600]).sqrt() * 0.4, ab[700].sqrt(),
                            (1 - ab[700]).sqrt())]
    b1 = 0
    # (a) the shim on the card against the eager Eq. 12 step plus noise
    _zero_all_counts()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = fused_ddim_step(x, eps, noise, *c)
        got_det = fused_ddim_step(x, eps, None, *c)
    torch.cuda.synchronize()
    counts = _all_counts()
    want = _jnp_step(x, eps, noise, *c)
    want_det = _jnp_step(x, eps, None, *c)
    scale = float(want.abs().max())
    err = max(float((got - want).abs().max()),
              float((got_det - want_det).abs().max()))
    warned = sum(issubclass(i.category, DeprecationWarning) for i in w)
    print(f"[p12] {smi} | (a) fused_ddim_step at {tuple(shape)}: 2 calls, "
          f"launches {counts}, {warned} DeprecationWarnings; vs the eager "
          f"Eq. 12 step + noise max|d| {err:.3e} = {err / scale:.3e} of "
          f"max|x| (tol {4 * F32_ULP:.3e})")
    check(counts == dict(_zero_dict(), B1=2) and warned == 2
          and err <= 4 * F32_ULP * scale, f"shim: {counts}, {warned}, {err}")
    b1 += counts["B1"]
    eps_fn = make_eps_fn(model)
    x_T = torch.randn(shape, generator=gen, device=dev)
    S = 10
    cfg = SamplerConfig(S=S, eta=1.0)
    _zero_all_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = sample(sch, eps_fn, x_T, cfg, prng.PRNGKey(12),
                     step_impl=fused_ddim_step)
    torch.cuda.synchronize()
    counts = _all_counts()
    want = sample(sch, eps_fn, x_T, cfg, prng.PRNGKey(12), backend="eager")
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    print(f"[p12] {smi} | (a) sample(step_impl=fused_ddim_step), CIFAR10 "
          f"U-Net, S={S}, eta 1, batch {BATCH}: launches {counts}; vs the "
          f"eager plan run of the same key max|d| {err:.3e} = "
          f"{err / scale:.3e} of scale (tol {P12_EAGER_TOL:g})")
    check(counts == dict(_zero_dict(), B1=S)
          and err <= P12_EAGER_TOL * scale, f"legacy sample: {counts} {err}")
    b1 += counts["B1"]
    # (b) CFG over two U-Net evaluations, and a v-prediction eps, served
    other = _cifar10_model(1)
    adapters = {
        "cfg (guidance 2)": cfg_eps_fn(eps_fn, make_eps_fn(other), 2.0),
        "v-prediction": eps_fn_from_v_fn(sch, eps_fn)}
    plan = SamplerPlan.build(sch, 20)
    for label, fn in adapters.items():
        svc = DiffusionSampler(sch, fn, CARD_SHAPE, batch_size=BATCH,
                               tile_resident=True, device=dev)
        ref = DiffusionSampler(sch, fn, CARD_SHAPE, batch_size=BATCH,
                               device=dev)
        _zero_all_counts()
        out, st = svc.serve(2 * BATCH, plan, seed=4)
        torch.cuda.synchronize()
        counts = _all_counts()
        want, _ = ref.serve(2 * BATCH, plan, seed=4)
        scale = max(float(want.abs().max()), 1.0)
        err = float((out - want).abs().max())
        print(f"[p12] {smi} | (b) {label} eps served (tile_resident, S 20,"
              f" {2 * BATCH} samples): {st['samples_per_s']:.1f} samples/s,"
              f" compiled_programs {st['compiled_programs']}, launches "
              f"{counts}; vs the eager service max|d| {err:.3e} = "
              f"{err / scale:.3e} of scale (tol {P12_EAGER_TOL:g})")
        check(counts == dict(_zero_dict(), B1=2 * 20)
              and st["compiled_programs"] == 1
              and bool(torch.isfinite(out).all())
              and err <= P12_EAGER_TOL * scale,
              f"{label} serve: {counts} {err}")
        b1 += counts["B1"]
    del other
    torch.cuda.empty_cache()
    return b1


def _zero_dict():
    return {k: 0 for k in ("B1", "B2", "B3", "B4", "B5", "B6", "B7")}


def _x0_model(K: int, device):
    """The App. A x0 model of the check: softmax of a fixed linear map of
    x_t and t (numpy weights), on ``device``."""
    import numpy as np
    W = torch.from_numpy(np.random.RandomState(0).randn(K, K).astype(
        np.float32)).to(device)

    def fn(x, t):
        return torch.softmax(x @ W + (t.float() / 1000.0)[:, None, None],
                             dim=-1)
    return fn


def phase_discrete(smi):
    """Phase 12 (c): discrete.reverse_sample (K 8, batch 64, S 10) on the
    card against the port on the CPU, replayed step by step from the
    card's states: every token equal but Gumbel near ties (counted)."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.core import discrete, make_schedule, make_tau
    sch = make_schedule("linear", 1000)
    K, B, N, S = 8, 64, 16, 10
    idx = np.random.RandomState(3).randint(0, K, (B, N))
    x_T = torch.from_numpy(np.eye(K, dtype=np.float32)[idx])
    states = []
    fn = _x0_model(K, "cuda")

    def rec(x, t):
        states.append((x.cpu(), t.cpu()))
        return fn(x, t)

    _zero_all_counts()
    t0 = time.perf_counter()
    got = discrete.reverse_sample(sch, rec, x_T.cuda(), prng.PRNGKey(5), S,
                                  eta=0.5)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = _all_counts()
    nexts = [s for s, _ in states[1:]] + [got.cpu()]
    fn_cpu = _x0_model(K, "cpu")
    tau = make_tau(1000, S, "linear")
    t_prev = np.concatenate([[0], tau[:-1]])[::-1]
    key = prng.PRNGKey(5, "cpu")
    ties = bad = 0
    for (x, t), tp, nxt in zip(states, t_prev, nexts):
        key, k1 = prng.split(key)
        tc = int(t[0])
        sig = 0.5 * discrete.sigma_implicit(sch, torch.tensor(tc),
                                            torch.tensor(int(tp)))
        p = discrete.posterior_probs(sch, x, fn_cpu(x, t), tc, int(tp), sig)
        z = prng.gumbel(k1, p.shape) + torch.log(p + 1e-20)
        for pos in torch.nonzero(z.argmax(-1) != nxt.argmax(-1)).tolist():
            zz = z[tuple(pos)]
            tol = LM_GUMBEL_TIE * F32_ULP * max(float(zz.abs().max()), 1.0)
            if _near_tie(zz, tol):
                ties += 1
            else:
                bad += 1
    print(f"[p12] {smi} | (c) discrete.reverse_sample K {K}, batch {B} x "
          f"{N} tokens, S {S}, eta 0.5: {wall:.1f} ms on the card; "
          f"launches {counts}; replayed on the CPU from the card's states: "
          f"{B * N * S} draws, {ties} Gumbel near ties, {bad} other "
          f"mismatches")
    check(bad == 0 and len(states) == S and all(v == 0 for v in
                                                 counts.values()),
          f"discrete: {bad} mismatches, {len(states)} steps, {counts}")


def _init_windows(store):
    """A spy on ``models.common._draw``: after each draw on the card it
    keeps the key, the draw's parameters and P12_WINDOW-element windows at
    the start, across the first chunk boundary, in the middle and at the
    end of the leaf."""
    from repro_torch.models import common
    orig = common._draw

    def spy(key, shape, dtype, scale, draw, chunk):
        out = orig(key, shape, dtype, scale, draw, chunk)
        flat = out.view(-1)
        n, m = flat.numel(), P12_WINDOW
        starts = sorted({0, max(min(chunk - m // 2, n - m), 0),
                         max(n // 2 - m // 2, 0), max(n - m, 0)})
        store.append((key.cpu(), n, dtype, scale, draw,
                      [(a, flat[a:a + m].cpu()) for a in starts]))
        return out
    return orig, spy


def _check_windows(store) -> int:
    """Redraw every stored window on the CPU; returns the elements
    compared.  Raises on the first window that differs."""
    n_cmp = 0
    for key, n, dtype, scale, draw, windows in store:
        for a, got in windows:
            m = got.numel()
            want = (draw(key, (m,), start=a) * scale).to(dtype)
            check(torch.equal(got, want), f"init window at {a} of a "
                  f"{n}-element leaf differs from the CPU's")
            n_cmp += m
    return n_cmp


def phase_inits_card(smi):
    """Phase 12 (d): JAX's inits on the card bitwise the CPU's, every leaf
    of one smoke config per family (U-Net, dense, moe MLA and GQA, vlm,
    the diffusion-LM's moe trunk)."""
    from repro_torch import configs, prng
    from repro_torch.diffusion_lm import DiffusionLMConfig
    from repro_torch.diffusion_lm import init_params as dlm_init
    from repro_torch.models import get_api
    from repro_torch.models.unet import init_params as unet_init
    n_leaves = n_elems = 0

    def same(a, b, what):
        nonlocal n_leaves, n_elems
        for (ka, va), (kb, vb) in zip(sorted(_named(a)), sorted(_named(b))):
            check(ka == kb and torch.equal(va.cpu(), vb),
                  f"{what}: leaf {ka} on the card differs from the CPU's")
            n_leaves += 1
            n_elems += vb.numel()

    t0 = time.perf_counter()
    card = unet_init(prng.PRNGKey(6), configs.TOY_UNET, device="cuda")
    host = unet_init(prng.PRNGKey(6, "cpu"), configs.TOY_UNET, device="cpu")
    same(card.state_dict(), host.state_dict(), "TOY_UNET")
    for arch in P12_SMOKES:
        cfg = configs.get_smoke(arch)
        init = get_api(cfg).init_params
        same(init(prng.PRNGKey(6), cfg, device="cuda"),
             init(prng.PRNGKey(6, "cpu"), cfg, device="cpu"), arch)
    dcfg = DiffusionLMConfig(arch=configs.get_smoke("deepseek-v2-236b"))
    same(dlm_init(prng.PRNGKey(6), dcfg, device="cuda"),
         dlm_init(prng.PRNGKey(6, "cpu"), dcfg, device="cpu"), "dlm moe")
    torch.cuda.synchronize()
    print(f"[p12] {smi} | (d) smoke inits (TOY_UNET, "
          f"{', '.join(P12_SMOKES)}, the moe diffusion-LM) on the card: "
          f"{n_leaves} leaves, {n_elems:,} elements bitwise the CPU's "
          f"({time.perf_counter() - t0:.2f} s)")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _moe_forward_as_served(params, cfg, tokens, P):
    """The cache-free reference of a served MoE model: the full causal
    attention over prompt + generated tokens, the MoE FFN routed as the
    server routes it (the prompt as one call, as prefill does; each
    generated position as one call over the batch, as a decode step
    does).  Returns logits (B, S, vocab)."""
    from repro_torch.models import moe
    h, positions = moe._embed(params, tokens, None)
    l0 = params["layer0"]
    h = moe._dense_mlp(l0, cfg, h + moe._attn_fwd(l0, cfg, h, positions))
    for i in range(cfg.n_layers - 1):
        layer = moe.layer_params(params["layers"], i)
        h = h + moe._attn_fwd(layer, cfg, h, positions)
        parts = [moe._moe_mlp(layer, cfg, h[:, :P])[0]]
        parts += [moe._moe_mlp(layer, cfg, h[:, s:s + 1])[0]
                  for s in range(P, h.shape[1])]
        h = torch.cat(parts, dim=1)
    return moe._logits(params, cfg, h)


def phase_lm_family(smi, cfg, batch, prompt_len, new, window_check=False,
                    tag="[p12]", profile_prefill=False):
    """Phase 12 (e) / (f) / (g) and phase 13: ARGenerator on a model of
    any family, float32 weights drawn on the card, the first ``batch`` of
    LM_ROWS' greedy and sampled rows; the seven counters 0; the cache
    path's logits against the cache-free model within LM_FORWARD_TOL of
    max|logits|; one steady decode step (and with ``profile_prefill`` one
    prefill) profiled; peak memory; for a moe model the latent cache's
    bytes against the dense GQA cache it replaces.  A vlm's stub
    embeddings are prepended (its cache grows by them), an audio model's
    frames go to the encoder.  With ``window_check`` every drawn leaf's
    init windows are redrawn on the CPU.  Returns the launch counts of
    the generate."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.models import common, get_api
    from repro_torch.models.vlm import stub_embeds
    from repro_torch.serving import ARGenerator
    dev = torch.device("cuda")
    name = cfg.name
    api = get_api(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    store = []
    orig, spy = _init_windows(store)
    if window_check:
        common._draw = spy
    t0 = time.perf_counter()
    try:
        params = api.init_params(prng.PRNGKey(0, dev), cfg, device=dev)
        torch.cuda.synchronize()
    finally:
        common._draw = orig
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{tag} {smi} | {name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, family {cfg.family}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k} + "
             f"{cfg.n_shared_experts} shared, d_ff_expert {cfg.d_ff_expert},"
             f" {'MLA kv_lora ' + str(cfg.kv_lora) if cfg.use_mla else 'GQA'}"
             if cfg.family == "moe" else "")
          + f": {n_params:,} parameters ({n_params * 4 / 1e9:.3f} GB "
          f"float32), JAX's init of PRNGKey(0) drawn on the card in "
          f"{init_s:.2f} s")
    if window_check:
        t1 = time.perf_counter()
        n_cmp = _check_windows(store)
        print(f"{tag}   init windows of all {len(store)} drawn leaves "
              f"({n_cmp:,} elements at each leaf's start, first chunk "
              f"boundary, middle and end) bitwise the CPU's "
              f"({time.perf_counter() - t1:.2f} s)")
    del store
    rows = LM_ROWS[:batch]
    B = len(rows)
    embeds = stub_embeds(cfg, B, dev)
    extra = embeds.shape[1] if cfg.family == "vlm" else 0
    P, N = prompt_len, new
    M = extra + P + N
    gen = ARGenerator(cfg, params, batch_size=B, max_len=M)
    reqs = _lm_requests(cfg, P, N, rows=rows)
    gen.generate(_lm_requests(cfg, P, 2, rows=rows), embeds=embeds)
    steps = []

    def spy_sample(logits, temps, top_ks, subs, max_k):
        nxt = ARGenerator._sample_tokens(logits, temps, top_ks, subs, max_k)
        steps.append((logits.clone(), nxt.clone()))
        return nxt

    _zero_all_counts()
    res = gen.generate(reqs, embeds=embeds)
    torch.cuda.synchronize()
    counts = _all_counts()
    r = res[0]
    print(f"{tag} {smi} | {name}: generate batch {B}, "
          + (f"{extra} stub image embeddings + " if extra else "")
          + (f"{embeds.shape[1]} stub frames to the encoder + "
             if embeds is not None and not extra else "")
          + f"prompt {P}, {N} new tokens: prefill {r.prefill_ms:.3f} ms, "
          f"decode {r.decode_ms:.3f} ms ({r.decode_ms / N:.4f} ms per step),"
          f" {r.tokens_per_s:.1f} tokens/s; launches of the seven kernels "
          f"{counts}")
    check(all(v == 0 for v in counts.values()),
          f"{name}: the AR path launched a kernel of the seven: {counts}")
    gen._sample_tokens = spy_sample
    try:
        res2 = gen.generate(reqs, embeds=embeds)
    finally:
        gen.__dict__.pop("_sample_tokens", None)
    toks = torch.tensor(np.stack([x.tokens for x in res2], 1), device=dev,
                        dtype=torch.int64)                      # (N, B)
    prompts = torch.tensor(np.stack([q.prompt for q in reqs]), device=dev)
    full = torch.cat([prompts.long(), toks.T], dim=1)           # (B, P + N)
    with torch.no_grad():
        if cfg.family == "moe":
            fwd = _moe_forward_as_served(params, cfg, full, P)
        else:
            fwd = api.forward(params, cfg, full, embeds=embeds)[0][:, extra:]
    scale = float(fwd.abs().max())
    tol = LM_FORWARD_TOL * scale
    err = max(float((lg - fwd[:, P - 1 + s]).abs().max())
              for s, (lg, _) in enumerate(steps))
    ties = bad = 0
    for s in range(N):
        want = fwd[:, P - 1 + s].argmax(-1)
        for i, (t, _) in enumerate(rows):
            if t > 0 or int(toks[s, i]) == int(want[i]):
                continue
            if _near_tie(fwd[i, P - 1 + s], tol):
                ties += 1
            else:
                bad += 1
    print(f"{tag}   cache path vs the cache-free model over prompt + "
          f"generated: max |dlogits| {err:.3e} = {err / scale:.3e} of "
          f"max|logits| {scale:.3e} (tol {LM_FORWARD_TOL:g}); greedy rows "
          f"equal its argmax at every step but {ties} near ties")
    check(err <= tol and bad == 0, f"{name}: cache vs forward {err:.3e} > "
          f"{tol:.3e} or {bad} greedy tokens off")
    del fwd, steps
    kw = {} if embeds is None else {"embeds": embeds}
    if profile_prefill:
        def prefill_only():
            api.prefill(params, cfg, prompts,
                        api.init_cache(cfg, B, M, device=dev), **kw)

        wall, busy, n_ops, top = _lm_device_profile(prefill_only)
        print(f"{tag} {smi} | {name}: one prefill ({B} x {P} tokens): wall "
              f"{wall:.3f} ms (median of 5), device kernels {busy:.3f} ms, "
              f"idle share {1 - busy / wall:.3f}, {n_ops} device ops "
              f"launched")
        for key, ms, count in top:
            print(f"{tag}     {ms:8.3f} ms {count:5d}x {key}")
    cache = api.init_cache(cfg, B, M, device=dev)
    logits, _ = api.prefill(params, cfg, prompts, cache, **kw)
    tok = logits.argmax(-1)[:, None]
    idx0 = int(cache["idx"])

    def decode_only():
        cache["idx"].fill_(idx0)
        api.decode_step(params, cfg, tok, cache)

    wall, busy, n_ops, top = _lm_device_profile(decode_only)
    cache_b = sum(v.numel() * v.element_size() for k, v in cache.items()
                  if k != "idx")
    print(f"{tag} {smi} | {name}: one steady decode step: wall {wall:.3f} ms"
          f" (median of 5), device kernels {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {n_ops} device ops launched")
    for key, ms, count in top:
        print(f"{tag}     {ms:8.3f} ms {count:5d}x {key}")
    if cfg.use_mla:
        per_tok = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim
                                 + cfg.v_head_dim)
        gqa_b = cfg.n_layers * B * M * per_tok * 4
        print(f"{tag}   MLA cache {cache_b:,} B ({cfg.kv_lora} + "
              f"{cfg.qk_rope_dim} values per token and layer) against the "
              f"{gqa_b:,} B of the dense cache it replaces (k of "
              f"{cfg.qk_nope_dim + cfg.qk_rope_dim} and v of "
              f"{cfg.v_head_dim} per head, {cfg.n_heads} heads): "
              f"{cache_b / gqa_b:.4f}")
    else:
        print(f"{tag}   cache {cache_b:,} B at M {M}")
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} {smi} | {name}: peak torch.cuda.max_memory_allocated "
          f"{peak / 1e9:.3f} GB")
    del gen, params, cache, logits
    torch.cuda.empty_cache()
    return counts


def phase_dlm_moe(smi):
    """Phase 12 (h): the diffusion-LM on the deepseek-width MoE trunk
    (P12_DLM_LAYERS layers, MLA).  Returns B1's launches."""
    import dataclasses as dc
    from repro_torch.configs import DEEPSEEK_V2_236B
    return phase_dlm_trunk(smi, dc.replace(
        DEEPSEEK_V2_236B, name=f"deepseek-v2-236b-{P12_DLM_LAYERS}l",
        n_layers=P12_DLM_LAYERS), "[p12]", "(h) ")


def phase_dlm_trunk(smi, arch, tag, label=""):
    """A diffusion-LM on a trunk that carries no mega_spec (moe, ssm,
    hybrid), batch 4 x 64, eta 0, S=20: generate(tile_resident=True) takes
    the tile-resident loop, B1 once per step, and plan.run 'mega' on one
    x_T against the eager backend on the card within P12_DLM_TOL of
    scale.  Returns B1's launches."""
    from repro_torch import prng
    from repro_torch.core import SamplerConfig, make_schedule
    from repro_torch.diffusion_lm import (DiffusionLMConfig, generate,
                                          init_params, make_eps_fn,
                                          make_tile_eps_fn)
    from repro_torch.sampling import SamplerPlan, backends
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = DiffusionLMConfig(arch=arch)
    t0 = time.perf_counter()
    params = init_params(prng.PRNGKey(0), cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"{tag} {smi} | {label}diffusion-LM {cfg.arch.name} trunk "
          f"({cfg.arch.family}): {n:,} parameters ({n * 4 / 1e9:.3f} GB "
          f"float32) in {time.perf_counter() - t0:.2f} s")
    sch = make_schedule("linear", 1000)
    B, L, S = 4, 64, 20
    _zero_all_counts()
    t0 = time.perf_counter()
    toks = generate(params, cfg, sch, prng.PRNGKey(7), B, L,
                    sampler=SamplerConfig(S=S), tile_resident=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    why = backends.run_mega.last_reason
    x_T = prng.normal(prng.PRNGKey(8), (B, L, cfg.latent_dim))
    plan = SamplerPlan.build(sch, S)
    _zero_all_counts()
    got = plan.run(make_tile_eps_fn(params, cfg, B, L), x_T, backend="mega")
    torch.cuda.synchronize()
    counts2 = _all_counts()
    want = plan.run(make_eps_fn(params, cfg), x_T, backend="eager")
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    print(f"{tag} {smi} | {label}generate(tile_resident=True) batch {B} x "
          f"{L} tokens, eta 0, S={S}: {wall:.3f} s, {B * L / wall:.1f} "
          f"tokens/s, launches {counts}, run_mega.last_reason {why!r}; "
          f"plan.run 'mega' launches {counts2}, vs 'eager' on the card "
          f"max|d| {err:.3e} = {err / scale:.3e} of scale (tol "
          f"{P12_DLM_TOL:g}); tokens in [0, {cfg.arch.vocab}): "
          f"{int(toks.min()) >= 0 and int(toks.max()) < cfg.arch.vocab}; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    check(counts == dict(_zero_dict(), B1=S)
          and counts2 == dict(_zero_dict(), B1=S) and "mega_spec" in why
          and err <= P12_DLM_TOL * scale,
          f"dlm {cfg.arch.name}: {counts} {counts2} {why} {err}")
    del params
    torch.cuda.empty_cache()
    return counts["B1"] + counts2["B1"]


def phase_p12_cli(smi):
    """Phase 12 (j): the serve and train CLIs on the card for the moe and
    vlm smoke configs."""
    import contextlib
    import io
    from repro_torch.launch import serve, train
    for arch in ("deepseek-v2-236b", "llava-next-mistral-7b"):
        for mod, argv in (
                (serve, ["--arch", arch, "--smoke", "--batch", "2",
                         "--new-tokens", "8", "--device", "cuda"]),
                (train, ["--arch", arch, "--smoke", "--steps", "3",
                         "--batch", "2", "--seq", "32", "--device",
                         "cuda"])):
            buf = io.StringIO()
            _zero_all_counts()
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
            torch.cuda.synchronize()
            counts = _all_counts()
            out = buf.getvalue().splitlines()
            for line in out[-3:]:
                print(f"[cli]   {line}")
            ok = (len([ln for ln in out if re.match(r"req\d: \[", ln)]) == 2
                  if mod is serve else out[-1].startswith('{"first_loss"'))
            print(f"[cli] {smi} | python -m {mod.__name__} "
                  f"{' '.join(argv)}: launches {counts}")
            check(ok and all(v == 0 for v in counts.values()),
                  f"{mod.__name__} {arch}: {out[-2:]} {counts}")


def phase_12(smi, model):
    """Phase 12, run last so that every earlier rate is timed as before.
    Returns B1's launches on its paths."""
    import dataclasses as dc
    from repro_torch import configs
    b1 = phase_shim_and_adapters(smi, model)
    phase_discrete(smi)
    phase_inits_card(smi)
    # (e) - (g): the AR paths launch none of the seven kernels
    ds = dc.replace(configs.DEEPSEEK_V2_236B,
                    name=f"deepseek-v2-236b-{P12_DS_LAYERS}l",
                    n_layers=P12_DS_LAYERS)
    phase_lm_family(smi, ds, 4, 128, P12_LM_NEW, window_check=True)
    phase_lm_family(smi, configs.LLAVA_NEXT_MISTRAL_7B, 2, 32, P12_VLM_NEW)
    phase_lm_family(smi, configs.KIMI_K2_1T_A32B_SMOKE, 4, 32, P12_LM_NEW)
    b1 += phase_dlm_moe(smi)
    phase_p12_cli(smi)
    return b1


P13_NEW = 32
P13_FRAMES_PROMPT = 32         # seamless: 1,024 stub frames + a 32-token prompt
P13_DLM_LAYERS = {"rwkv6-7b": 2, "zamba2-2.7b": 4}


def phase_p13_cli(smi):
    """Phase 13 (f): the serve CLI for the three new smoke ids."""
    import contextlib
    import io
    from repro_torch.launch import serve
    for arch in ("zamba2-2.7b", "rwkv6-7b", "seamless-m4t-large-v2"):
        argv = ["--arch", arch, "--smoke", "--batch", "2", "--new-tokens",
                "8", "--device", "cuda"]
        buf = io.StringIO()
        _zero_all_counts()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        torch.cuda.synchronize()
        counts = _all_counts()
        out = buf.getvalue().splitlines()
        for line in out[-3:]:
            print(f"[cli]   {line}")
        print(f"[cli] {smi} | python -m repro_torch.launch.serve "
              f"{' '.join(argv)}: launches {counts}")
        ok = len([ln for ln in out if re.match(r"req\d: \[", ln)]) == 2
        check(ok and all(v == 0 for v in counts.values()),
              f"serve {arch}: {out[-2:]} {counts}")


def phase_13(smi):
    """Phase 13, run last so that every earlier rate is timed as before:
    (a) rwkv6-7b, (b) seamless-m4t-large-v2 and (c) zamba2-2.7b at full
    width and depth in float32 through ARGenerator (the seven counters 0,
    the cache path against the cache-free model within LM_FORWARD_TOL for
    each family: the hybrid's cached decode runs Mamba2's single-token
    recurrence where the cache-free forward runs the chunked SSD, and
    still holds it); (d) / (e) the
    diffusion-LM on 2-layer rwkv6-width and 4-layer zamba2-width trunks
    (B1 once per step); (f) the serve CLI.  Returns B1's launches."""
    import dataclasses as dc
    from repro_torch import configs
    for cfg, prompt, label in (
            (configs.RWKV6_7B, 128, "(a)"),
            (configs.SEAMLESS_M4T_LARGE_V2, P13_FRAMES_PROMPT, "(b)"),
            (configs.ZAMBA2_2_7B, 128, "(c)")):
        print(f"[p13] {label} {cfg.name}")
        phase_lm_family(smi, cfg, 4, prompt, P13_NEW,
                        window_check=cfg.family == "ssm", tag="[p13]",
                        profile_prefill=True)
    b1 = 0
    for arch, label in (("rwkv6-7b", "(d) "), ("zamba2-2.7b", "(e) ")):
        n = P13_DLM_LAYERS[arch]
        b1 += phase_dlm_trunk(smi, dc.replace(
            configs.get(arch), name=f"{arch}-{n}l", n_layers=n), "[p13]",
            label)
    phase_p13_cli(smi)
    return b1


# ----------------------------------------------- phase 14: the examples
# Train steps of each example run (JAX's defaults are the examples' own,
# parse_args([]).steps): cut where phase 14 would otherwise add well over
# two minutes (every cut is printed).  At JAX's defaults (lm_diffusion at
# 100) the examples took 221 s on an H100 at 700 W: the GMM MLP's steps
# are host-bound at 25-44 ms (threefry draws), TOY_UNET's at 53-93 ms,
# lm_diffusion's ssm trunk at 134-188 ms; with about twice these steps
# the whole script ran 634.5 s, over half its time limit.
P14_STEPS = {"quickstart": 600, "quickstart-images": 100,
             "interpolation": 300, "reconstruction": 300,
             "discrete_ddim": 300, "lm_diffusion": 30}
P14_LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")
P14_ROOFLINE = (("smollm-135m", 64), ("llama3.2-3b", 128))   # phase 10's
NONFINITE = re.compile(r"\b(nan|inf)\b", re.IGNORECASE)


def _p14_example(smi, name, argv, label=None):
    """One example's ``main(argv)`` on the card with its stdout captured and
    echoed, the seven counters zeroed just before it and read just after.
    Checks every printed number is finite.  Returns (result, wall s,
    counts)."""
    import contextlib
    import importlib
    import io
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    _zero_all_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    out = buf.getvalue()
    train = (f", train {res['train_step_s'] * 1e3:.2f} ms a step"
             if "train_step_s" in res else "")
    print(f"[p14] {smi} | python -m repro_torch.examples.{name} "
          f"{' '.join(argv)}: wall {wall:.2f} s{train}, launches {counts}")
    for line in out.splitlines():
        if line.strip():
            print(f"[p14]   {line}")
    check(NONFINITE.search(out) is None,
          f"{label or name}: a printed metric is not finite")
    return res, wall, counts


def _p14_cut(name, preset_argv=()):
    """The train steps phase 14 gives example ``name`` (its own default,
    which is JAX's, unless P14_STEPS cuts it: then a line says so)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    default = mod.parse_args(list(preset_argv)).steps
    key = name if not preset_argv else f"{name}-{preset_argv[-1]}"
    steps = P14_STEPS[key]
    if steps != default:
        print(f"[p14] cut: {key} trains {steps} steps (JAX's default "
              f"{default}) so that phase 14 stays near two minutes")
    return steps


def phase_examples(smi):
    """Phase 14 (a): the six examples of repro_torch.examples on the card
    at their own widths and sample sizes.  Returns (B1, B2) launches."""
    walls = {}
    zero = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0, "B6": 0, "B7": 0}
    # quickstart, both presets
    st = _p14_cut("quickstart")
    res, walls["quickstart"], c = _p14_example(
        smi, "quickstart", ["--steps", str(st)])
    S = res["backend_S"]
    check(all(d < 1e-4 for d in res["backend_delta"].values()),
          f"quickstart backends: {res['backend_delta']}")
    check(c == dict(zero, B1=S, B2=S),
          f"quickstart launched {c}, want B1 == B2 == S {S}")
    b1, b2 = c["B1"], c["B2"]
    st = _p14_cut("quickstart", ("--preset", "images"))
    res, walls["quickstart-images"], c = _p14_example(
        smi, "quickstart", ["--preset", "images", "--steps", str(st)],
        "quickstart --preset images")
    check(c == zero, f"quickstart images launched {c} (eager sampling)")
    # interpolation: the slerp path decoded on tile_resident
    st = _p14_cut("interpolation")
    res, walls["interpolation"], c = _p14_example(
        smi, "interpolation", ["--steps", str(st)])
    check(c == dict(zero, B1=res["decode_S"]),
          f"interpolation launched {c}, want B1 == S {res['decode_S']}")
    check(res["ddim_spread"] == 0.0 and res["ddpm_spread"] > 0.0,
          f"interpolation spreads DDIM {res['ddim_spread']} DDPM "
          f"{res['ddpm_spread']}")
    b1 += c["B1"]
    # reconstruction (Table 2)
    st = _p14_cut("reconstruction")
    res, walls["reconstruction"], c = _p14_example(
        smi, "reconstruction", ["--steps", str(st)])
    errs = [r[1] for r in res["rows"]]
    check(c == zero, f"reconstruction launched {c} (eager decode)")
    check(all(b <= a for a, b in zip(errs, errs[1:])),
          f"reconstruction error does not fall with S: {res['rows']}")
    # discrete DDIM (App. A)
    st = _p14_cut("discrete_ddim")
    res, walls["discrete_ddim"], c = _p14_example(
        smi, "discrete_ddim", ["--steps", str(st)])
    check(c == zero, f"discrete_ddim launched {c}")
    check(len(res["rows"]) == 9, f"discrete_ddim rows {res['rows']}")
    # lm_diffusion, JAX's four families
    st = _p14_cut("lm_diffusion")
    for fam in P14_LM_FAMILIES:
        res, walls[f"lm_diffusion {fam}"], c = _p14_example(
            smi, "lm_diffusion", ["--family", fam, "--steps", str(st)],
            f"lm_diffusion {fam}")
        check(c == zero and len(res["rows"]) == 4,
              f"lm_diffusion {fam} launched {c}, rows {res['rows']}")
    # gateway_sse, in process (the transport needs aiohttp)
    try:
        import aiohttp  # noqa: F401
        have = True
    except ImportError:
        have = False
    if have:
        res, walls["gateway_sse"], c = _p14_example(
            smi, "gateway_sse", ["--smoke"])
        fleet = res["stats"]["fleet"]
        pools = len(fleet["pools"])
        print(f"[p14] aiohttp importable: gateway_sse streamed in process; "
              f"pool ticks {[p['ticks'] for p in fleet['pools']]} after one "
              f"warm-up tick per pool ({pools} pools)")
        check(res["ok"] and all(t["previews"] > 0 and t["result"] is not None
                                for t in res["streams"].values()),
              f"gateway_sse streams {res['streams']}")
        check(c == dict(zero, B2=fleet["ticks"] + pools),
              f"gateway_sse launched {c}, want B2 == pool ticks "
              f"{fleet['ticks']} + {pools} warm-up ticks")
        b2 += c["B2"]
    else:
        print("[p14] aiohttp is not importable here: gateway_sse not run "
              "(the HTTP transport is not a device path; the CPU tests "
              "hold it)")
    print(f"[p14] {smi} | examples' walls (s): "
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
          + f"; total {sum(walls.values()):.1f} s; B1 {b1}, B2 {b2}")
    return b1, b2


def phase_roofline(smi):
    """Phase 14 (b): the roofline terms of phase 10's decode steps, counted
    on meta tensors (launch.roofline.count), against the measured device
    time of the same step on the card, with the analytic traffic (weights,
    the cache read once, one slot a layer written), the useful share
    (2 N D over the counted flops) and the step's peak device memory."""
    from repro_torch import configs, prng
    from repro_torch.launch import shapes
    from repro_torch.models import dense
    dev = torch.device("cuda")
    B = len(LM_ROWS)
    for arch, P in P14_ROOFLINE:
        cfg = configs.get(arch)
        M = P + LM_NEW
        specs = shapes.param_specs(cfg)
        meta_tok = torch.empty((B, 1), dtype=torch.int64, device="meta")
        meta_cache = dense.init_cache(cfg, B, M, device="meta")
        counts = RL.count(dense.decode_step, specs, cfg, meta_tok,
                          meta_cache)
        n_params = sum(t.numel() for t in _leaves(specs))
        analytic = (shapes.nbytes(specs) + shapes.nbytes(
            {k: meta_cache[k] for k in ("k", "v")})
            + 2 * cfg.n_layers * B * cfg.n_kv_heads * cfg.hd() * 4)
        torch.cuda.reset_peak_memory_stats(dev)
        params = dense.init_params(prng.PRNGKey(0, dev), cfg, device=dev)
        cache = dense.init_cache(cfg, B, M, device=dev)
        terms = RL.analyze(counts, model_flops=RL.lm_model_flops(
            n_params, B, "decode"), dtype=params["embed"].dtype)
        prompts = torch.randint(0, cfg.vocab, (B, P), device=dev)
        with torch.no_grad():
            logits, _ = dense.prefill(params, cfg, prompts, cache)
            tok = logits.argmax(-1)[:, None]
            idx0 = int(cache["idx"])

            def decode_only():
                cache["idx"].fill_(idx0)
                dense.decode_step(params, cfg, tok, cache)

            wall, busy, n_ops, _ = _lm_device_profile(decode_only)
        mem = RL.memory_report(dev)
        bound_ms = max(terms.compute_s, terms.memory_s) * 1e3
        print(f"[roofline] {smi} | {arch} decode step (batch {B}, cache M "
              f"{M}), counted on meta: {counts['flops']:,} flops, "
              f"{counts['traffic_bytes']:,} bytes ({counts['traffic_bytes'] / analytic:.4f}"
              f" x the analytic {analytic:,}: weights, cache read once, one"
              f" slot a layer written), {counts['ops']} aten ops; useful "
              f"2 N D / flops {terms.useful_ratio:.4f}; terms compute "
              f"{terms.compute_s * 1e3:.4f} ms ({params['embed'].dtype}, "
              f"{RL.peak_flops(params['embed'].dtype) / 1e12:.0f} TFLOP/s)"
              f", memory {terms.memory_s * 1e3:.4f} ms ({RL.HBM_BW / 1e12:.2f}"
              f" TB/s), bottleneck {terms.bottleneck}; measured device "
              f"kernels {busy:.3f} ms ({n_ops} device ops), wall "
              f"{wall:.3f} ms: max(terms) / device {bound_ms / busy:.3f}, "
              f"/ wall {bound_ms / wall:.3f}; peak allocated "
              f"{mem['peak_allocated_bytes'] / 1e9:.3f} GB")
        check(counts["flops"] > 0 and busy > 0
              and counts["traffic_bytes"] >= analytic,
              f"{arch}: roofline counts {counts} (analytic bytes "
              f"{analytic}), device ms {busy}")
        del params, cache
        torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_shapes(smi):
    """Phase 14 (c): every --arch x shape id's float32 state (meta tensors,
    no allocation) against the card's memory.  Serving combos: params plus
    the cache.  Train combos: params, their gradients and AdamW's two
    moments (the port's train step); the activations of batch x seq are
    not counted, so "fits" there says that the state fits, not the step."""
    from repro_torch import configs
    from repro_torch.launch import shapes
    from repro_torch.training.optim import adamw_init
    total = torch.cuda.get_device_properties(0).total_memory
    for arch in configs.ARCH_IDS:
        specs = shapes.param_specs(configs.get(arch))
        p_bytes = shapes.nbytes(specs)
        opt = adamw_init(specs)
        o_bytes = shapes.nbytes(opt.mu) + shapes.nbytes(opt.nu)
        for sid in shapes.SHAPE_IDS:
            combo = shapes.resolve(configs.get(arch), sid)
            win = f", window {shapes.WINDOW}" if combo.windowed else ""
            head = (f"[shapes] {smi} | {arch} x {sid} ({combo.kind}, batch "
                    f"{combo.batch}, seq {combo.seq_len}{win}): float32 "
                    f"params {p_bytes / 1e9:.3f} GB")
            if combo.kind == "train":
                need = 2 * p_bytes + o_bytes
                print(f"{head} + grads {p_bytes / 1e9:.3f} GB + AdamW "
                      f"moments {o_bytes / 1e9:.3f} GB = {need / 1e9:.3f} "
                      f"GB against {total / 1e9:.1f} GB, activations not "
                      f"counted: the state "
                      f"{'fits' if need <= total else 'does not fit'} one "
                      f"card")
                continue
            c_bytes = shapes.nbytes(shapes.cache_specs(combo, torch.float32))
            need = p_bytes + c_bytes
            print(f"{head} + cache {c_bytes / 1e9:.3f} GB = "
                  f"{need / 1e9:.3f} GB against {total / 1e9:.1f} GB: "
                  f"{'fits' if need <= total else 'does not fit'} one card")


def phase_14(smi):
    """Phase 14, run last so that every earlier rate is timed as before:
    the six examples, the decode steps' roofline terms, the shape table.
    Returns (B1, B2) launches of the examples."""
    b1, b2 = phase_examples(smi)
    phase_roofline(smi)
    phase_shapes(smi)
    return b1, b2


P15_DIM, P15_HIDDEN = 512, 1024      # the fleet bench's demo trunk
P15_SLOTS = 4                        # its slots per pool
P15_S = (5, 10, 20)                  # its S menu
P15_N = 12                           # requests per fleet path
P15_UNET_SLOTS = 4
P15_UNET_S = 10
P15_RTOL = P15_ATOL = 1e-5           # model > 1 against the unsharded engine


def _p15_requests(n, base=0, S_menu=P15_S):
    from repro_torch.serving import SampleRequest
    return [SampleRequest(request_id=base + i, S=S_menu[i % len(S_menu)],
                          eta=0.0, seed=base + i, affinity_key=i % 5)
            for i in range(n)]


def _p15_tick_ms(serve, eng_or_fleet, n, base):
    """Mean steady tick wall (ms) of one more serve of ``n`` requests,
    after the path's first (built) serve; the stats' tick wall over its
    ticks (summed over a fleet's pools)."""
    eng_or_fleet.reset_stats()
    serve(_p15_requests(n, base))
    torch.cuda.synchronize()
    st = eng_or_fleet.stats()
    pools = st.get("pools", [st])
    return (1e3 * sum(p["tick_wall_s"] for p in pools)
            / max(sum(p["ticks"] for p in pools), 1))


def phase_15(smi, model):
    """Phase 15: mesh-sharded slot pools.  (a) the fleet bench's demo
    trunk (state_dim 512, hidden 1024, 4 slots) as a pool on the (1, 1)
    mesh of the real card, x0 bitwise the unsharded engine's; (b) the same
    fleet of 2 pools on simulated (1, 2) and (2, 2) pool meshes over
    [cuda:0] * k (make_fleet_mesh(devices=)), within rtol / atol 1e-5,
    with JAX's stats; (c) the CIFAR10 U-Net in one engine on a simulated
    (2, 1) mesh through sharded_eps_from_apply.  B2 is zeroed before each
    path and read after: ticks x data shards.  Returns B2 launches."""
    from torch.func import functional_call
    from repro_torch.core.schedules import make_schedule
    from repro_torch.launch.mesh import make_fleet_mesh, make_host_mesh
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.serving import (ContinuousBatchingEngine, PoolFleet,
                                     SampleRequest)
    from repro_torch.serving.fleet import (make_sharded_eps,
                                           make_trunk_params,
                                           make_unsharded_eps,
                                           sharded_eps_from_apply)
    sch = make_schedule("linear", 1000)
    params = make_trunk_params(sch, P15_DIM, P15_HIDDEN, seed=0)
    card = torch.device("cuda", 0)
    n_b2 = 0

    def shards(engine):
        return len(engine._blocks)

    # the unsharded reference: one engine, the same requests
    ref = ContinuousBatchingEngine(sch, make_unsharded_eps(params),
                                   (P15_DIM,), P15_SLOTS)
    want = {r.request_id: r.x0 for r in ref.serve(_p15_requests(P15_N))}
    ref_ms = _p15_tick_ms(ref.serve, ref, P15_N, 1000)
    print(f"[p15] {smi} | unsharded engine, demo trunk {P15_DIM} x "
          f"{P15_HIDDEN}, {P15_SLOTS} slots, S {P15_S}: steady tick "
          f"{ref_ms:.3f} ms")
    paths = (("(a) (1, 1) mesh of the card", 1, 1, None),
             ("(b) (1, 2) pool meshes, simulated 2 x cuda:0", 2, 2,
              [card] * 4),
             ("(b) (2, 2) pool meshes, simulated 4 x cuda:0", 2, 2,
              [card] * 8))
    for label, n_pools, model_axis, devices in paths:
        meshes = make_fleet_mesh(n_pools, model=model_axis,
                                 devices=devices)
        fleet = PoolFleet.build(
            sch, lambda pool_id, mesh: make_sharded_eps(mesh, params),
            (P15_DIM,), n_pools=n_pools, slots=P15_SLOTS, meshes=meshes)
        _zero_counts()
        res = fleet.serve(_p15_requests(P15_N), now=0.0)
        torch.cuda.synchronize()
        counts = _counts()
        st = fleet.stats()
        ticks_x_shards = sum(p.engine.ticks * shards(p.engine)
                             for p in fleet.pools)
        got = {r.request_id: r.x0 for r in res}
        worst = max(float((got[k] - want[k]).abs().max()) for k in want)
        bitwise = all(torch.equal(got[k], want[k]) for k in want)
        ms = _p15_tick_ms(lambda reqs: fleet.serve(reqs, now=0.0), fleet,
                          P15_N, 1000)
        pools = [(p["mesh"], p["state_sharded"], p["compiled_ticks"])
                 for p in st["pools"]]
        print(f"[p15] {smi} | {label}: {n_pools} pool(s) of "
              f"{meshes[0].shape}, {len(res)} requests, pool ticks "
              f"{[p['ticks'] for p in st['pools']]}, data shards "
              f"{[shards(p.engine) for p in fleet.pools]}, launches "
              f"{counts}; x0 vs unsharded max|d| {worst:.3e} (bitwise "
              f"{bitwise}); (mesh, state_sharded, compiled_ticks) {pools}; "
              f"steady tick {ms:.3f} ms per pool tick ("
              + (f"simulated {meshes[0].size} x cuda:0, no scaling figure"
                 if devices is not None else "the card's own mesh")
              + f") beside the unsharded {ref_ms:.3f} ms")
        check(counts == {"B1": 0, "B2": ticks_x_shards, "B3": 0, "B4": 0},
              f"{label}: launches {counts}, want B2 == ticks x data shards "
              f"{ticks_x_shards}")
        check(sorted(got) == sorted(want), f"{label}: results {sorted(got)}")
        for mesh, (m, sharded, ct) in zip(meshes, pools):
            dsize = mesh.shape["data"]
            rows = P15_SLOTS * fleet.pools[0].engine._rps
            check(m == mesh.shape and ct == 1
                  and sharded == (dsize > 1 and rows % dsize == 0),
                  f"{label}: pool stats {(m, sharded, ct)}")
        if devices is None:
            check(bitwise, f"{label}: x0 not bitwise the unsharded engine's "
                  f"(max|d| {worst})")
        else:
            for k in want:
                check(torch.allclose(got[k], want[k], rtol=P15_RTOL,
                                     atol=P15_ATOL),
                      f"{label}: request {k} beyond rtol/atol 1e-5")
        n_b2 += counts["B2"]

    # (c) the CIFAR10 U-Net on a simulated (2, 1) mesh
    mesh = make_host_mesh(devices=[card] * 2)
    state = {k: v.detach() for k, v in model.state_dict().items()}

    def apply(p, x, t):
        with torch.no_grad():
            return functional_call(model, p, (x, t))
    eng = ContinuousBatchingEngine(sch, sharded_eps_from_apply(mesh, state,
                                                               apply),
                                   CARD_SHAPE, P15_UNET_SLOTS, mesh=mesh)
    lone = ContinuousBatchingEngine(sch, make_eps_fn(model), CARD_SHAPE,
                                    P15_UNET_SLOTS)
    reqs = [SampleRequest(request_id=i, S=P15_UNET_S, seed=300 + i)
            for i in range(2 * P15_UNET_SLOTS)]
    _zero_counts()
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    counts = _counts()
    ticks = eng.ticks
    ticks_x_shards = ticks * shards(eng)
    want = {r.request_id: r.x0 for r in lone.serve(reqs)}
    worst = max(float((r.x0 - want[r.request_id]).abs().max()
                      / want[r.request_id].abs().max()) for r in res)

    def unet_ms(e):
        e.reset_stats()
        e.serve([SampleRequest(request_id=100 + i, S=P15_UNET_S,
                               seed=400 + i) for i in range(len(reqs))])
        torch.cuda.synchronize()
        return 1e3 * e.stats()["tick_wall_s"] / max(e.ticks, 1)
    ms_mesh, ms_lone = unet_ms(eng), unet_ms(lone)
    st = eng.stats()
    print(f"[p15] {smi} | (c) CIFAR10_UNET {P15_UNET_SLOTS} slots on a (2, "
          f"1) mesh (sharded_eps_from_apply), {len(reqs)} requests S="
          f"{P15_UNET_S}: ticks {ticks}, data shards {shards(eng)}, "
          f"launches {counts}, x0 vs the "
          f"unsharded engine worst max|d|/max|x| {worst:.3e} (tol "
          f"{SCHED_VS_EAGER_TOL:g}); mesh {st['mesh']}, state_sharded "
          f"{st['state_sharded']}, compiled_ticks {st['compiled_ticks']}; "
          f"steady tick {ms_mesh:.3f} ms (simulated 2 x cuda:0, no scaling "
          f"figure) beside the unsharded {ms_lone:.3f} ms")
    check(counts == {"B1": 0, "B2": ticks_x_shards, "B3": 0, "B4": 0}
          and shards(eng) == 2,
          f"(c): launches {counts}, want B2 == ticks x 2 = {ticks_x_shards}")
    check(worst <= SCHED_VS_EAGER_TOL, f"(c): x0 {worst} > "
          f"{SCHED_VS_EAGER_TOL:g} of max|x|")
    check(st["state_sharded"] and st["compiled_ticks"] == 1
          and st["mesh"] == {"data": 2, "model": 1}, f"(c): stats {st}")
    return n_b2 + counts["B2"]


def draw_probe(smi, src) -> None:
    """--draw-probe: the draw's cost on SRC's tree, as one JSON line: the
    host µs of one scheduler x_T draw (``_draw_xT``), a steady tick, and at
    CIFAR10 width serve samples/s (det S=20 and eta=1 S=10, over the
    serve's wall and as its stats count them, which leave the x_T draw
    out) and the scheduler's slot-steps/s (over the serve's wall, and over
    the tick walls, which leave admission out)."""
    from repro_torch.core import make_schedule
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.sampling import SamplerPlan
    from repro_torch.serving import DiffusionSampler, SampleRequest
    sch = make_schedule("linear", 1000)
    model = _cifar10_model()
    svc = DiffusionSampler(sch, make_eps_fn(model), CARD_SHAPE,
                           batch_size=BATCH, tile_resident=True)
    det = SamplerPlan.build(sch, 20)
    sto = SamplerPlan.build(sch, 10, sigma=1.0)
    rates = {}
    for name, plan in (("det_s20", det), ("eta1_s10", sto)):
        svc.serve(BATCH, plan, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = svc.serve(3 * BATCH, plan, seed=1)
        torch.cuda.synchronize()
        rates[f"serve_{name}_samples_per_s_wall"] = (
            3 * BATCH / (time.perf_counter() - t0))
        rates[f"serve_{name}_samples_per_s_stats"] = st["samples_per_s"]
    eng = svc.continuous(slots=SCHED_SLOTS)
    walls = []
    for i in range(60):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._draw_xT(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    draw_us = statistics.median(walls[10:]) * 1e6

    def reqs(base):
        return [SampleRequest(request_id=base + i, S=10, eta=0.0,
                              seed=base + i) for i in range(2 * SCHED_SLOTS)]
    eng.serve(reqs(0))
    eng.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.serve(reqs(100))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    es = eng.stats()
    print(json.dumps({"card": smi, "probe": "draw", "src": str(src),
                      "draw_xT_us": draw_us, **rates,
                      "sched_slot_steps_per_s_wall": es["slot_steps"] / wall,
                      "sched_slot_steps_per_s_ticks": es["steps_per_s"],
                      "sched_tick_ewma_ms": es["tick_ewma_s"] * 1e3,
                      "draw_share_of_tick":
                          draw_us / 1e3 / (es["tick_ewma_s"] * 1e3)}))


def tick_probe(smi, src) -> None:
    """--tick-probe: the steady tick wall of the unsharded engines of
    phases 4-9 on SRC's tree, as one JSON line: the CIFAR10 U-Net
    scheduler (eta 0; eta 1 and order-2 requests alternated on a
    stochastic order-2 engine with preview; probed) and the
    diffusion-LM trunk's mega and unfused ticks.  Per engine, 3 waves of
    ``slots`` requests at S=20 after a warm wave; a tick's wall is the
    host clock around ``tick()`` and a synchronisation, over the ticks
    where every slot is busy and nothing is admitted or retired (17 a
    wave); reported as the median (ms) and the stats' mean fn wall."""
    from repro_torch.configs import DLM_SMOLLM_MEGA as cfg
    from repro_torch.core.schedules import make_schedule
    from repro_torch.diffusion_lm import make_tile_eps_fn
    from repro_torch.models.unet import make_eps_fn
    from repro_torch.sampling import SamplerPlan
    from repro_torch.serving import ContinuousBatchingEngine, SampleRequest
    sch = make_schedule("linear", 1000)
    unet_eps = make_eps_fn(_cifar10_model())
    dlm_eps = make_tile_eps_fn(_dlm_params(cfg), cfg, DLM_BATCH, DLM_SEQ)
    dlm_shape = (DLM_SEQ, cfg.latent_dim)
    det = SamplerPlan.build(sch, 20)
    plans = {"det": (det,),
             "mixed": (SamplerPlan.build(sch, 20, sigma=1.0),
                       SamplerPlan.build(sch, 20, order=2))}
    engines = (
        ("unet_det", "det", ContinuousBatchingEngine(
            sch, unet_eps, CARD_SHAPE, SCHED_SLOTS)),
        ("unet_eta1_or_order2_preview", "mixed", ContinuousBatchingEngine(
            sch, unet_eps, CARD_SHAPE, SCHED_SLOTS, stochastic=True,
            max_order=2, preview=True)),
        ("unet_probed", "det", ContinuousBatchingEngine(
            sch, unet_eps, CARD_SHAPE, SCHED_SLOTS, probes=True)),
        ("dlm_mega", "det", ContinuousBatchingEngine(
            sch, dlm_eps, dlm_shape, DLM_BATCH)),
        ("dlm_rows", "det", ContinuousBatchingEngine(
            sch, dlm_eps, dlm_shape, DLM_BATCH, use_mega=False)))
    out = {"card": smi, "probe": "tick", "src": str(src)}
    for name, plan, eng in engines:
        def wave(base):
            for i in range(eng.slots):
                ps = plans[plan]
                eng.submit(SampleRequest(request_id=base + i, seed=base + i,
                                         plan=ps[i % len(ps)]))
        wave(0)
        eng.run()
        eng.reset_stats()
        walls = []
        for w in range(3):
            wave(100 * (w + 1))
            for k in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.tick()
                torch.cuda.synchronize()
                if 2 <= k <= 18:
                    walls.append((time.perf_counter() - t0) * 1e3)
            eng.run()
        st = eng.stats()
        out[f"{name}_tick_ms_median"] = statistics.median(walls)
        out[f"{name}_fn_ms_mean"] = 1e3 * st["tick_wall_s"] / st["ticks"]
        if name.startswith("dlm"):
            out.update(_tick_fn_vs_bare(eng, name, dlm_shape))
    print(json.dumps(out))


def _tick_fn_vs_bare(eng, name, shape):
    """With every slot of ``eng`` busy: the host ms (median of 200, each
    call synchronised, the two alternated and their order swapped every
    round) of the engine's tick function and of the bare step it wraps on
    the same tensors (``megastep_rows`` for a mega engine,
    ``slot_tile_step`` else): their difference is what the engine's state
    handling costs a tick."""
    from repro_torch.core.sampler import slot_tile_step
    from repro_torch.kernels import megastep as mega_ops
    from repro_torch.kernels.sampler_step import ops as sops
    from repro_torch.serving import SampleRequest
    for i in range(eng.slots):
        eng.submit(SampleRequest(request_id=9000 + i, S=500, seed=i))
    eng.tick()
    fn, states = eng._tick(False), eng._states()
    x2s = eng._x2
    x2 = x2s[0] if isinstance(x2s, list) else x2s

    def bare():
        if eng.use_mega:
            return mega_ops.megastep_rows(
                x2, eng.eps_fn.mega_spec, sops.expand_slot_coefs(
                    states.coef_matrix(), eng._rps), states.t,
                clip=eng.clip_x0)
        return slot_tile_step(eng.eps_fn, x2, states, shape,
                              clip_x0=eng.clip_x0)
    walls = {"fn": [], "bare": []}
    calls = {"fn": lambda: fn(x2s, eng._hist2, states, eng.eps_params),
             "bare": bare}
    for i in range(220):
        for key in (("fn", "bare") if i % 2 else ("bare", "fn")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[key]()
            torch.cuda.synchronize()
            if i >= 20:
                walls[key].append((time.perf_counter() - t0) * 1e3)
    fn_ms, bare_ms = (statistics.median(walls[k]) for k in ("fn", "bare"))
    return {f"{name}_tick_fn_ms": fn_ms, f"{name}_bare_step_ms": bare_ms,
            f"{name}_state_handling_ms": fn_ms - bare_ms}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launch-probe", metavar="SRC", type=Path,
                    help="only time the launch floor and the B1 / B2 pairs "
                         "of SRC/repro_torch (another checkout's src)")
    ap.add_argument("--lm-probe", metavar="SRC", type=Path,
                    help="only run phase 10's smollm-135m and llama3.2-3b "
                         "runs and checks on SRC/repro_torch")
    ap.add_argument("--p12-probe", action="store_true",
                    help="only build the kernels and run phase 12 (App. A, "
                         "the shim and adapters, the inits, the moe and vlm "
                         "families) on this checkout")
    ap.add_argument("--p13-probe", action="store_true",
                    help="only build the kernels and run phase 13 (the ssm, "
                         "hybrid and audio families and their diffusion-LM "
                         "trunks) on this checkout")
    ap.add_argument("--p14-probe", action="store_true",
                    help="only build the kernels and run phase 14 (the six "
                         "examples, the roofline and shapes lines) on this "
                         "checkout")
    ap.add_argument("--p15-probe", action="store_true",
                    help="only build the kernels and run phase 15 (the "
                         "mesh-sharded slot pools) on this checkout")
    ap.add_argument("--draw-probe", metavar="SRC", type=Path,
                    help="only time the x_T draw, serve and the U-Net "
                         "scheduler on SRC/repro_torch (phase 11's cost "
                         "against another checkout)")
    ap.add_argument("--tick-probe", metavar="SRC", type=Path,
                    help="only time the steady ticks of phases 4-9's "
                         "unsharded engines on SRC/repro_torch (another "
                         "checkout's src)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    src = (args.launch_probe or args.lm_probe or args.draw_probe
           or args.tick_probe or SRC).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    global RL
    from repro_torch.launch import roofline as RL
    t0 = time.perf_counter()
    smi = phase_card()
    if args.launch_probe:
        launch_probe(smi)
        return 0
    if args.draw_probe:
        draw_probe(smi, src)
        return 0
    if args.tick_probe:
        tick_probe(smi, src)
        return 0
    from repro_torch.configs import LLAMA3_2_3B, SMOLLM_135M
    if args.lm_probe:
        phase_lm(smi, SMOLLM_135M, 64)
        phase_lm(smi, LLAMA3_2_3B, 128)
        return 0
    from repro_torch import prng
    from repro_torch.configs import DLM_SMOLLM, DLM_SMOLLM_MEGA
    phase_build()
    if args.p12_probe:
        phase_12(smi, _cifar10_model())
        print(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.p13_probe:
        phase_13(smi)
        print(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.p14_probe:
        phase_14(smi)
        print(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.p15_probe:
        phase_15(smi, _cifar10_model())
        print(f"[done] {time.perf_counter() - t0:.1f} s")
        return 0
    errs = phase_kernels()
    params2 = _dlm_params(DLM_SMOLLM_MEGA)
    errs_dlm = phase_kernels_dlm(params2)
    errs_sched = phase_kernels_sched(params2)
    model = _cifar10_model()
    launches, st_det, svc, det = phase_main(model)
    b3_launches = phase_main_dlm(params2, _dlm_params(DLM_SMOLLM))
    ops_launches = phase_ops_path()
    sched_counts, eng_unet = phase_main_sched(model)
    dlm_counts, dlm_mega, dlm_plain = phase_main_dlm_sched(params2)
    # B2 runs on two main paths: the lockstep rows run and the scheduler
    launches["sampler_step_rows_2d"] += sched_counts["B2"]
    b_kernels, alone = phase_times(smi, model, errs, launches, st_det)
    kernels = list(b_kernels)
    kernels += phase_times_dlm(smi, params2, errs_dlm, b3_launches,
                               ops_launches)
    kernels += phase_times_sched(smi, params2, errs_sched, dlm_counts["B4"],
                                 eng_unet, dlm_mega, dlm_plain)
    gen = torch.Generator(device="cuda").manual_seed(3)
    key = prng.PRNGKey(3)
    profile_call(smi, f"one serve batch (eta=0, S={det.S}, batch "
                 f"{svc.batch})", lambda: svc.sample_batch(det, key),
                 "step_kernel")
    # Encode / decode / interpolation and the (2, 128) fallback run after
    # every rate above, so that those are timed from the state they were
    # timed in before these paths existed.  B1 runs on three main paths:
    # serve, decode and interpolation.
    next(r for r in b_kernels if r["name"] == "sampler_step_2d")[
        "launches"] += phase_main_ode(smi, model)
    phase_mega_fallback(smi, params2)
    z = det.encode(svc.eps_fn, torch.randn((BATCH,) + CARD_SHAPE,
                                           generator=gen, device="cuda"))
    profile_call(smi, f"one decode (encoded latent, S={det.S}, batch "
                 f"{BATCH}, tile_resident)", lambda: det.run(
                     svc.eps_fn, z, backend="tile_resident"), "step_kernel")
    phase_launch(smi, b_kernels, alone)
    # The autotuner runs last: every rate above is timed from the state
    # earlier trees timed it in.  B1 runs on its rollouts and on
    # serve("auto"), B2 on the bank-driven scheduler's ticks.
    b1_auto, b2_auto = phase_autotuner(smi, model)
    # Phase 8 runs after phase 7, so that every rate above is timed from
    # the state it was timed in before.  B2 runs on the probed scheduler,
    # the U-Net fleets and the probed unfused DLM engine, B4 on the mega
    # fleet's pool ticks.
    b2_p8 = phase_telemetry(smi, model) + phase_fleet(smi, model)
    b2_mega, b4_p8 = phase_mega_fleet(params2)
    # Phase 9 runs last, so that every rate above is timed from the state
    # it was timed in before.  B2 runs on every pool tick of the gateway,
    # its hot swap and the chaos replay, and on the CLI's scheduler.
    b2_gw, base, alt, eps_apply, lone = phase_gateway(smi, model)
    b2_chaos = phase_chaos(smi, base, alt, eps_apply, lone)
    b2_cli = phase_serve_cli(smi)
    # Phase 10 runs last, so that every rate above is timed as before.
    # The autoregressive path launches none of the seven kernels.
    phase_lm(smi, SMOLLM_135M, 64)
    phase_lm(smi, LLAMA3_2_3B, 128)
    phase_lm_cli(smi)
    # Phase 11 runs last, so that every rate above is timed as before:
    # JAX's draws on the card, then training (none of the seven kernels
    # launches in a train step; B1 serves the trained weights).
    phase_draws_card(smi)
    b1_p11, b2_p11 = phase_draws_parity(smi)
    b1_p11 += phase_train_unet(smi)
    phase_train_lm(smi)
    b1_p11 += phase_train_cli(smi)
    # Phase 12 runs last, so that every rate above is timed as before.  B1
    # runs on the shim, the CFG / v-prediction serves and the MoE
    # diffusion-LM trunk; the AR paths launch none of the seven.
    b1_p12 = phase_12(smi, model)
    # Phase 13 runs last, so that every rate above is timed as before.  B1
    # runs on the rwkv6 and Mamba2 diffusion-LM trunks; the AR paths of
    # the ssm, hybrid and audio families launch none of the seven.
    b1_p13 = phase_13(smi)
    # Phase 14 runs last, so that every rate above is timed as before.  B1
    # runs on quickstart's tile_resident check and interpolation's decode,
    # B2 on quickstart's rows check and every gateway_sse pool tick.
    b1_p14, b2_p14 = phase_14(smi)
    # Phase 15 runs last, so that every rate above is timed as before.  B2
    # runs once per data shard per pool tick of the mesh pools.
    b2_p15 = phase_15(smi, model)
    recs = {r["name"]: r for r in kernels}
    recs["sampler_step_2d"]["launches"] += (b1_auto + b1_p11 + b1_p12
                                            + b1_p13 + b1_p14)
    recs["sampler_step_rows_2d"]["launches"] += (b2_auto + b2_p8 + b2_mega
                                                 + b2_gw + b2_chaos + b2_cli
                                                 + b2_p11 + b2_p14
                                                 + b2_p15)
    recs["megastep_rows_call"]["launches"] += b4_p8
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
