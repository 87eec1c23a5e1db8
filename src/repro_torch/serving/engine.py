"""Batched serving engine (port of ``repro/serving/engine.py``).

Two services:
  * ARGenerator — the classic prefill + decode loop with a KV / state
    cache over a registered architecture (any family of
    ``models.registry``; an audio or vlm model takes its stub embeddings
    through ``generate(..., embeds=)``), with greedy / temperature /
    top-k sampling per request from JAX's threefry keys (``repro_torch.
    prng``), so one ``rng_seed`` draws JAX's Gumbels.  The decode step
    writes the cache in place (JAX donates it), so steady-state decoding
    allocates no new cache.
  * DiffusionSampler — the batched DDIM sampling service, below.

DiffusionSampler (``repro/serving/engine.py:154-336``).

Requests are served in lockstep batches: every sample of a batch shares
one SamplerPlan and runs the whole S-step loop together.  Ragged loads
split into bucket-ladder chunks (``_chunk_plan``) instead of padding the
whole remainder to the next rung.  With ``tile_resident=True`` each batch
runs ``plan.run(backend='tile_resident')`` — the (R, 256) tile layout and
one ``sampler_step_2d`` CUDA launch per step; otherwise the plain eager
loop.  The state dtype may be bfloat16 or float16 while every
coefficient stays float32 (the kernels compute in float32 and cast on
store).

``sample_batch`` / ``serve`` take a ``SamplerPlan``, a legacy
``SamplerConfig`` (compiled to its plan) or ``"auto"``: the quality end of
the service's ``plan_bank`` (``repro_torch.autoplan.PlanBank``).
``continuous()`` builds the continuous-batching scheduler
(``serving/scheduler``) over the same model and passes the bank on, for
per-request deadline-aware selection.  Not ported: buffer donation of
x_T.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import get_api
from repro_torch.sampling import SamplerPlan
from repro_torch.sampling.plan import _schedule_digest


@dataclasses.dataclass
class GenRequest:
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0
    rng_seed: int = 0


@dataclasses.dataclass
class GenResult:
    tokens: np.ndarray
    prefill_ms: float
    decode_ms: float
    tokens_per_s: float


class ARGenerator:
    """Fixed-batch autoregressive server for one architecture."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int,
                 max_len: int, dtype: torch.dtype = torch.float32,
                 donate: Optional[bool] = None, device: DeviceLike = None):
        """``params``: the family's parameter dict, on ``device``.
        ``max_len``: the cache length M; as in JAX nothing checks it
        against prompt + new tokens (positions past M wrap round the
        ring).  ``donate`` is kept for the JAX signature only: the port's
        decode step always writes the cache in place, which is what JAX's
        donation gives, so None and True mean that and False (an
        out-of-place decode) is refused.  ``device``: None is the CUDA
        card."""
        if donate is False:
            raise ValueError("ARGenerator updates the KV cache in place; an "
                             "out-of-place decode (donate=False) is not "
                             "ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = get_api(cfg)
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.dtype = dtype

    @staticmethod
    def _sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                       top_ks: torch.Tensor, rngs: torch.Tensor,
                       max_k: int) -> torch.Tensor:
        """Per-request sampling, vectorized over the batch.

        logits (B, V); temps/top_ks (B,); rngs (B, 2) threefry keys. Rows
        with temperature <= 0 are greedy; rows with top_k == 0 skip the
        top-k filter. max_k is the top-k width (max over requests).
        """
        greedy = logits.argmax(-1)
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
        if max_k > 0:
            top = torch.topk(scaled, max_k, dim=-1).values
            kth = torch.gather(top, -1,
                               torch.clamp(top_ks - 1, 0, max_k - 1)[:, None])
            scaled = torch.where((top_ks[:, None] > 0) & (scaled < kth),
                                 float("-inf"), scaled)
        sampled = prng.categorical(rngs, scaled)
        return torch.where(temps <= 0.0, greedy, sampled)

    @torch.no_grad()
    def generate(self, requests: Sequence[GenRequest],
                 embeds: Optional[torch.Tensor] = None) -> List[GenResult]:
        assert len(requests) <= self.batch
        reqs = list(requests)
        dev = self.device
        prompt_len = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.batch, prompt_len), np.int32)
        for i, r in enumerate(reqs):
            toks[i, prompt_len - len(r.prompt):] = r.prompt  # left-pad
        cache = self.api.init_cache(self.cfg, self.batch, self.max_len,
                                    self.dtype, dev)
        tokens = torch.from_numpy(toks).to(dev)
        synchronize(dev)
        t0 = time.perf_counter()
        kwargs = {"embeds": embeds} if embeds is not None else {}
        logits, cache = self.api.prefill(self.params, self.cfg, tokens,
                                         cache, **kwargs)
        synchronize(dev)
        t1 = time.perf_counter()
        max_new = max(r.max_new_tokens for r in reqs)
        # per-request sampling params (padding rows are greedy/ignored)
        pad = self.batch - len(reqs)
        temps = torch.tensor([r.temperature for r in reqs] + [0.0] * pad,
                             dtype=torch.float32, device=dev)
        top_ks = torch.tensor([r.top_k for r in reqs] + [0] * pad,
                              dtype=torch.int64, device=dev)
        max_k = max((r.top_k for r in reqs), default=0)
        rngs = torch.stack([prng.PRNGKey(r.rng_seed, dev) for r in reqs]
                           + [prng.PRNGKey(0, dev)] * pad)
        # one copy per step into a host buffer, read after the last step
        out = torch.empty((max_new, self.batch), dtype=torch.int64,
                          pin_memory=dev.type == "cuda")
        for step in range(max_new):
            split = prng.split(rngs, 2)
            rngs, subs = split[:, 0], split[:, 1]
            nxt = self._sample_tokens(logits, temps, top_ks, subs, max_k)
            out[step].copy_(nxt, non_blocking=True)
            logits, cache = self.api.decode_step(self.params, self.cfg,
                                                 nxt[:, None], cache)
        synchronize(dev)
        t2 = time.perf_counter()
        host = out.numpy().astype(np.int32)
        results = []
        for i, r in enumerate(reqs):
            n = r.max_new_tokens
            results.append(GenResult(
                tokens=host[:n, i].copy(),
                prefill_ms=(t1 - t0) * 1e3,
                decode_ms=(t2 - t1) * 1e3,
                tokens_per_s=max_new * len(reqs) / max(t2 - t1, 1e-9)))
        return results


class DiffusionSampler:
    """Batched DDIM/DDPM sampling service (the paper's product surface)."""

    def __init__(self, schedule: NoiseSchedule, eps_fn: Callable,
                 sample_shape: Tuple[int, ...], batch_size: int,
                 dtype: torch.dtype = torch.float32,
                 tile_resident: bool = False,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 device: DeviceLike = None, plan_bank=None):
        """Args:

        eps_fn: eps_theta(x, t) on ``device`` (e.g. models.make_eps_fn).
        sample_shape: one sample's shape, e.g. (32, 32, 3) NHWC.
        dtype: state dtype (float32, bfloat16 or float16).
        tile_resident: run each batch in the tile layout through the
          sampler_step_2d kernel instead of the eager loop.
        bucket_sizes: ascending batch-size ladder for ragged loads;
          defaults to (batch_size,).
        device: where the service runs; None is the CUDA card.
        plan_bank: a ``repro_torch.autoplan.PlanBank`` searched on
          ``schedule`` (digest-validated). ``serve``/``sample_batch`` then
          accept ``"auto"`` (the bank's quality end) and
          ``bank_plan(max_nfe)`` picks a budget-bounded row;
          ``continuous()`` passes the bank on to the scheduler.
        """
        self.schedule = schedule
        self.eps_fn = eps_fn
        self.shape = tuple(sample_shape)
        self.batch = batch_size
        self.dtype = dtype
        self.tile_resident = tile_resident
        self.device = resolve_device(device)
        buckets = tuple(sorted(bucket_sizes or (batch_size,)))
        if buckets[-1] < batch_size:
            buckets = buckets + (batch_size,)
        self.buckets = buckets
        self.plan_bank = plan_bank
        # JAX's compiled-program keys, (plan, batch): eager PyTorch builds
        # no program per key, the stats count the keys seen
        self._programs = set()
        if plan_bank is not None and (_schedule_digest(plan_bank.schedule)
                                      != _schedule_digest(schedule)):
            raise ValueError(
                "plan_bank was searched on a different noise schedule "
                "than this service serves")

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _chunk_plan(self, n: int) -> List[int]:
        """Greedy largest-bucket-that-fits; the final sub-bucket tail rounds
        up to the smallest covering rung only."""
        plan = []
        while n > 0:
            fits = [b for b in self.buckets if b <= n]
            b = max(fits) if fits else self._bucket_for(n)
            plan.append(b)
            n -= b
        return plan

    def _as_plan(self, plan_or_cfg) -> SamplerPlan:
        """Normalize the request surface: a SamplerPlan passes through,
        ``"auto"`` resolves against the plan bank, a legacy SamplerConfig
        compiles to its equivalent plan."""
        if isinstance(plan_or_cfg, SamplerPlan):
            return plan_or_cfg
        if isinstance(plan_or_cfg, str) and plan_or_cfg == "auto":
            return self.bank_plan()
        return plan_or_cfg.to_plan(self.schedule)

    def bank_plan(self, max_nfe: Optional[int] = None) -> SamplerPlan:
        """The plan bank's best row with NFE <= max_nfe (None = best).

        Graceful degradation, not a hard cap: when every bank row exceeds
        ``max_nfe`` this returns the SMALLEST row (the cheapest searched
        trajectory the bank knows) rather than failing — check the
        returned ``plan.S`` if the budget is a hard limit.
        """
        if self.plan_bank is None:
            raise ValueError("no plan bank: build the DiffusionSampler "
                             "with plan_bank= to use cfg='auto'")
        plan = self.plan_bank.best(max_nfe)
        if plan is None:
            raise ValueError("the plan bank is empty")
        return plan

    def sample_batch(self, cfg, rng: torch.Tensor,
                     n: Optional[int] = None) -> Tuple[torch.Tensor, float]:
        """One batch for ``cfg`` (a SamplerPlan, a SamplerConfig or
        ``"auto"``): (samples, seconds of the plan run).  ``k1, k2 =
        split(rng)``: x_T is ``normal(k1)`` drawn in the service's dtype
        and the plan runs with ``k2``, as in JAX."""
        plan = self._as_plan(cfg)
        batch = self._bucket_for(n) if n is not None else self.batch
        self._programs.add((plan, batch))
        k1, k2 = prng.split(rng.to(self.device))
        x_T = prng.normal(k1, (batch,) + self.shape, dtype=self.dtype)
        backend = "tile_resident" if self.tile_resident else "eager"
        synchronize(self.device)
        t0 = time.perf_counter()
        out = plan.run(self.eps_fn, x_T, k2, backend=backend)
        synchronize(self.device)
        return out, time.perf_counter() - t0

    def serve(self, n_samples: int, cfg,
              seed: int = 0) -> Tuple[torch.Tensor, Dict]:
        """Produce n_samples in lockstep batches; returns samples + stats.
        ``cfg`` may be a SamplerPlan, a legacy SamplerConfig or ``"auto"``.

        x_T and the per-step kernel seeds come from ``PRNGKey(seed)`` on
        the service's device, split once per chunk as JAX splits it, so
        one seed gives JAX's draws.  The first batch
        includes the kernels' first-use build; the steady-state figures
        exclude it when there is more than one batch.  The stats carry
        JAX's keys: ``compiled_programs`` counts the distinct (plan,
        batch) keys served so far (JAX compiles one program per key), and
        ``donated`` is False: no run takes over x_T's buffer.
        """
        plan = self._as_plan(cfg)
        dtype_name = str(self.dtype).replace("torch.", "")
        if n_samples <= 0:
            empty = torch.zeros((0,) + self.shape, dtype=self.dtype,
                                device=self.device)
            return empty, {"batches": 0, "first_batch_s": 0.0,
                           "steady_batch_s": 0.0, "samples_per_s": 0.0,
                           "net_evals_per_sample": plan.S,
                           "compiled_programs": len(self._programs),
                           "dtype": dtype_name, "donated": False}
        rng = prng.PRNGKey(seed, self.device)
        outs, times, sizes = [], [], []
        delivered = 0
        for bucket in self._chunk_plan(n_samples):
            rng, sub = prng.split(rng)
            out, dt = self.sample_batch(plan, sub, n=bucket)
            outs.append(out)
            times.append(dt)
            # throughput counts DELIVERED samples only: the final chunk's
            # bucket padding is compute the caller never sees
            sizes.append(min(out.shape[0], n_samples - delivered))
            delivered += sizes[-1]
        samples = torch.cat(outs)[:n_samples]
        sl = slice(1, None) if len(times) > 1 else slice(None)
        return samples, {
            "batches": len(times),
            "first_batch_s": times[0],
            "steady_batch_s": sum(times[sl]) / len(times[sl]),
            "samples_per_s": float(sum(sizes[sl])) / float(sum(times[sl])),
            "net_evals_per_sample": plan.S,
            "compiled_programs": len(self._programs),
            "dtype": dtype_name,
            "donated": False,
        }

    def continuous(self, slots: Optional[int] = None, **kw):
        """Build the continuous-batching engine over this service's model:
        the same schedule, eps model, sample shape, dtype and device, but
        requests carry their OWN plan and seed, are admitted mid-flight
        into resident slots, and never wait on a batchmate's longer
        trajectory.  Keyword args pass through to
        ``ContinuousBatchingEngine`` (stochastic, clip_x0, preview,
        max_order, max_queue, use_mega, select_margin, ...); the service's
        ``plan_bank`` is passed on unless ``plan_bank=`` overrides it."""
        from .scheduler import ContinuousBatchingEngine
        return ContinuousBatchingEngine(
            self.schedule, self.eps_fn, self.shape,
            slots=slots or self.batch, dtype=self.dtype,
            device=kw.pop("device", self.device),
            plan_bank=kw.pop("plan_bank", self.plan_bank), **kw)
