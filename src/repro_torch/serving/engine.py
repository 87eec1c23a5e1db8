"""Batched DDIM sampling service (port of ``DiffusionSampler``,
``repro/serving/engine.py:154-336``).

Requests are served in lockstep batches: every sample of a batch shares
one SamplerPlan and runs the whole S-step loop together.  Ragged loads
split into bucket-ladder chunks (``_chunk_plan``) instead of padding the
whole remainder to the next rung.  With ``tile_resident=True`` each batch
runs ``plan.run(backend='tile_resident')`` — the (R, 256) tile layout and
one ``sampler_step_2d`` CUDA launch per step; otherwise the plain eager
loop.  The state dtype may be bfloat16 while every coefficient stays
float32 (the kernels compute in float32 and cast on store).

``sample_batch`` / ``serve`` take a ``SamplerPlan``, a legacy
``SamplerConfig`` (compiled to its plan) or ``"auto"``: the quality end of
the service's ``plan_bank`` (``repro_torch.autoplan.PlanBank``).
``continuous()`` builds the continuous-batching scheduler
(``serving/scheduler``) over the same model and passes the bank on, for
per-request deadline-aware selection.  Not ported yet: ``ARGenerator`` and
buffer donation.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.schedules import NoiseSchedule
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.sampling import SamplerPlan
from repro_torch.sampling.plan import _schedule_digest


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
        dtype: state dtype (float32 or bfloat16).
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

    def sample_batch(self, cfg, generator: torch.Generator,
                     n: Optional[int] = None) -> Tuple[torch.Tensor, float]:
        """One batch for ``cfg`` (a SamplerPlan, a SamplerConfig or
        ``"auto"``): (samples, seconds of the plan run)."""
        plan = self._as_plan(cfg)
        batch = self._bucket_for(n) if n is not None else self.batch
        x_T = torch.randn((batch,) + self.shape, generator=generator,
                          dtype=self.dtype, device=self.device)
        backend = "tile_resident" if self.tile_resident else "eager"
        synchronize(self.device)
        t0 = time.perf_counter()
        out = plan.run(self.eps_fn, x_T, generator, backend=backend)
        synchronize(self.device)
        return out, time.perf_counter() - t0

    def serve(self, n_samples: int, cfg,
              seed: int = 0) -> Tuple[torch.Tensor, Dict]:
        """Produce n_samples in lockstep batches; returns samples + stats.
        ``cfg`` may be a SamplerPlan, a legacy SamplerConfig or ``"auto"``.

        x_T and the per-step kernel seeds come from one torch.Generator on
        the service's device, seeded with ``seed``.  The first batch
        includes the kernels' first-use build; the steady-state figures
        exclude it when there is more than one batch.
        """
        plan = self._as_plan(cfg)
        dtype_name = str(self.dtype).replace("torch.", "")
        if n_samples <= 0:
            empty = torch.zeros((0,) + self.shape, dtype=self.dtype,
                                device=self.device)
            return empty, {"batches": 0, "first_batch_s": 0.0,
                           "steady_batch_s": 0.0, "samples_per_s": 0.0,
                           "net_evals_per_sample": plan.S,
                           "dtype": dtype_name}
        generator = torch.Generator(device=self.device).manual_seed(seed)
        outs, times, sizes = [], [], []
        delivered = 0
        for bucket in self._chunk_plan(n_samples):
            out, dt = self.sample_batch(plan, generator, n=bucket)
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
            "dtype": dtype_name,
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
