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

``continuous()`` builds the continuous-batching scheduler
(``serving/scheduler``) over the same model.  Not ported yet:
``ARGenerator``, the plan bank / ``"auto"`` plans, the legacy
``SamplerConfig`` adapter and buffer donation.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.schedules import NoiseSchedule
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.sampling import SamplerPlan


class DiffusionSampler:
    """Batched DDIM/DDPM sampling service (the paper's product surface)."""

    def __init__(self, schedule: NoiseSchedule, eps_fn: Callable,
                 sample_shape: Tuple[int, ...], batch_size: int,
                 dtype: torch.dtype = torch.float32,
                 tile_resident: bool = False,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 device: DeviceLike = None):
        """Args:

        eps_fn: eps_theta(x, t) on ``device`` (e.g. models.make_eps_fn).
        sample_shape: one sample's shape, e.g. (32, 32, 3) NHWC.
        dtype: state dtype (float32 or bfloat16).
        tile_resident: run each batch in the tile layout through the
          sampler_step_2d kernel instead of the eager loop.
        bucket_sizes: ascending batch-size ladder for ragged loads;
          defaults to (batch_size,).
        device: where the service runs; None is the CUDA card.
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

    def sample_batch(self, plan: SamplerPlan, generator: torch.Generator,
                     n: Optional[int] = None) -> Tuple[torch.Tensor, float]:
        """One batch for ``plan``: (samples, seconds of the plan run)."""
        if not isinstance(plan, SamplerPlan):
            raise TypeError(f"expected a SamplerPlan, got {type(plan)}")
        batch = self._bucket_for(n) if n is not None else self.batch
        x_T = torch.randn((batch,) + self.shape, generator=generator,
                          dtype=self.dtype, device=self.device)
        backend = "tile_resident" if self.tile_resident else "eager"
        synchronize(self.device)
        t0 = time.perf_counter()
        out = plan.run(self.eps_fn, x_T, generator, backend=backend)
        synchronize(self.device)
        return out, time.perf_counter() - t0

    def serve(self, n_samples: int, plan: SamplerPlan,
              seed: int = 0) -> Tuple[torch.Tensor, Dict]:
        """Produce n_samples in lockstep batches; returns samples + stats.

        x_T and the per-step kernel seeds come from one torch.Generator on
        the service's device, seeded with ``seed``.  The first batch
        includes the kernels' first-use build; the steady-state figures
        exclude it when there is more than one batch.
        """
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
        max_order, max_queue, use_mega, ...)."""
        from .scheduler import ContinuousBatchingEngine
        return ContinuousBatchingEngine(
            self.schedule, self.eps_fn, self.shape,
            slots=slots or self.batch, dtype=self.dtype,
            device=kw.pop("device", self.device), **kw)
