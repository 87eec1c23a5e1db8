"""Statics-keyed rollout executor — port of ``repro/autoplan/executor.py``.

The search scores hundreds of candidate trajectories by full rollout.
Every candidate at one step budget is the SAME program fed a different
coefficient table; the JAX package compiles one scan per plan *statics* —
(S, order, stochastic, clip, batch shape, dtype) — and passes the table
as data.  Eager PyTorch compiles nothing, so the port keeps JAX's
bookkeeping only: ``traces`` / ``compiled`` count the distinct statics
keys seen, ``calls`` the rollouts run.

A deterministic rollout is the 'tile_resident' backend itself
(``run_tile_resident``): the (R, 256) tile layout carried through the S
steps, one ``sampler_step_2d`` (B1) launch per step on the card, bitwise
``plan.run(eps_fn, x_T, backend='tile_resident')`` — the searched scores
are scores of exactly what ``DiffusionSampler(tile_resident=True)``
serves — and, like that backend, bitwise 'eager' on the CPU.  A
stochastic rollout is the 'eager' backend (``run_eager``): its noise is
``normal`` of ``split(rng, S)``, the draws of JAX's executor (the 'jnp'
scan), so both packages score a stochastic candidate alike for one key.
"""
from __future__ import annotations

from typing import Optional, Set, Tuple

import torch

from repro_torch.sampling import SamplerPlan
from repro_torch.sampling.backends import run_eager, run_tile_resident


class PlanExecutor:
    """Rollouts with JAX's statics-keyed bookkeeping: deterministic plans
    on the tile-resident loop, stochastic plans on the eager loop.

    Args:
      eps_fn: the (fixed) eps model every candidate is scored against.

    Attributes:
      traces: distinct (S, order, stochastic, clip, batch-shape, dtype)
        combinations seen so far — JAX's search-efficiency contract,
        ``traces == #distinct statics``, not #candidates.
      calls: rollouts run.
    """

    def __init__(self, eps_fn):
        self.eps_fn = eps_fn
        self._statics: Set[Tuple] = set()
        self.traces = 0
        self.calls = 0

    def run(self, plan: SamplerPlan, x_T: torch.Tensor,
            rng: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Execute ``plan`` from x_T: the 'tile_resident' backend for a
        deterministic plan, the 'eager' backend (JAX's noise) for a
        stochastic one."""
        if plan.stochastic and rng is None:
            raise ValueError("stochastic candidate plan needs rng")
        key = (plan.S, plan.order, plan.stochastic, plan.x0.clip,
               tuple(x_T.shape), str(x_T.dtype))
        if key not in self._statics:
            self._statics.add(key)
            self.traces += 1
        self.calls += 1
        run = run_eager if plan.stochastic else run_tile_resident
        with torch.no_grad():
            return run(plan, self.eps_fn, x_T, rng)

    @property
    def compiled(self) -> int:
        return len(self._statics)
