"""Request/result records for the continuous-batching scheduler (port of
``repro/serving/scheduler/request.py``, same field names).

A :class:`SampleRequest` is one sampling job with its OWN quality/latency
dial: a frozen ``SamplerPlan`` (``plan=``) with any tau spacing, sigma
schedule and solver order the engine was built for, or the scalar knobs
(S, eta, tau_kind, sigma_hat), which compile to the equivalent plan at
admission.  Timestamps are in the caller's clock (wall time by default, a
virtual clock in replays).  Sample data (``SlotCheckpoint.x_rows``,
``SampleResult.x0``) are torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.sampler import SamplerConfig
from repro_torch.sampling import SamplerPlan


@dataclasses.dataclass
class SlotCheckpoint:
    """A resident slot's full trajectory state at step ``k``.

    ``(x_t rows, k, eps-history rows)`` determine the rest of a
    trajectory, so a checkpoint restored into a like engine resumes the
    run exactly; for eta=0 order-1 the resumed output equals the
    uninterrupted one bit for bit.  ``x_rows`` is the slot's
    (rows_per_slot, 256) tile block in the engine's dtype, ``hist_rows``
    the matching (max_order-1, rows_per_slot, 256) float32 eps-history
    block (None on history-free engines).  With ``k = 0`` it hands the
    engine an x_T of the caller's choosing.
    """

    request_id: int
    k: int                             # next step index to run (0..S-1)
    x_rows: torch.Tensor               # slot-tile rows, engine dtype
    hist_rows: Optional[torch.Tensor]  # eps-history rows (fp32) or None
    previews: int = 0                  # previews already streamed
    pool_id: Optional[int] = None      # pool that took the snapshot
    taken_t: Optional[float] = None    # caller-clock snapshot time


@dataclasses.dataclass
class SampleRequest:
    """One sampling job for the continuous-batching engine."""

    request_id: int
    S: int = 50                        # per-request step budget (dim tau)
    eta: float = 0.0                   # 0 = DDIM, 1 = DDPM (Eq. 16)
    tau_kind: str = "linear"           # per-request sub-sequence spacing
    sigma_hat: bool = False            # over-dispersed DDPM variant
    plan: Optional[SamplerPlan] = None  # full per-request trajectory plan;
    #                                     overrides the scalar knobs above
    auto_plan: bool = False            # plan from the engine's PlanBank,
    #                                     picked at admission
    seed: int = 0                      # x_T + noise-stream seed
    deadline: Optional[float] = None   # absolute completion deadline
    preview_every: int = 0             # stream x0-previews every k ticks
    on_preview: Optional[Callable] = None  # f(request_id, step_k, x0)
    submit_t: Optional[float] = None   # stamped by the admission queue
    affinity_key: Optional[int] = None  # fleet routing: requests sharing a
    #                                     key prefer the same slot pool
    model: Optional[str] = None        # multi-model routing: pools serving
    #                                     this checkpoint only (None = any)
    trace: Optional[object] = None     # obs.TraceContext, or None
    resume: Optional[SlotCheckpoint] = None  # mid-trajectory restore:
    #                                     the admitting engine writes the
    #                                     checkpoint's rows instead of
    #                                     drawing x_T and continues from
    #                                     step k; cleared at admission

    @property
    def stochastic(self) -> bool:
        if self.plan is not None:
            return self.plan.stochastic
        return self.eta > 0.0 or self.sigma_hat

    @property
    def steps(self) -> int:
        """The step budget actually executed (plan-aware S)."""
        return self.plan.S if self.plan is not None else self.S

    @property
    def order(self) -> int:
        return self.plan.order if self.plan is not None else 1

    @property
    def eta_label(self) -> float:
        """Scalar eta for result bookkeeping (NaN for non-scalar specs)."""
        if self.plan is None:
            return self.eta
        return (self.plan.sigma.eta if self.plan.sigma.kind == "eta"
                else float("nan"))

    def sampler_config(self, clip_x0: Optional[float] = None
                       ) -> SamplerConfig:
        """The equivalent whole-trajectory config (engine-level clip_x0)."""
        return SamplerConfig(S=self.S, eta=self.eta, tau_kind=self.tau_kind,
                             sigma_hat=self.sigma_hat, clip_x0=clip_x0)

    def resolved_plan(self, schedule, clip_x0: Optional[float] = None
                      ) -> SamplerPlan:
        """The plan this request executes on the given engine schedule."""
        if self.plan is not None:
            return self.plan
        return self.sampler_config(clip_x0).to_plan(schedule)


@dataclasses.dataclass
class SampleResult:
    """Completed (or dropped) request with latency accounting.

    ``queue_wait_s + service_s == latency_s`` for every result: completed
    requests split at ``admit_t``; requests dropped before admission count
    their whole life as queue wait.
    """

    request_id: int
    x0: Optional[torch.Tensor]         # None iff dropped before running
    S: Optional[int]
    eta: float
    submit_t: float
    admit_t: Optional[float]           # None iff never admitted
    finish_t: float
    previews: int = 0
    deadline_missed: bool = False      # finished (or dropped) past deadline
    dropped: bool = False              # never ran: expired or refused
    deadline_headroom_s: Optional[float] = None   # deadline - admit time
    auto_plan: bool = False
    pool_id: Optional[int] = None
    quality: Optional[Dict] = None     # device-probe summary (frames,
    #                                     eps_rms_last, finite_frac_min,
    #                                     defect_max, defect_mean) when the
    #                                     engine ran with probes on

    @classmethod
    def drop(cls, req: SampleRequest, now: float, *, missed: bool = True,
             pool_id: Optional[int] = None) -> "SampleResult":
        """The result record for a request that never ran."""
        steps = (None if req.auto_plan and req.plan is None else req.steps)
        return cls(request_id=req.request_id, x0=None, S=steps,
                   eta=req.eta_label, submit_t=req.submit_t, admit_t=None,
                   finish_t=now, deadline_missed=missed, dropped=True,
                   auto_plan=req.auto_plan, pool_id=pool_id)

    @property
    def nfe(self) -> Optional[int]:
        """NFE of the plan actually executed (alias of ``S``)."""
        return self.S

    @property
    def queue_wait_s(self) -> float:
        start = self.admit_t if self.admit_t is not None else self.finish_t
        return start - self.submit_t

    @property
    def service_s(self) -> float:
        return (self.finish_t - self.admit_t
                if self.admit_t is not None else 0.0)

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.submit_t
