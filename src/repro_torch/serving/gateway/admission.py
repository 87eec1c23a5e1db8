"""Overload control — shed doomed work BEFORE it consumes ticks (port of
``repro/serving/gateway/admission.py``, the same policy).

Under overload the worst policy is the default one: let every request
into a slot and discover at retirement that half of them missed their
deadlines — each miss having burned S network evaluations another
request needed. The gateway instead sweeps the global admission queue
every pump, ahead of dispatch, and removes requests that should not run:

* **Infeasible** (``SHED_INFEASIBLE``) — a deadlined request whose
  remaining headroom cannot fit its step budget at the fleet's measured
  tick latency (``steps * tick_s * margin > deadline - now``). It WILL
  miss; shedding it now converts a wasted slot residency into capacity
  for requests that can still make it. ``auto_plan`` requests are exempt
  — their plan-bank admission degrades NFE to fit the deadline instead
  (a better answer than refusing), so the policy never pre-empts it.
* **Depth** (``SHED_OVERLOAD``) — when the queue is deeper than
  ``shed_depth``, the LOWEST-headroom deadlined requests are evicted
  first until the queue fits. Rationale: with the queue this deep the
  earliest deadlines are the ones that will be missed; the requests with
  the most slack are the ones worth keeping. Deadline-free requests are
  shed last (most recent arrival first — they have waited the least).

Both classes return victims sorted lowest-headroom-first (the order the
gateway's ``shed_log`` records), and every shed emits a terminal ``drop``
span (reason="shed") plus a ``gateway_shed_total{code=...}`` counter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.serving.errors import RejectCode


def _headroom(req, now: float) -> float:
    return (req.deadline - now) if req.deadline is not None else math.inf


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """The gateway's shed policy (docs/gateway.md has the full walkthrough).

    shed_depth: global-queue depth above which the lowest-headroom
      deadlined requests are evicted until the depth fits (None =
      no depth shedding; the queue's own ``max_queue`` bound still
      rejects at submit).
    margin: safety factor on the feasibility test — a request is doomed
      when ``steps * tick_s * margin > headroom``. margin > 1 sheds
      earlier (pessimistic), < 1 later; 0 disables feasibility shedding.
    """

    shed_depth: Optional[int] = None
    margin: float = 1.0

    def plan_shed(self, pending: Sequence, now: float,
                  tick_s: Optional[float]
                  ) -> List[Tuple[object, RejectCode]]:
        """Which queued requests to shed, lowest headroom first.

        ``pending`` is the queue's EDF-ordered snapshot; ``tick_s`` the
        fleet's measured per-tick latency (None before the first steady
        tick — feasibility shedding waits for a measurement rather than
        guess). Pure function: the caller (GatewayCore._shed) performs
        the actual queue removal and telemetry.
        """
        shed: List[Tuple[object, RejectCode]] = []
        kept = []
        for r in pending:
            if (self.margin > 0.0 and tick_s is not None
                    and r.deadline is not None and not r.auto_plan
                    and r.steps * tick_s * self.margin > _headroom(r, now)):
                shed.append((r, RejectCode.SHED_INFEASIBLE))
            else:
                kept.append(r)
        if self.shed_depth is not None and len(kept) > self.shed_depth:
            over = len(kept) - self.shed_depth
            deadlined = sorted((r for r in kept if r.deadline is not None),
                               key=lambda r: r.deadline)
            victims = deadlined[:over]
            if len(victims) < over:
                free = [r for r in kept if r.deadline is None]
                free.sort(key=lambda r: (r.submit_t if r.submit_t
                                         is not None else now),
                          reverse=True)     # newest deadline-free first
                victims += free[:over - len(victims)]
            shed += [(r, RejectCode.SHED_OVERLOAD) for r in victims]
        shed.sort(key=lambda rc: _headroom(rc[0], now))
        return shed
