"""SlotPool: one continuous-batching engine as a fleet backend (port of
``repro/serving/fleet/pool.py``).

The pool owns LIFECYCLE (active / draining / stopped / quarantined) and
load telemetry; the wrapped :class:`ContinuousBatchingEngine` owns the
hot loop.  A pool never changes how the engine computes: drain only stops
NEW work from being routed here, and residents finish on their own
trajectories.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

from repro_torch.serving.scheduler import ContinuousBatchingEngine
from repro_torch.serving.scheduler.request import (SampleRequest,
                                                  SampleResult)


class PoolState(enum.Enum):
    ACTIVE = "active"        # routable: accepts dispatches
    DRAINING = "draining"    # finishing residents; accepts nothing new
    STOPPED = "stopped"      # drained dry; engine idle (weights resident)
    QUARANTINED = "quarantined"  # tripped by a tick fault; residents
    #                              evicted, re-admitted only by restore()


class SlotPool:
    """Lifecycle + telemetry wrapper around one engine (one slot pool).

    ``drain()`` stops new routing and hands queued work back, residents
    finish in place and the pool parks STOPPED; ``install(params)``
    hot-swaps the engine's weights on a STOPPED pool (the only state where
    no resident can observe the swap mid-trajectory); ``restore()`` makes
    it routable again.  A rolling weight rollout is drain -> install ->
    restore per pool.

    ``model`` names the resident checkpoint this pool serves (multi-model
    fleets route ``SampleRequest.model`` to matching pools); None = the
    anonymous single-model fleet.
    """

    def __init__(self, pool_id: int, engine: ContinuousBatchingEngine,
                 model: Optional[str] = None):
        engine.pool_id = pool_id
        self.pool_id = pool_id
        self.engine = engine
        self.model = model
        self.state = PoolState.ACTIVE
        self.drained_requests = 0     # queued work handed back at drain
        self.health = 1.0             # router weight in (0, 1]; a pool
        #                               supervisor would lower it after
        #                               faults (an unsupervised fleet stays
        #                               at 1.0)

    # -------------------------------------------------------------- load
    @property
    def accepting(self) -> bool:
        return self.state is PoolState.ACTIVE

    @property
    def capacity(self) -> int:
        """Dispatchable headroom (free slots minus already-queued work)."""
        return self.engine.capacity if self.accepting else 0

    @property
    def busy(self) -> bool:
        return self.engine.active > 0 or len(self.engine.queue) > 0

    @property
    def tick_ewma_s(self) -> Optional[float]:
        return self.engine.tick_ewma_s

    def load_eta_s(self, default_tick_s: float = 0.0) -> float:
        """Estimated seconds to absorb this pool's backlog — the
        least-loaded router's ranking key: remaining resident + queued
        steps, spread over the pool's slots, at the pool's measured
        tick EWMA (``default_tick_s`` before the first measurement)."""
        tick = (self.tick_ewma_s if self.tick_ewma_s is not None
                else default_tick_s)
        backlog_ticks = self.engine.pending_steps() / max(
            self.engine.slots, 1)
        return backlog_ticks * tick

    # --------------------------------------------------------- lifecycle
    def dispatch(self, req: SampleRequest, now: float) -> bool:
        """Route one request into this pool's local admission queue."""
        if not self.accepting:
            raise RuntimeError(
                f"pool {self.pool_id} is {self.state.value}; the router "
                "must not dispatch to a non-active pool")
        return self.engine.submit(req, now=now)

    def drain(self) -> List[SampleRequest]:
        """Begin graceful drain: stop accepting, hand back queued work.

        Resident requests keep ticking to completion (their state lives
        in this pool's slot tile); un-admitted queued requests are
        returned for re-routing. The pool parks at STOPPED once dry.
        """
        self.state = PoolState.DRAINING
        pending = self.engine.queue.drain_pending()
        self.drained_requests += len(pending)
        self._maybe_stop()
        return pending

    def quarantine(self) -> List[SampleRequest]:
        """Trip this pool out of service after a tick fault: stop
        accepting and hand back locally queued work (the caller re-routes
        it and any evicted residents).  Unlike ``drain``, a quarantined
        pool never parks STOPPED on its own: only ``restore`` re-admits
        it."""
        self.state = PoolState.QUARANTINED
        pending = self.engine.queue.drain_pending()
        self.drained_requests += len(pending)
        return pending

    def restore(self) -> None:
        """Reactivate a draining/stopped/quarantined pool (routable
        again)."""
        self.state = PoolState.ACTIVE

    def install(self, params) -> None:
        """Hot-swap this pool's resident weights (idle pools only:
        STOPPED, or QUARANTINED — whose residents were evicted at the
        trip, so the engine is equally idle).

        Delegates to ``engine.install_eps_params`` (same keys, shapes and
        dtypes: the same tick function); the idle gate guarantees no
        in-flight request ever mixes weights: residents admitted before a
        drain finish on the OLD weights, requests routed after the restore
        run on the NEW ones.
        """
        if self.state not in (PoolState.STOPPED, PoolState.QUARANTINED):
            raise RuntimeError(
                f"pool {self.pool_id} is {self.state.value}; weights may "
                "only be installed on a STOPPED (or quarantined) pool "
                "(drain it first so no resident request can straddle "
                "the swap)")
        self.engine.install_eps_params(params)

    def _maybe_stop(self) -> None:
        if self.state is PoolState.DRAINING and not self.busy:
            self.state = PoolState.STOPPED

    # -------------------------------------------------------------- loop
    def tick(self, now: Optional[float] = None) -> List[SampleResult]:
        """Advance the pool one engine tick (no-op when idle)."""
        if not self.busy:
            self._maybe_stop()
            return []
        results = self.engine.tick(now)
        self._maybe_stop()
        return results

    def reset_stats(self) -> None:
        """Zero this pool's throughput telemetry: the engine's instruments
        (keeping compile counts + tick EWMA, see engine.reset_stats) and
        the pool-level drain counter. State/lifecycle is untouched."""
        self.engine.reset_stats()
        self.drained_requests = 0

    @property
    def weight_swaps(self) -> int:
        """Weight installs this pool's engine has absorbed (lifecycle
        telemetry — survives reset_stats like the compile count)."""
        return self.engine.weight_installs

    def stats(self) -> Dict:
        st = self.engine.stats()
        st["state"] = self.state.value
        st["model"] = self.model
        st["health"] = self.health
        st["drained_requests"] = self.drained_requests
        st["pending_steps"] = self.engine.pending_steps()
        st["weight_swaps"] = self.weight_swaps
        return st
