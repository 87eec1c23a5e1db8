"""PoolSupervisor — circuit-breaking fleet tick with checkpoint/migrate
(port of ``repro/serving/resilience/supervisor.py``).

Drop-in replacement for ``PoolFleet.tick`` (the gateway pumps through it
when built with ``supervise=True``): with no faults and no injector it
performs the exact same dispatch + per-pool tick sequence, so supervised
and unsupervised cores are behaviorally identical on the happy path.
What it adds around each pool's tick:

* **containment** — a tick exception (any BaseException: device faults
  do not subclass Exception) is caught and RE-RECORDED as a quarantine
  of the offending pool only; the other pools keep ticking and the
  gateway's pump never sees the fault, so the bridge is never poisoned.
* **migration** — the quarantined pool's locally queued work AND its
  evicted residents re-enter the global EDF queue with their submit
  stamps preserved (``AdmissionQueue.requeue``); residents carry their
  latest :class:`SlotCheckpoint` as ``req.resume`` so the next pool
  refills the trajectory mid-flight (bit-identical for eta=0 order-1 —
  the chaos replay's migration gate). A resident with no snapshot yet
  restarts from step 0: the deterministic process makes that exact too,
  just slower.
* **circuit breaker** per pool: quarantine trips OPEN with exponential
  backoff (``backoff_pumps * backoff_factor**(trips-1)``, capped); after
  the backoff the pool is restored HALF_OPEN (routable as a probe) and
  CLOSED again after ``probe_ticks`` clean busy ticks. Each trip decays
  the pool's router health score; each clean tick recovers it.
* **checkpoint sweep** — every ``checkpoint_every`` busy ticks, every
  resident slot is snapshotted into the :class:`CheckpointStore`
  (latest-wins); terminal results forget theirs.
* **fault injection** — the optional :class:`FaultInjector` hooks run
  inside the guarded region, so injected faults exercise the identical
  code path an organic fault would. ``injector=None`` (the default)
  costs one host-side test per tick.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional

from repro_torch.obs import Observability
from repro_torch.serving.fleet import PoolFleet, PoolState
from repro_torch.serving.scheduler.request import SampleResult

from .checkpoint import CheckpointStore
from .faults import FaultInjector


class BreakerState(enum.Enum):
    CLOSED = "closed"          # healthy: ticks run normally
    OPEN = "open"              # quarantined: backing off
    HALF_OPEN = "half-open"    # probing: routable, trust pending


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Circuit-breaker tuning (docs/resilience.md)."""

    backoff_pumps: int = 4         # first trip's re-admission delay
    backoff_factor: float = 2.0    # growth per consecutive trip
    max_backoff_pumps: int = 64    # backoff cap
    probe_ticks: int = 2           # clean busy ticks to close HALF_OPEN
    idle_close_pumps: int = 32     # idle HALF_OPEN passes to close anyway
    health_decay: float = 0.5      # health *= decay per trip
    health_recovery: float = 0.02  # health += recovery per clean tick


@dataclasses.dataclass
class _Breaker:
    state: BreakerState = BreakerState.CLOSED
    trips: int = 0
    reopen_at: int = 0             # pump index when OPEN -> HALF_OPEN
    probe_ok: int = 0              # clean busy ticks while HALF_OPEN
    idle_pumps: int = 0            # idle passes while HALF_OPEN
    last_error: Optional[str] = None


class PoolSupervisor:
    """Circuit-breaking wrapper around one PoolFleet's tick loop."""

    def __init__(self, fleet: PoolFleet,
                 policy: Optional[BreakerPolicy] = None,
                 checkpoint_every: int = 8,
                 injector: Optional[FaultInjector] = None,
                 obs: Optional[Observability] = None):
        self.fleet = fleet
        self.policy = policy if policy is not None else BreakerPolicy()
        self.checkpoint_every = int(checkpoint_every)
        self.injector = injector
        self.checkpoints = CheckpointStore()
        self.obs = obs if obs is not None else fleet.obs
        self._breakers: Dict[int, _Breaker] = {
            p.pool_id: _Breaker() for p in fleet.pools}
        self._pool_ticks: Dict[int, int] = {
            p.pool_id: 0 for p in fleet.pools}
        self._pumps = 0
        self._injected_delay_s = 0.0
        reg = self.obs.registry
        self._c_quarantines = reg.counter(
            "supervisor_quarantines_total",
            "pool quarantines (breaker trips)")
        self._c_requeued = reg.counter(
            "supervisor_requeued_total",
            "queued requests re-routed by quarantines")
        self._c_migrated = reg.counter(
            "supervisor_migrated_total",
            "residents re-routed with a checkpoint attached")
        self._c_restarted = reg.counter(
            "supervisor_restarted_total",
            "residents re-routed without a checkpoint (restart)")
        self._c_probes = reg.counter(
            "supervisor_probes_total",
            "quarantined pools restored for a re-admission probe")
        self._c_closes = reg.counter(
            "supervisor_breaker_closes_total",
            "breakers closed after a successful probe")
        self._c_flight_dumps = reg.counter(
            "supervisor_flight_dumps_total",
            "flight-recorder postmortems dumped on quarantine")

    # ------------------------------------------------------------- breaker
    def breaker(self, pool_id: int) -> _Breaker:
        return self._breakers[pool_id]

    def _backoff(self, trips: int) -> int:
        p = self.policy
        return int(min(p.backoff_pumps * (p.backoff_factor ** (trips - 1)),
                       p.max_backoff_pumps))

    def quarantine(self, pool_id: int, exc: BaseException,
                   now: float) -> None:
        """Trip one pool out of service and migrate its work.

        Containment order matters: quarantine the pool first (no new
        routing), then hand back its locally queued work, then evict the
        residents — each re-enters the GLOBAL queue via ``requeue`` so
        its submit stamp (and EDF position) survives the detour.
        """
        pool = self.fleet.pools[pool_id]
        br = self._breakers[pool_id]
        br.trips += 1
        br.state = BreakerState.OPEN
        br.reopen_at = self._pumps + self._backoff(br.trips)
        br.probe_ok = 0
        br.idle_pumps = 0
        br.last_error = repr(exc)
        pool.health = max(pool.health * self.policy.health_decay, 1e-3)
        self._c_quarantines.inc()
        # postmortem FIRST, while the ring still maps slots to the
        # residents being evicted below (obs/flight.py): the dump names
        # the (pool, slot, step) the recorded probe frames incriminate
        flight = getattr(pool.engine, "flight", None)
        if flight is not None:
            path = flight.dump("quarantine", error=repr(exc),
                               trips=br.trips, pump=self._pumps)
            if path is not None:
                self._c_flight_dumps.inc()
        pending = pool.quarantine()
        for r in pending:
            self._c_requeued.inc()
            if r.trace is not None:
                r.trace.emit("requeue", now, reason="quarantine")
            self.fleet.queue.requeue(r, now)
        for r in pool.engine.evict_residents():
            ck = self.checkpoints.latest(r.request_id)
            r.resume = ck
            if ck is not None:
                self._c_migrated.inc()
            else:
                self._c_restarted.inc()
            if r.trace is not None:
                r.trace.emit("requeue", now, reason="quarantine",
                             resumed=ck is not None)
            self.fleet.queue.requeue(r, now)

    def _probe_reopen(self) -> None:
        for pid, br in self._breakers.items():
            if (br.state is BreakerState.OPEN
                    and self._pumps >= br.reopen_at):
                br.state = BreakerState.HALF_OPEN
                br.probe_ok = 0
                br.idle_pumps = 0
                self.fleet.restore_pool(pid)
                self._c_probes.inc()

    def _record_clean_tick(self, pool, br: _Breaker) -> None:
        pool.health = min(1.0, pool.health + self.policy.health_recovery)
        if br.state is BreakerState.HALF_OPEN:
            br.probe_ok += 1
            if br.probe_ok >= self.policy.probe_ticks:
                br.state = BreakerState.CLOSED
                self._c_closes.inc()

    # ---------------------------------------------------------------- loop
    def tick(self, now: Optional[float] = None) -> List[SampleResult]:
        """One supervised fleet round (the gateway pump's engine step).

        Same shape as ``PoolFleet.tick``: dispatch from the global EDF
        queue, then advance every busy pool — but each pool's tick runs
        inside the breaker guard, and OPEN pools are skipped entirely
        until their backoff elapses.
        """
        wall = now is None
        t = time.perf_counter() if wall else now
        self._pumps += 1
        self._probe_reopen()
        results = self.fleet.dispatch(t)
        for r in results:                       # queue-tier drops
            self.checkpoints.forget(r.request_id)
        sweep = self.checkpoint_every > 0
        for pool in self.fleet.pools:
            pid = pool.pool_id
            br = self._breakers[pid]
            if br.state is BreakerState.OPEN:
                continue                        # backing off: no ticks
            if not pool.busy:
                pool.tick(now)                  # lifecycle only (no-op)
                if br.state is BreakerState.HALF_OPEN:
                    br.idle_pumps += 1
                    if br.idle_pumps >= self.policy.idle_close_pumps:
                        br.state = BreakerState.CLOSED
                        self._c_closes.inc()
                continue
            n = self._pool_ticks[pid]
            try:
                if self.injector is not None:
                    self.injector.before_tick(pid, n)
                rs = pool.tick(None if wall else now)
                if self.injector is not None:
                    self._injected_delay_s += self.injector.after_tick(
                        pid, n, pool.engine)
            except BaseException as e:
                # re-record the fault as a quarantine: blast radius is
                # THIS pool only — the loop moves on to the next one
                self._pool_ticks[pid] = n + 1
                self.quarantine(pid, e, t)
                continue
            self._pool_ticks[pid] = n + 1
            self._record_clean_tick(pool, br)
            for r in rs:
                self.checkpoints.forget(r.request_id)
            results.extend(rs)
            if sweep and (n + 1) % self.checkpoint_every == 0:
                for ck in pool.engine.snapshot_slots(t):
                    self.checkpoints.put(ck)
        return results

    # ----------------------------------------------------------- telemetry
    def take_injected_delay(self) -> float:
        """Drain accumulated injected latency (virtual-clock replays add
        it to their clock so ``tick-latency`` faults cost virtual time)."""
        d = self._injected_delay_s
        self._injected_delay_s = 0.0
        return d

    @property
    def quarantined_pools(self) -> List[int]:
        return [p.pool_id for p in self.fleet.pools
                if p.state is PoolState.QUARANTINED]

    @property
    def degraded(self) -> bool:
        """Any breaker not CLOSED (healthz surfaces this)."""
        return any(b.state is not BreakerState.CLOSED
                   for b in self._breakers.values())

    def stats(self) -> Dict:
        return {
            "pumps": self._pumps,
            "quarantines": int(self._c_quarantines.value),
            "requeued": int(self._c_requeued.value),
            "migrated": int(self._c_migrated.value),
            "restarted": int(self._c_restarted.value),
            "probes": int(self._c_probes.value),
            "breaker_closes": int(self._c_closes.value),
            "flight_dumps": int(self._c_flight_dumps.value),
            "checkpoints_taken": self.checkpoints.taken,
            "checkpoints_held": len(self.checkpoints),
            "injected_faults": (self.injector.fired()
                                if self.injector is not None else 0),
            "breakers": {
                pid: {"state": br.state.value, "trips": br.trips,
                      "health": self.fleet.pools[pid].health,
                      "reopen_in": max(br.reopen_at - self._pumps, 0)
                      if br.state is BreakerState.OPEN else 0,
                      "last_error": br.last_error}
                for pid, br in self._breakers.items()},
        }
