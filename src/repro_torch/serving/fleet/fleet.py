"""PoolFleet: N slot pools behind one admission tier (port of
``repro/serving/fleet/fleet.py``).

* **Global EDF queue.** Requests land in one earliest-deadline-first
  admission queue; the fleet moves a request to a pool only when that
  pool can take it (a free slot not already spoken for), so deadline
  order is decided globally.
* **Routing** (``router.py``): affinity key first (sticky,
  deterministic), else least-loaded by per-pool tick-EWMA-weighted
  backlog.
* **Per-pool deadline-aware admission.** ``auto_plan`` bank selection
  runs at the DESTINATION pool's local pop with that pool's tick EWMA.
* **Drain / refill.** ``drain_pool`` re-routes queued work through the
  global queue (submit stamps kept), residents finish in place, the pool
  parks STOPPED; ``restore_pool`` makes it routable again.  Weight
  hot-swap (``SlotPool.install``) happens behind this.
* **Aggregated stats** and one Prometheus snapshot over every registry.

Pools must be capability-homogeneous (same schedule, shape, clip,
stochasticity, max_order, dtype).  Pools on one device share it and tick
in turn; ``build(meshes=)`` gives pool i its own mesh (``launch/mesh.py``:
``make_fleet_mesh`` splits the devices into disjoint pool meshes) and a
factory eps places that pool's weights there (``sharded.py``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.schedules import NoiseSchedule
from repro_torch.obs import Observability
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.registry import render_prometheus as _render_prom
from repro_torch.serving.errors import RejectCode, RequestError
from repro_torch.serving.scheduler import ContinuousBatchingEngine
from repro_torch.serving.scheduler.queue import AdmissionQueue
from repro_torch.serving.scheduler.request import SampleRequest, SampleResult

from .pool import PoolState, SlotPool
from .router import pick_pool


class PoolFleet:
    """N slot pools, one global EDF admission tier.

    Telemetry: the fleet's ``Observability`` registry backs the fleet-tier
    counters and the global queue's instruments; every pool engine keeps
    its OWN registry (merged with pool labels at ``render_prometheus``)
    but shares the fleet's TRACER, so a request's span flows submit ->
    route -> (pool) admit -> retire through one sink set.
    ``PoolFleet.build(obs=...)`` wires both.
    """

    def __init__(self, pools: Sequence[SlotPool],
                 max_queue: Optional[int] = None,
                 obs: Optional[Observability] = None):
        if not pools:
            raise ValueError("a fleet needs at least one pool")
        self.pools = list(pools)
        ref = self.pools[0].engine
        for p in self.pools[1:]:
            e = p.engine
            same = (e.schedule is ref.schedule
                    and e.shape == ref.shape and e.dtype == ref.dtype
                    and e.stochastic == ref.stochastic
                    and e.clip_x0 == ref.clip_x0
                    and e.max_order == ref.max_order)
            if not same:
                raise ValueError(
                    f"pool {p.pool_id} differs from pool "
                    f"{self.pools[0].pool_id} in serving capabilities "
                    "(schedule/shape/dtype/stochastic/clip/max_order); "
                    "fleet pools must be homogeneous")
        self.obs = obs if obs is not None else Observability()
        self.queue = AdmissionQueue(max_queue, obs=self.obs)
        reg = self.obs.registry
        self._c_dropped = reg.counter(
            "fleet_dropped_total", "requests dropped at the fleet tier")
        self._c_drained = reg.counter(
            "fleet_drained_total", "queued requests re-routed by drains")

    # ------------------------------------------------------- construction
    @classmethod
    def build(cls, schedule: NoiseSchedule, eps_fn, sample_shape,
              *, n_pools: int, slots: int, meshes: Optional[Sequence] = None,
              max_queue: Optional[int] = None,
              obs: Optional[Observability] = None,
              flight_dir: Optional[str] = None, flight_capacity: int = 64,
              **engine_kw) -> "PoolFleet":
        """Build n_pools homogeneous pools over one model.

        ``eps_fn`` is a plain eps callable shared by every pool, or a
        FACTORY ``f(pool_id, mesh) -> eps_fn`` (the sharded-trunk path:
        each pool places its weights on its own mesh — see
        ``serving.fleet.sharded`` and ``launch.mesh.make_fleet_mesh``).
        ``meshes`` gives pool i its mesh (None entries = unsharded).
        ``obs`` becomes the fleet's telemetry handle; each pool engine gets
        ``obs.child()`` (private registry, SHARED tracer).  ``engine_kw``
        goes to every engine, ``device=`` included (default: the card; a
        mesh pool runs on its mesh's first device).  With ``probes=`` each
        pool engine also gets its own FlightRecorder (postmortems under
        ``flight_dir``, in memory only when None).
        """
        if meshes is not None and len(meshes) != n_pools:
            raise ValueError(f"got {len(meshes)} meshes for {n_pools} "
                             "pools")
        meshes = list(meshes) if meshes is not None else [None] * n_pools
        factory = _is_factory(eps_fn)
        obs = obs if obs is not None else Observability()
        probed = engine_kw.get("probes") not in (None, False)
        pools = []
        for pid in range(n_pools):
            fn = eps_fn(pid, meshes[pid]) if factory else eps_fn
            flight = (FlightRecorder(flight_capacity, pool_id=pid,
                                     out_dir=flight_dir)
                      if probed else None)
            eng = ContinuousBatchingEngine(
                schedule, fn, sample_shape, slots, mesh=meshes[pid],
                pool_id=pid, obs=obs.child(), flight=flight, **engine_kw)
            pools.append(SlotPool(pid, eng))
        return cls(pools, max_queue=max_queue, obs=obs)

    # ---------------------------------------------------------- admission
    def _validation_pool(self, req: SampleRequest):
        """The pool whose capability check stands for ``req``.

        Single-model requests (model=None) validate against pool 0 —
        pools are capability-homogeneous. A model-routed request must
        validate against (and later be dispatched to) a pool actually
        serving that checkpoint; an unknown model is a typed 404 at the
        front door.
        """
        model = getattr(req, "model", None)
        if model is None:
            return self.pools[0]
        for p in self.pools:
            if p.model == model:
                return p
        raise RequestError(
            RejectCode.UNKNOWN_MODEL,
            f"request {req.request_id}: no resident pool serves model "
            f"'{model}' (resident: "
            f"{sorted({p.model for p in self.pools if p.model})})")

    def submit(self, req: SampleRequest,
               now: Optional[float] = None) -> bool:
        """Enqueue into the global EDF queue; False = back-pressure."""
        self._validation_pool(req).engine.validate_request(req)
        model = getattr(req, "model", None)
        eligible = [p for p in self.pools
                    if model is None or p.model == model]
        if eligible and all(p.state is PoolState.QUARANTINED
                            for p in eligible):
            # every pool that could serve this request is tripped out:
            # refuse now so the client backs off (draining pools do not
            # trigger this; a rollout restores them shortly)
            raise RequestError(
                RejectCode.MODEL_UNAVAILABLE,
                f"request {req.request_id}: every pool serving "
                f"{'model ' + repr(model) if model else 'this fleet'} "
                "is quarantined — retry after the breaker re-admits one")
        now = time.perf_counter() if now is None else now
        self.obs.trace_submit(req, now, deadline=req.deadline)
        return self.queue.submit(req, now)

    def cancel(self, request_id,
               now: Optional[float] = None) -> bool:
        """Client-initiated cancellation anywhere in the fleet: remove
        the request from the global queue, or free its slot / local
        queue entry on whichever pool holds it. Terminal ``cancel`` span
        either way; False when the request is not in flight here."""
        now = time.perf_counter() if now is None else now
        removed = self.queue.remove_if(
            lambda r: r.request_id == request_id)
        if removed:
            for r in removed:
                if r.trace is not None:
                    r.trace.emit("cancel", now)
            self.obs.registry.counter(
                "fleet_cancelled_total",
                "requests cancelled out of the global queue").inc()
            return True
        return any(p.engine.cancel(request_id, now=now)
                   for p in self.pools)

    # --------------------------------------------- fleet-tier counter views
    @property
    def dropped(self) -> int:
        """Requests dropped at the FLEET tier (pool drops are separate)."""
        return int(self._c_dropped.value)

    @property
    def drained_requests(self) -> int:
        """Queued requests re-routed through the global queue by drains."""
        return int(self._c_drained.value)

    def dispatch(self, now: float) -> List[SampleResult]:
        """Move queued requests to pools while capacity exists.

        Pops in global EDF order; expired requests drop here (never
        spending a slot anywhere). auto_plan selection does NOT happen at
        this tier — the destination pool fills the plan at its own
        admission with its own tick EWMA.
        """
        results: List[SampleResult] = []
        deferred: List[SampleRequest] = []
        while len(self.queue) and any(p.capacity > 0 for p in self.pools):
            req, missed = self.queue.pop(now)
            for m in missed:
                self._c_dropped.inc()
                if m.trace is not None:
                    m.trace.emit("drop", now, reason="expired")
                results.append(SampleResult.drop(m, now))
            if req is None:
                break
            pool, why = pick_pool(self.pools, req, explain=True)
            if pool is None:
                # no ELIGIBLE pool has capacity (raced out, or every pool
                # serving this request's model is busy/draining). Set the
                # request aside and keep popping: one model's backlog must
                # not head-of-line-block another model's dispatchable work
                # behind it in the global EDF order. Per model the EDF
                # order is preserved — capacity only shrinks within one
                # dispatch round, so later same-model pops defer too.
                deferred.append(req)
                continue
            self.obs.registry.counter(
                "fleet_routed_total", "dispatches by routing decision",
                reason=why).inc()
            if req.trace is not None:
                req.trace.pool_id = pool.pool_id
                req.trace.emit("route", now, reason=why)
            pool.dispatch(req, now)
        for req in deferred:      # back into the global queue, stamps kept
            self.queue.requeue(req, now)
        return results

    # --------------------------------------------------------------- loop
    @property
    def active(self) -> int:
        return sum(p.engine.active for p in self.pools)

    @property
    def busy(self) -> bool:
        return len(self.queue) > 0 or any(p.busy for p in self.pools)

    def tick(self, now: Optional[float] = None) -> List[SampleResult]:
        """One fleet round: dispatch, then advance every busy pool."""
        wall = now is None
        t = time.perf_counter() if wall else now
        results = self.dispatch(t)
        for p in self.pools:
            results.extend(p.tick(None if wall else now))
        return results

    def run(self, max_ticks: Optional[int] = None,
            now_fn: Optional[Callable[[], float]] = None
            ) -> List[SampleResult]:
        """Tick until the global queue and every pool drain."""
        results: List[SampleResult] = []
        n = 0
        while self.busy:
            if max_ticks is not None and n >= max_ticks:
                break
            results.extend(self.tick(now_fn() if now_fn else None))
            n += 1
        return results

    def serve(self, requests: Sequence[SampleRequest],
              now: Optional[float] = None) -> List[SampleResult]:
        """Submit a request list and drain the fleet (one-call entry)."""
        results: List[SampleResult] = []
        for r in requests:
            if not self.submit(r, now=now):
                t = time.perf_counter() if now is None else now
                r.submit_t = t if r.submit_t is None else r.submit_t
                self._c_dropped.inc()
                results.append(SampleResult.drop(r, t, missed=False))
        results.extend(self.run())
        return results

    # ---------------------------------------------------- pool lifecycle
    def drain_pool(self, pool_id: int,
                   now: Optional[float] = None) -> int:
        """Gracefully drain one pool; returns how many queued requests
        were re-routed through the global queue."""
        now = time.perf_counter() if now is None else now
        pending = self.pools[pool_id].drain()
        for r in pending:
            if r.trace is not None:      # segment reset: may route again
                r.trace.emit("requeue", now, reason="drain")
            self.queue.requeue(r, now)   # a re-route, not a new arrival
        self._c_drained.inc(len(pending))
        return len(pending)

    def restore_pool(self, pool_id: int) -> None:
        """Refill path: make a drained/stopped pool routable again."""
        self.pools[pool_id].restore()

    # ------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        """Fleet-wide counter reset: delegate to every pool's engine and
        zero the fleet-tier aggregates (drops, drains, routing counters).
        Same keeps as the engine's reset: compiled-trace counts, tick
        EWMAs, and queue arrival counters survive — warm-up state the
        selection policy and routing still need."""
        for p in self.pools:
            p.reset_stats()
        for inst in self.obs.registry.instruments():
            if inst.name.startswith("fleet_"):
                inst.reset()

    def stats(self) -> Dict:
        per_pool = [p.stats() for p in self.pools]
        ticks = sum(s["ticks"] for s in per_pool)
        slot_steps = sum(s["slot_steps"] for s in per_pool)
        cap = sum(s["ticks"] * s["slots"] for s in per_pool)
        mega = sum(s["ticks"] for s in per_pool if s["mega_tick"])
        return {
            "n_pools": len(self.pools),
            "queued": len(self.queue),
            "queue_rejected": self.queue.rejected,
            "completed": sum(s["completed"] for s in per_pool),
            "dropped": self.dropped + sum(s["dropped"] for s in per_pool),
            "drained_requests": self.drained_requests,
            "ticks": ticks,
            "slot_steps": slot_steps,
            "occupancy": slot_steps / max(cap, 1),
            "mega_tick_ratio": mega / max(ticks, 1),
            "tick_ewma_s": {s["pool_id"]: s["tick_ewma_s"]
                            for s in per_pool},
            "pools": per_pool,
        }

    def render_prometheus(self) -> str:
        """One Prometheus text snapshot over the whole fleet: the fleet
        tier's registry plus every pool engine's, the latter labeled
        ``{pool="<id>"}`` at render time (engines never relabel)."""
        parts = [(self.obs.registry, {"tier": "fleet"})]
        parts += [(p.engine.obs.registry, {"pool": p.pool_id})
                  for p in self.pools]
        return _render_prom(parts)


def _is_factory(fn) -> bool:
    """An eps argument is a pool factory iff it takes (pool_id, mesh)."""
    import inspect
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    names = [p for p in params.values()
             if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(names) == 2 and names[0].name in ("pool_id", "pid")
