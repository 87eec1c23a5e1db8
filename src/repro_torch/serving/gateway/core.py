"""GatewayCore — the synchronous heart of the serving front door (port of
``repro/serving/gateway/core.py``: the same wire format, events, shedding,
pump order, rolling hot-swap, health and stats).

Everything the HTTP layer does maps onto three calls here, all executed
on ONE thread (the bridge's engine thread — see gateway/bridge.py), so
the fleet, pools, and engines never see concurrent access:

* ``submit(spec, on_event)`` — parse a wire-format request dict into a
  ``SampleRequest``, validate it against the fleet (typed
  ``RequestError`` refusals with HTTP statuses), enqueue it, and
  register the caller's event callback.
* ``pump()`` — one serving round: shed overload victims from the global
  queue (admission.OverloadPolicy — BEFORE dispatch, so doomed work
  never costs a tick), advance the fleet one tick, deliver terminal
  results/drops to their callbacks, and step the rolling weight-swap
  state machine.
* ``hot_swap(model)`` — start a rolling rollout of the model's STAGED
  checkpoint: drain one pool at a time, install on STOPPED (no new tick
  function — see engine.install_eps_params), restore, move to the next;
  promote the registry version when the last pool is done. In-flight
  requests on a draining pool complete on the OLD weights; queued work
  re-routes through the global queue.

Events delivered to ``on_event`` callbacks (invoked on the engine
thread; the HTTP layer trampolines them onto the asyncio loop):

  {"event": "preview", "request_id", "step", "x0"}        (tensor)
  {"event": "result",  "request_id", "x0", "S", "pool_id",
   "latency_s", "queue_wait_s", "service_s",
   "deadline_missed", "previews"}                          (terminal)
  {"event": "error",   "request_id", "code", "message", "status"[,
   "retry_after_s"]}                                       (terminal)

Every request gets EXACTLY one terminal event — except a ``cancel()``ed
request, whose client initiated the teardown and is gone. The x0 payloads
are the engine's tensors, on its device: the transport copies them to
the host and serializes them (``wire_event``, gateway/http.py). The NaN/Inf
guard on terminal results reduces every result of a pump on the device and
reads the flags back in one copy.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.obs import Observability
from repro_torch.obs.registry import render_prometheus as _render_prom
from repro_torch.serving.errors import RejectCode, RequestError
from repro_torch.serving.fleet import PoolFleet, PoolState, SlotPool
from repro_torch.serving.scheduler import (ContinuousBatchingEngine,
                                           SampleRequest)

from .admission import OverloadPolicy
from .registry import ModelRegistry

# wire-format request fields (POST /v1/sample body). "stream" is consumed
# by the HTTP layer but tolerated here so specs can be passed through.
_SPEC_FIELDS = {
    "model": (str, type(None)),
    "S": (int,),
    "eta": (int, float),
    "tau": (str,),
    "seed": (int,),
    "deadline_s": (int, float, type(None)),
    "preview_every": (int,),
    "auto_plan": (bool,),
    "affinity_key": (int, str, type(None)),
    "stream": (bool,),
}
_TAU_KINDS = ("linear", "quadratic")


def parse_spec(spec: Dict, request_id: int, now: float) -> SampleRequest:
    """Wire dict -> SampleRequest; every refusal is a typed BAD_REQUEST."""
    if not isinstance(spec, dict):
        raise RequestError(RejectCode.BAD_REQUEST,
                           "request body must be a JSON object")
    for key, val in spec.items():
        if key not in _SPEC_FIELDS:
            raise RequestError(
                RejectCode.BAD_REQUEST,
                f"unknown request field '{key}' (allowed: "
                f"{sorted(_SPEC_FIELDS)})")
        if not isinstance(val, _SPEC_FIELDS[key]):
            raise RequestError(
                RejectCode.BAD_REQUEST,
                f"field '{key}' must be "
                f"{'/'.join(t.__name__ for t in _SPEC_FIELDS[key])}, "
                f"got {type(val).__name__}")
    tau = spec.get("tau", "linear")
    if tau not in _TAU_KINDS:
        raise RequestError(RejectCode.BAD_REQUEST,
                           f"tau must be one of {_TAU_KINDS}, got '{tau}'")
    deadline_s = spec.get("deadline_s")
    preview_every = spec.get("preview_every", 0)
    if preview_every < 0:
        raise RequestError(RejectCode.BAD_REQUEST,
                           "preview_every must be >= 0")
    affinity = spec.get("affinity_key")
    return SampleRequest(
        request_id=request_id,
        S=spec.get("S", 20),
        eta=float(spec.get("eta", 0.0)),
        tau_kind=tau,
        auto_plan=spec.get("auto_plan", False),
        seed=spec.get("seed", 0),
        deadline=(now + float(deadline_s)
                  if deadline_s is not None else None),
        preview_every=preview_every,
        affinity_key=affinity,
        model=spec.get("model"),
    )


def wire_event(ev: Dict) -> Dict:
    """Event dict -> JSON-serializable payload, the transport's encoding
    (gateway/http.py): x0 copied to the host as float32 and flattened to
    ``{"shape": [...], "data": [floats]}``."""
    out = dict(ev)
    x0 = out.pop("x0", None)
    if x0 is not None:
        arr = x0.detach().float().cpu().numpy()
        out["x0"] = {"shape": list(arr.shape),
                     "data": arr.ravel().tolist()}
    return out


def _all_finite(xs: List[torch.Tensor]) -> List[bool]:
    """Whether each tensor is all finite: one reduction per tensor on its
    device, the flags read back to the host in one copy."""
    if not xs:
        return []
    return torch.stack([torch.isfinite(x).all() for x in xs]).tolist()


class _SwapJob:
    """One rolling weight rollout: the pools still to walk + the pool
    currently draining (None between pools)."""

    __slots__ = ("model", "pending", "current")

    def __init__(self, model: str, pool_ids: List[int]):
        self.model = model
        self.pending = list(pool_ids)
        self.current: Optional[int] = None


class GatewayCore:
    """Front-door state machine over a PoolFleet + ModelRegistry.

    Single-threaded by contract: construct it, then hand it to an
    EngineBridge and interact only through ``bridge.call/acall`` (the
    HTTP layer does). Telemetry: the gateway owns the top-level
    ``Observability``; the fleet and every pool engine run on
    ``obs.child()`` handles — own registries, one shared tracer — merged
    with tier/pool labels in ``render_prometheus``.
    """

    #: bridge survivability bound: how many pump exceptions a SUPERVISED
    #: core absorbs before conceding the bridge is beyond saving (a
    #: supervisor-contained fault never reaches pump, so anything here is
    #: gateway-tier breakage — absorb a few, then fail loud)
    MAX_ABSORBED_PUMP_ERRORS = 8

    def __init__(self, fleet: PoolFleet, registry: ModelRegistry,
                 policy: Optional[OverloadPolicy] = None,
                 obs: Optional[Observability] = None,
                 supervisor=None):
        self.fleet = fleet
        self.registry = registry
        self.policy = policy if policy is not None else OverloadPolicy()
        self.obs = obs if obs is not None else Observability()
        self.supervisor = supervisor     # resilience.PoolSupervisor | None
        self._absorbed = 0               # pump errors absorbed (see above)
        self._ids = itertools.count()
        self._handlers: Dict[int, Callable] = {}
        self._requests: Dict[int, SampleRequest] = {}
        self._swap: Optional[_SwapJob] = None
        self.shed_log: List[Dict] = []   # per-shed audit records (the
        #                                  load bench's ordering oracle)
        reg = self.obs.registry
        self._c_requests = reg.counter(
            "gateway_requests_total", "requests accepted at the front door")
        self._c_previews = reg.counter(
            "gateway_previews_streamed_total",
            "x0 preview events delivered to clients")
        self._c_results = reg.counter(
            "gateway_results_streamed_total",
            "terminal results delivered to clients")
        self._c_expired = reg.counter(
            "gateway_expired_total",
            "queued requests expired before admission")
        self._c_swaps = reg.counter(
            "gateway_swaps_total", "completed weight rollouts")
        self._g_streams = reg.gauge(
            "gateway_streams", "requests with a live event stream")
        self._c_cancelled = reg.counter(
            "gateway_cancelled_total",
            "client-initiated cancellations (disconnects included)")
        self._c_nonfinite = reg.counter(
            "gateway_nonfinite_total",
            "terminal results refused by the NaN/Inf guard")
        self._c_handler_errors = reg.counter(
            "gateway_handler_errors_total",
            "event callbacks dropped after raising")
        self._h_defect = reg.histogram(
            "gateway_request_defect",
            "per-request mean step-doubling defect proxy (probed pools)",
            edges=(0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0))

    # ----------------------------------------------------------- plumbing
    def _sum_counter(self, name: str) -> int:
        return int(sum(i.value for i in self.obs.registry.instruments()
                       if i.name == name))

    def _count_reject(self, code: RejectCode) -> None:
        self.obs.registry.counter(
            "gateway_rejected_total",
            "typed front-door refusals by reject code",
            code=code.value).inc()

    def _dump_flight(self, pool_id: Optional[int], reason: str,
                     **context) -> Optional[str]:
        """Dump pool_id's flight ring (if it has one); returns the path."""
        if pool_id is None or not 0 <= pool_id < len(self.fleet.pools):
            return None
        flight = getattr(self.fleet.pools[pool_id].engine, "flight", None)
        if flight is None:
            return None
        path = flight.dump(reason, **context)
        if path is not None:
            self.obs.registry.counter(
                "gateway_flight_dumps_total",
                "flight-recorder postmortems dumped by the gateway",
                reason=reason).inc()
        return path

    def flight_snapshot(self, pool_id: int) -> Optional[Dict]:
        """In-memory flight-ring view for /v1/debug/flight/{pool}.

        None when the pool doesn't exist or carries no recorder (the
        HTTP layer maps that to a 404).
        """
        if not 0 <= pool_id < len(self.fleet.pools):
            return None
        flight = getattr(self.fleet.pools[pool_id].engine, "flight", None)
        return flight.snapshot() if flight is not None else None

    def _tick_estimate(self) -> Optional[float]:
        known = [p.tick_ewma_s for p in self.fleet.pools
                 if p.tick_ewma_s is not None]
        return (sum(known) / len(known)) if known else None

    def retry_after_s(self) -> int:
        """Back-pressure hint for 429/503 refusals (whole seconds, >= 1):
        the backlog's estimated drain time — resident + queued steps
        spread over the fleet's slots at the measured tick EWMA. Clients
        that honor Retry-After re-arrive roughly when capacity exists
        instead of hammering a saturated front door."""
        tick = self._tick_estimate()
        if tick is None:
            return 1
        pending = sum(p.engine.pending_steps() for p in self.fleet.pools)
        pending += sum(r.steps
                       for r in self.fleet.queue.pending_requests())
        slots = sum(p.engine.slots for p in self.fleet.pools) or 1
        return max(1, math.ceil(pending / slots * tick))

    @property
    def busy(self) -> bool:
        """Whether pump() still has work: fleet activity, undelivered
        streams, or a rollout mid-walk."""
        return (self.fleet.busy or self._swap is not None
                or bool(self._handlers))

    # ---------------------------------------------------------- admission
    def submit(self, spec: Dict, on_event: Callable[[Dict], None],
               now: Optional[float] = None) -> int:
        """Accept one wire-format request; returns its request_id.

        Raises RequestError (typed code + HTTP status) on any refusal —
        unknown field, unknown model, capability mismatch, or the global
        queue's depth bound. On success ``on_event`` will receive zero or
        more previews and exactly one terminal event.
        """
        now = time.perf_counter() if now is None else now
        rid = next(self._ids)
        try:
            req = parse_spec(spec, rid, now)
        except RequestError as e:
            self._count_reject(e.code)
            raise
        if req.preview_every > 0:
            req.on_preview = self._on_preview
        try:
            accepted = self.fleet.submit(req, now=now)
        except RequestError as e:
            self._count_reject(e.code)
            if e.code.http_status in (429, 503):
                # availability refusal: tell the client when to come back
                e.retry_after_s = self.retry_after_s()
            raise
        if not accepted:
            self._count_reject(RejectCode.QUEUE_FULL)
            raise RequestError(
                RejectCode.QUEUE_FULL,
                f"request {rid}: global admission queue at its depth "
                "bound — retry with backoff",
                retry_after_s=self.retry_after_s())
        self._handlers[rid] = on_event
        self._requests[rid] = req
        self._c_requests.inc()
        self._g_streams.set(len(self._handlers))
        return rid

    def _on_preview(self, request_id: int, step: int, x0) -> None:
        h = self._handlers.get(request_id)
        if h is None:
            return
        self._c_previews.inc()
        try:
            h({"event": "preview", "request_id": request_id, "step": step,
               "x0": x0})
        except RuntimeError:
            # a broken callback must not poison the engine thread: drop
            # the handler (the client's stream is already beyond repair)
            # and let the request finish unobserved
            self._c_handler_errors.inc()
            self._handlers.pop(request_id, None)
            self._g_streams.set(len(self._handlers))

    def _terminal(self, request_id: int, event: Dict) -> None:
        h = self._handlers.pop(request_id, None)
        self._requests.pop(request_id, None)
        self._g_streams.set(len(self._handlers))
        if self.supervisor is not None:
            self.supervisor.checkpoints.forget(request_id)
        if h is not None:
            try:
                h(event)
            except RuntimeError:
                self._c_handler_errors.inc()

    # ------------------------------------------------------- cancellation
    def cancel(self, request_id: int,
               now: Optional[float] = None) -> bool:
        """Client-initiated cancellation (the HTTP layer calls this when
        an SSE stream disconnects mid-trajectory): release the event
        handler, free the request wherever it lives — global queue entry,
        pool-local queue entry, or resident slot — and forget its
        checkpoint. Terminal ``cancel`` span from the fleet tier; no
        event is delivered (the client is gone). Returns whether the
        request was still in flight."""
        now = time.perf_counter() if now is None else now
        h = self._handlers.pop(request_id, None)
        self._requests.pop(request_id, None)
        self._g_streams.set(len(self._handlers))
        found = self.fleet.cancel(request_id, now=now)
        if self.supervisor is not None:
            self.supervisor.checkpoints.forget(request_id)
        if h is not None or found:
            self._c_cancelled.inc()
        return h is not None or found

    # ----------------------------------------------------------- overload
    def _shed(self, now: float) -> int:
        """The pre-dispatch overload sweep (see admission.OverloadPolicy):
        remove victims from the global queue, close their spans with a
        terminal ``drop`` (reason="shed"), deliver their error events,
        and append audit records to ``shed_log``."""
        pending = self.fleet.queue.pending_requests()
        if not pending:
            return 0
        plan = self.policy.plan_shed(pending, now, self._tick_estimate())
        if not plan:
            return 0
        victims = {id(r): code for r, code in plan}
        removed = self.fleet.queue.remove_if(lambda r: id(r) in victims)
        kept_deadlines = [r.deadline - now
                          for r in self.fleet.queue.pending_requests()
                          if r.deadline is not None]
        kept_min = min(kept_deadlines) if kept_deadlines else None
        retry_after = self.retry_after_s()
        for req in removed:
            code = victims[id(req)]
            headroom = (req.deadline - now
                        if req.deadline is not None else None)
            self.obs.registry.counter(
                "gateway_shed_total",
                "overload sheds by reject code", code=code.value).inc()
            if req.trace is not None:
                req.trace.emit("drop", now, reason="shed",
                               code=code.value)
            self.shed_log.append({
                "t": now, "request_id": req.request_id,
                "code": code.value, "headroom_s": headroom,
                "kept_min_headroom_s": kept_min,
            })
            self._terminal(req.request_id, {
                "event": "error", "request_id": req.request_id,
                "code": code.value,
                "message": (f"request {req.request_id} shed under "
                            f"overload ({code.value})"),
                "status": code.http_status,
                "retry_after_s": retry_after,
            })
        return len(removed)

    # --------------------------------------------------------------- loop
    def pump(self, now: Optional[float] = None) -> int:
        """One serving round; returns how many terminal events fired.

        Order matters: shed FIRST (victims must never reach dispatch),
        then the fleet tick (dispatch + every pool's engine tick, which
        also fires preview callbacks), then terminal delivery, then the
        swap state machine (drained pools observed after their tick).
        """
        wall = now is None
        t = time.perf_counter() if wall else now
        delivered = self._shed(t)
        results = (self.supervisor.tick(now)
                   if self.supervisor is not None
                   else self.fleet.tick(now))
        results = [r for r in results if r.request_id in self._handlers]
        finite = iter(_all_finite([r.x0 for r in results if not r.dropped]))
        for r in results:           # warm-up / foreign traffic skipped
            if r.dropped:
                self._c_expired.inc()
                code = RejectCode.EXPIRED
                self._terminal(r.request_id, {
                    "event": "error", "request_id": r.request_id,
                    "code": code.value,
                    "message": (f"request {r.request_id} expired in the "
                                "queue before admission"),
                    "status": code.http_status,
                })
            elif not next(finite):
                # terminal NaN/Inf guard: a numerically exploded eps
                # trunk must surface as a typed 5xx, never stream garbage
                # to a client as if it were a sample. With the probe tier
                # on, the serving pool's flight recorder is dumped HERE —
                # the postmortem attributes the corruption to the exact
                # (pool, slot, step), not just this terminal symptom.
                self._c_nonfinite.inc()
                flight_path = self._dump_flight(
                    r.pool_id, "nonfinite", request_id=r.request_id)
                code = RejectCode.NONFINITE_SAMPLE
                event = {
                    "event": "error", "request_id": r.request_id,
                    "code": code.value,
                    "message": (f"request {r.request_id} produced a "
                                "non-finite sample (pool "
                                f"{r.pool_id})"),
                    "status": code.http_status,
                }
                if flight_path is not None:
                    event["flight"] = flight_path
                self._terminal(r.request_id, event)
            else:
                self._c_results.inc()
                event = {
                    "event": "result", "request_id": r.request_id,
                    "x0": r.x0, "S": r.S, "pool_id": r.pool_id,
                    "latency_s": r.latency_s,
                    "queue_wait_s": r.queue_wait_s,
                    "service_s": r.service_s,
                    "deadline_missed": r.deadline_missed,
                    "previews": r.previews,
                }
                # per-request trajectory-quality summary from the device
                # probes (engines built with probes=; None otherwise)
                if r.quality is not None:
                    event["quality"] = r.quality
                    d = r.quality.get("defect_mean")
                    if d is not None:
                        self._h_defect.observe(d)
                self._terminal(r.request_id, event)
            delivered += 1
        self._advance_swap(time.perf_counter() if wall else now)
        return delivered

    def run_until_idle(self, max_pumps: Optional[int] = None,
                       now_fn: Optional[Callable[[], float]] = None
                       ) -> int:
        """Pump until nothing is in flight (tests / trace replays)."""
        n = 0
        while self.busy:
            if max_pumps is not None and n >= max_pumps:
                break
            self.pump(now_fn() if now_fn else None)
            n += 1
        return n

    # ----------------------------------------------------------- hot swap
    def hot_swap(self, model: str, params=None,
                 now: Optional[float] = None) -> int:
        """Start a rolling rollout of ``model``'s staged checkpoint.

        ``params`` given stages it first (registry-validated). Returns
        the number of pools the rollout will walk. The walk itself
        happens across subsequent ``pump`` calls — one pool drains while
        the rest keep serving, so the model stays available throughout
        (with a single pool, its requests wait in the global queue and
        dispatch after the restore).
        """
        now = time.perf_counter() if now is None else now
        if params is not None:
            self.registry.stage(model, params)
        if model not in self.registry:
            raise RequestError(
                RejectCode.UNKNOWN_MODEL,
                f"rollout: model '{model}' is not registered")
        if self.registry.staged_params(model) is None:
            raise ValueError(f"rollout: model '{model}' has no staged "
                             "checkpoint (stage one first)")
        if self._swap is not None:
            raise RuntimeError(
                f"a rollout of '{self._swap.model}' is already in "
                "progress; one rolling swap at a time")
        pool_ids = [p.pool_id for p in self.fleet.pools
                    if p.model == model]
        if not pool_ids:
            raise RequestError(
                RejectCode.UNKNOWN_MODEL,
                f"rollout: no pool serves model '{model}'")
        self._swap = _SwapJob(model, pool_ids)
        self._advance_swap(now)
        return len(pool_ids)

    @property
    def swapping(self) -> Optional[str]:
        return self._swap.model if self._swap is not None else None

    def _advance_swap(self, now: float) -> None:
        """Step the rollout as far as the fleet's state allows: start
        draining the next pool, or — once the draining pool has parked
        STOPPED — install + restore and move on. Runs every pump."""
        job = self._swap
        while job is not None:
            if job.current is None:
                if not job.pending:
                    self.registry.promote(job.model)
                    self._c_swaps.inc()
                    self._swap = None
                    return
                job.current = job.pending.pop(0)
                pool = self.fleet.pools[job.current]
                if pool.state is PoolState.QUARANTINED:
                    # already tripped out: residents were evicted at the
                    # quarantine, so the engine is idle and install is
                    # safe NOW — but do not restore; re-admission belongs
                    # to the breaker probe, not the rollout
                    self._install_swap(pool, job)
                    job.current = None
                    continue
                self.fleet.drain_pool(job.current, now=now)
                continue
            pool = self.fleet.pools[job.current]
            if pool.state is PoolState.QUARANTINED:
                # quarantined mid-drain: same as above — install on the
                # (evicted, idle) engine and leave the breaker in charge
                self._install_swap(pool, job)
                job.current = None
                continue
            if pool.state is not PoolState.STOPPED:
                return               # residents still finishing; next pump
            self._install_swap(pool, job)
            self.fleet.restore_pool(job.current)
            job.current = None

    def _install_swap(self, pool: SlotPool, job: _SwapJob) -> None:
        pool.install(self.registry.staged_params(job.model))
        self.obs.registry.counter(
            "gateway_swap_pools_total",
            "pools walked by completed rollouts",
            model=job.model).inc()

    # ------------------------------------------------------------- health
    def health(self) -> Dict:
        """The /healthz body: ``status`` is "ok" unless any breaker is
        not CLOSED ("degraded" — still serving, capacity reduced), with
        per-pool detail and the quarantined pools' last errors."""
        quarantined = []
        degraded = False
        sup = self.supervisor
        if sup is not None and sup.degraded:
            degraded = True
            for pid in sup.quarantined_pools:
                br = sup.breaker(pid)
                quarantined.append({
                    "pool": pid, "trips": br.trips,
                    "last_error": br.last_error,
                })
        return {
            "status": "degraded" if degraded else "ok",
            "pools": [{"pool": p.pool_id, "state": p.state.value,
                       "model": p.model, "health": p.health}
                      for p in self.fleet.pools],
            "quarantined": quarantined,
            "queue_depth": len(self.fleet.queue),
            "absorbed_pump_errors": self._absorbed,
        }

    def absorb_pump_error(self, exc: BaseException) -> bool:
        """Bridge survivability hook: the EngineBridge asks whether a
        pump exception should be absorbed (keep serving) or poison the
        bridge (legacy behavior). Supervised cores absorb up to
        MAX_ABSORBED_PUMP_ERRORS — pool faults are already contained by
        the supervisor, so repeated pump-level failures mean the gateway
        itself is broken and the bridge should fail loud."""
        if self.supervisor is None:
            return False
        self._absorbed += 1
        self.obs.registry.counter(
            "gateway_pump_errors_absorbed_total",
            "pump exceptions absorbed to keep the bridge alive").inc()
        return self._absorbed <= self.MAX_ABSORBED_PUMP_ERRORS

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict:
        """The gateway-tier stats dict (obs/schema.GATEWAY_STATS_KEYS)."""
        return {
            "requests": int(self._c_requests.value),
            "rejected": self._sum_counter("gateway_rejected_total"),
            "shed": self._sum_counter("gateway_shed_total"),
            "expired": int(self._c_expired.value),
            "cancelled": int(self._c_cancelled.value),
            "nonfinite": int(self._c_nonfinite.value),
            "streams": len(self._handlers),
            "previews_streamed": int(self._c_previews.value),
            "results_streamed": int(self._c_results.value),
            "swaps": int(self._c_swaps.value),
            "models": self.registry.describe(),
            "queue_depth": len(self.fleet.queue),
            "fleet": self.fleet.stats(),
            "resilience": (self.supervisor.stats()
                           if self.supervisor is not None else None),
        }

    def reset_stats(self) -> None:
        """Zero gateway + fleet throughput telemetry (post-warm-up); the
        shed log and swap counters are lifecycle audit state and keep."""
        self.fleet.reset_stats()
        keep = {"gateway_swaps_total", "gateway_swap_pools_total"}
        for inst in self.obs.registry.instruments():
            if (inst.name.startswith("gateway_") and inst.kind != "gauge"
                    and inst.name not in keep):
                inst.reset()

    def render_prometheus(self) -> str:
        """One text snapshot over gateway + fleet + every pool engine."""
        parts = [(self.obs.registry, {"tier": "gateway"}),
                 (self.fleet.obs.registry, {"tier": "fleet"})]
        parts += [(p.engine.obs.registry, {"pool": p.pool_id})
                  for p in self.fleet.pools]
        return _render_prom(parts)

    # -------------------------------------------------------- construction
    @classmethod
    def build(cls, schedule, eps_apply, sample_shape, *,
              models: Dict[str, object], pools_per_model: int = 1,
              slots: int = 4, max_queue: Optional[int] = None,
              policy: Optional[OverloadPolicy] = None,
              obs: Optional[Observability] = None,
              warm: bool = True, supervise: bool = True,
              breaker=None, checkpoint_every: int = 8,
              injector=None, probes=None, flight_dir: Optional[str] = None,
              flight_capacity: int = 64, **engine_kw) -> "GatewayCore":
        """A multi-model gateway over fresh pools.

        ``eps_apply(params, x, t)`` is the shared trunk; ``models`` maps
        name -> weights (a state dict or nested dict of tensors, all
        install-compatible — same trunk, same keys, shapes, dtypes and
        device). Every model gets ``pools_per_model`` pools whose engines
        hold its weights as hot-swappable ``eps_params``. Engines build
        the preview tick by default (SSE x0 streaming); pass
        preview=False to opt out. ``device=`` goes to every engine (None:
        the card). ``warm=True`` runs every pool's tick once with a
        1-step request and resets throughput stats, so the first real
        request never pays (or mis-measures) the tick's build and the
        kernels' first use.

        ``supervise=True`` (the default) pumps through a resilience
        PoolSupervisor — identical on the happy path, but a pool tick
        fault quarantines that pool and migrates its work instead of
        poisoning the bridge (docs/resilience.md). ``breaker`` tunes its
        BreakerPolicy, ``checkpoint_every`` its snapshot cadence, and
        ``injector`` threads a FaultInjector through (chaos runs only).

        ``probes=`` (True / a ProbeSpec) turns on the device-probe tier
        on every pool engine; each engine then also gets a per-pool
        FlightRecorder (ring of ``flight_capacity`` frames, postmortems
        written under ``flight_dir`` — in-memory only when None) feeding
        the quarantine/nonfinite dumps, ``/v1/debug/flight/{pool}``, the
        per-result ``quality`` metadata, and the defect histogram.
        """
        from repro_torch.obs.flight import FlightRecorder

        obs = obs if obs is not None else Observability()
        registry = ModelRegistry()
        preview = engine_kw.pop("preview", True)
        pools = []
        pid = 0
        for name in sorted(models):
            registry.register(name, models[name])
            for _ in range(pools_per_model):
                flight = (FlightRecorder(flight_capacity, pool_id=pid,
                                         out_dir=flight_dir)
                          if probes is not None and probes is not False
                          else None)
                eng = ContinuousBatchingEngine(
                    schedule, eps_apply, sample_shape, slots,
                    eps_params=models[name], preview=preview,
                    pool_id=pid, obs=obs.child(), probes=probes,
                    flight=flight, **engine_kw)
                pools.append(SlotPool(pid, eng, model=name))
                pid += 1
        fleet = PoolFleet(pools, max_queue=max_queue, obs=obs.child())
        supervisor = None
        if supervise:
            from repro_torch.serving.resilience import PoolSupervisor
            supervisor = PoolSupervisor(
                fleet, policy=breaker, checkpoint_every=checkpoint_every,
                injector=injector)
        core = cls(fleet, registry, policy=policy, obs=obs,
                   supervisor=supervisor)
        if warm:
            for p in pools:
                p.engine.serve([SampleRequest(request_id=-1 - p.pool_id,
                                              S=1, seed=0)])
            core.reset_stats()
        return core
