"""Per-request trace spans (port of the part of ``repro/obs/trace.py``
that the scheduler and its queue call).

One request produces one SPAN: an ordered sequence of flat events from
submission to retirement,

    submit -> admit [-> resume] -> first_tick -> [preview]* -> retire
    submit -> expire -> drop                         (queue-tier expiry)
    reject                                           (back-pressure)
    ... -> cancel                                    (client cancel)

each with ``ev`` (kind), ``t`` (the caller's clock) and ``req`` (request
id), plus ``pool`` / ``plan`` / ``nfe`` once known and per-kind extras.
A :class:`TraceContext` rides on ``SampleRequest.trace``; emission is a
no-op unless a sink is attached.  The JSONL sink and the span readers
and checkers wait with the rest of the serving stack (ROADMAP queue 1).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

def plan_digest(plan) -> str:
    """Short process-stable digest of a frozen SamplerPlan's contents."""
    h = hashlib.sha1(repr(plan).encode() + plan.schedule_digest())
    return h.hexdigest()[:12]


class ListSink:
    """In-memory sink (tests, dashboards)."""

    def __init__(self):
        self.events: List[Dict] = []

    def emit(self, event: Dict) -> None:
        self.events.append(event)


class Tracer:
    """Fan-out of span events to zero or more sinks."""

    __slots__ = ("sinks",)

    def __init__(self):
        self.sinks: List = []

    @property
    def active(self) -> bool:
        return bool(self.sinks)

    def emit(self, event: Dict) -> None:
        for s in self.sinks:
            s.emit(event)


class TraceContext:
    """One request's span head, carried on ``SampleRequest.trace``."""

    __slots__ = ("tracer", "request_id", "pool_id", "plan_digest", "nfe",
                 "submitted")

    def __init__(self, tracer: Tracer, request_id):
        self.tracer = tracer
        self.request_id = request_id
        self.pool_id: Optional[int] = None
        self.plan_digest: Optional[str] = None
        self.nfe: Optional[int] = None
        self.submitted = False        # front-door 'submit' emitted once

    def emit(self, kind: str, t: float, **fields) -> None:
        if not self.tracer.sinks:
            return
        ev: Dict = {"ev": kind, "t": round(float(t), 9),
                    "req": self.request_id}
        if self.pool_id is not None:
            ev["pool"] = self.pool_id
        if self.plan_digest is not None:
            ev["plan"] = self.plan_digest
        if self.nfe is not None:
            ev["nfe"] = self.nfe
        for k, v in fields.items():
            if v is not None:
                ev[k] = round(v, 9) if isinstance(v, float) else v
        self.tracer.emit(ev)
