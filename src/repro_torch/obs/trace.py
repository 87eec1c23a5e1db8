"""Per-request trace spans: structured JSONL events for the serving stack
(port of ``repro/obs/trace.py``).

One request produces one SPAN: an ordered sequence of flat events from
submission to retirement,

    submit -> [route] -> [select] -> admit -> first_tick
           -> [preview]* -> retire
    submit -> [route] -> expire -> drop              (queue-tier expiry)
    reject                                           (back-pressure)

``requeue`` marks a re-entry into the global queue (a pool drain) and
starts a fresh segment of the span that may route and admit again;
``resume`` records a checkpoint refill (only after a requeue); ``cancel``
is terminal and valid anywhere.  Each event has ``ev`` (kind), ``t`` (the
caller's clock) and ``req`` (request id), plus ``pool`` / ``plan`` /
``nfe`` once known and per-kind extras.  File order is emission order, so
the ``admit`` (``retire``) events give the engine's admission
(retirement) order.  A :class:`TraceContext` rides on
``SampleRequest.trace``; emission is a no-op unless a sink is attached.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

EVENT_KINDS = ("submit", "reject", "route", "select", "expire", "admit",
               "resume", "first_tick", "preview", "retire", "drop",
               "requeue", "cancel")

# events whose relative order defines a well-formed span SEGMENT
# ("requeue" starts a new segment; "cancel" is order-free and terminal).
# "preview" shares first_tick's rank: the engine delivers a tick's
# previews before stamping first_tick.
_ORDER = {k: i for i, k in enumerate(
    ("submit", "route", "select", "expire", "admit", "resume",
     "first_tick", "preview", "retire", "drop"))}
_ORDER["preview"] = _ORDER["first_tick"]
_TERMINAL = ("retire", "drop", "reject", "cancel")

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

    def close(self) -> None:
        pass


class JsonlSink:
    """Append events to a JSONL file, one compact object per line."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w")

    def emit(self, event: Dict) -> None:
        self._f.write(json.dumps(event, separators=(",", ":")) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Tracer:
    """Fan-out of span events to zero or more sinks."""

    __slots__ = ("sinks", "emitted")

    def __init__(self):
        self.sinks: List = []
        self.emitted = 0

    @property
    def active(self) -> bool:
        return bool(self.sinks)

    def emit(self, event: Dict) -> None:
        self.emitted += 1
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


# ----------------------------------------------------------- span reading
def read_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def spans(events: List[Dict]) -> Dict[object, List[Dict]]:
    """Group an event stream into per-request spans (emission order)."""
    out: Dict[object, List[Dict]] = {}
    for ev in events:
        out.setdefault(ev["req"], []).append(ev)
    return out


def check_spans(events: List[Dict]) -> List[str]:
    """Validate span well-formedness; returns human-readable violations.

    Per request: known event kinds, a ``t`` on every event, monotone
    lifecycle order within each requeue-delimited segment, exactly one
    terminal event over the whole span, ``retire`` / ``first_tick`` only
    after some ``admit``, and ``resume`` only after a ``requeue``.  An
    empty return means the log reconstructs cleanly.
    """
    errors: List[str] = []
    for req, evs in spans(events).items():
        kinds = [e["ev"] for e in evs]
        for e in evs:
            if e["ev"] not in EVENT_KINDS:
                errors.append(f"req {req}: unknown event kind {e['ev']!r}")
            if "t" not in e:
                errors.append(f"req {req}: event {e['ev']} missing 't'")
        segments: List[List[str]] = [[]]
        for k in kinds:
            if k == "requeue":
                segments.append([])
            elif k in _ORDER:
                segments[-1].append(k)
        for seg in segments:
            ranks = [_ORDER[k] for k in seg]
            if any(b < a for a, b in zip(ranks, ranks[1:])):
                errors.append(f"req {req}: out-of-order span {kinds}")
                break
        terminals = [k for k in kinds if k in _TERMINAL]
        if len(terminals) != 1:
            errors.append(f"req {req}: expected exactly one terminal "
                          f"event, got {terminals or 'none'} in {kinds}")
        if "retire" in kinds and "admit" not in kinds:
            errors.append(f"req {req}: retire without admit")
        if "first_tick" in kinds and "admit" not in kinds:
            errors.append(f"req {req}: first_tick without admit")
        if "resume" in kinds and "requeue" not in kinds:
            errors.append(f"req {req}: resume without a prior requeue")
    return errors


def ordering(events: List[Dict], kind: str) -> List:
    """Request ids in the order their ``kind`` events were emitted."""
    return [e["req"] for e in events if e["ev"] == kind]
