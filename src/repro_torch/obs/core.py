"""Observability: the handle a serving component hangs its telemetry on
(port of the part of ``repro/obs/core.py`` that the scheduler calls).

``registry`` is the metrics plane, always live: the engine's ``stats()``
dict is a view over its instruments.  ``tracer`` is the span plane, inert
until a sink is attached.  Each engine owns a private registry.  The
profiler plane (``profile=True`` tick annotations, JAX:
``repro/obs/profiling.py``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

from .registry import MetricsRegistry
from .trace import TraceContext, Tracer


class Observability:
    """Telemetry handle: metrics registry + span tracer."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None, profile: bool = False):
        if profile:
            raise NotImplementedError(
                "profile=True tick annotations are not ported yet (JAX: "
                "repro/obs/profiling.py)")
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.profile = False

    @property
    def tracing(self) -> bool:
        return self.tracer.active

    def add_sink(self, sink):
        """Attach an event sink (e.g. ``ListSink``); returns it."""
        self.tracer.sinks.append(sink)
        return sink

    def trace_context(self, request_id) -> TraceContext:
        return TraceContext(self.tracer, request_id)

    def trace_submit(self, req, now: float, **fields
                     ) -> Optional[TraceContext]:
        """Front-door hook: make sure ``req`` carries a span and that
        exactly one ``submit`` event exists for it."""
        if req.trace is None and self.tracing:
            req.trace = self.trace_context(req.request_id)
        ctx = req.trace
        if ctx is not None and not ctx.submitted:
            ctx.submitted = True
            ctx.emit("submit", now, **fields)
        return ctx
