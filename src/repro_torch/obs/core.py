"""Observability: the handle a serving component hangs its telemetry on
(port of ``repro/obs/core.py``).

One :class:`Observability` bundles the three telemetry planes:

* ``registry``: the metrics plane, always live; the engine's ``stats()``
  dict is a view over its instruments.
* ``tracer``: the span plane, inert until a sink is attached
  (``add_sink``).
* ``profile``: the profiler plane; when True the engine wraps each tick
  in ``annotate("repro/tick/<variant>")`` (obs/profiling.py), a
  ``torch.profiler`` range that is also an NVTX range on a CUDA process.

Each engine owns a PRIVATE registry (identity attaches at render time),
while a fleet shares ONE tracer across tiers: ``child()`` builds a pool's
handle with a fresh registry and this tracer and profile flag.
"""
from __future__ import annotations

from typing import Optional

from .registry import MetricsRegistry, render_prometheus as _render
from .trace import TraceContext, Tracer


class Observability:
    """Telemetry handle: metrics registry + span tracer + profile flag."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None, profile: bool = False):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.profile = bool(profile)

    # ------------------------------------------------------------- tracing
    @property
    def tracing(self) -> bool:
        return self.tracer.active

    def add_sink(self, sink):
        """Attach an event sink (JsonlSink / ListSink); returns it."""
        self.tracer.sinks.append(sink)
        return sink

    def trace_context(self, request_id) -> TraceContext:
        return TraceContext(self.tracer, request_id)

    def trace_submit(self, req, now: float, **fields
                     ) -> Optional[TraceContext]:
        """Front-door hook: make sure ``req`` carries a span and that
        exactly one ``submit`` event exists for it (a later tier that
        re-submits it, fleet -> pool queue, stays quiet)."""
        if req.trace is None and self.tracing:
            req.trace = self.trace_context(req.request_id)
        ctx = req.trace
        if ctx is not None and not ctx.submitted:
            ctx.submitted = True
            ctx.emit("submit", now, **fields)
        return ctx

    def close(self) -> None:
        """Flush and close every sink that supports it."""
        for s in self.tracer.sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()

    # ------------------------------------------------------------ topology
    def child(self) -> "Observability":
        """A dependent component's handle: own metrics, shared tracer."""
        return Observability(tracer=self.tracer, profile=self.profile)

    # ----------------------------------------------------------- exporters
    def render_prometheus(self, **extra_labels) -> str:
        """Prometheus text snapshot of this registry (labels appended)."""
        return _render([(self.registry, extra_labels)])
