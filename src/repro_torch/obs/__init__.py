"""Serving telemetry, host side only (port of part of ``repro.obs``): the
counters behind the scheduler's ``stats()`` and per-request trace spans.
Gauges, histograms, probes, the flight recorder, profiling annotations,
dashboards and the frozen stats schemas are not ported yet."""
from .core import Observability
from .registry import Counter, MetricsRegistry
from .trace import ListSink, TraceContext, Tracer, plan_digest

__all__ = ["Observability", "MetricsRegistry", "Counter", "Tracer",
           "TraceContext", "ListSink", "plan_digest"]
