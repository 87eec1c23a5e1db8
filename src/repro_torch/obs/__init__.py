"""Serving telemetry (port of ``repro.obs``): metrics registry, trace
spans, profiling ranges, device probes and flight data.

Host-side, except ``probes.py``: the opt-in device-probe tier, whose
reductions run in a second, separately built tick function (at most two
per engine).  The entry point is :class:`Observability`: pass one to
``ContinuousBatchingEngine`` / ``PoolFleet.build`` and the engine's
``stats()`` becomes a view over real instruments, ``add_sink`` turns on
per-request spans, and ``profile=True`` wraps each tick in a
``repro/tick/<variant>`` profiler range.  For in-flight numerics build the
engine with ``probes=`` (a :class:`ProbeSpec`) and optionally a
:class:`FlightRecorder` for postmortem dumps.
"""
from .core import Observability
from .dashboard import render_dashboard, render_summary, summarize_results
from .flight import (FlightRecorder, attribute_nonfinite,
                     detect_weight_corruption, read_flight)
from .probes import ProbeSpec
from .profiling import annotate, format_hbm_table, modeled_hbm_table
from .registry import (Counter, Gauge, Histogram, LATENCY_BUCKETS_S,
                       MetricsRegistry, SLACK_BUCKETS_S, render_prometheus)
from .schema import (ENGINE_STATS_KEYS, FLEET_STATS_KEYS, POOL_STATS_KEYS,
                     PROBE_COLUMNS)
from .trace import (EVENT_KINDS, JsonlSink, ListSink, TraceContext, Tracer,
                    check_spans, ordering, plan_digest, read_jsonl, spans)

__all__ = [
    "Observability",
    # metrics plane
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS_S", "SLACK_BUCKETS_S", "render_prometheus",
    # span plane
    "Tracer", "TraceContext", "JsonlSink", "ListSink", "EVENT_KINDS",
    "plan_digest", "read_jsonl", "spans", "check_spans", "ordering",
    # profiling plane
    "annotate", "modeled_hbm_table", "format_hbm_table",
    # device-probe + flight-recorder tier
    "ProbeSpec", "PROBE_COLUMNS", "FlightRecorder",
    "attribute_nonfinite", "detect_weight_corruption", "read_flight",
    # exporter contracts
    "ENGINE_STATS_KEYS", "POOL_STATS_KEYS", "FLEET_STATS_KEYS",
    "render_dashboard", "summarize_results", "render_summary",
]
