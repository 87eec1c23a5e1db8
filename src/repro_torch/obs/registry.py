"""Metrics registry: host-side counters, gauges, fixed-bucket histograms
(port of ``repro/obs/registry.py``).

Every instrument is plain host-side Python/numpy state, so instrumenting
the tick loop adds no device work.  Instruments are identified by (name,
sorted label pairs); labels are for low-cardinality dimensions (tick
variant, bank NFE, selection outcome), per-request data belongs in trace
events.  Each engine owns a private registry and pool identity is
attached at RENDER time (``render_prometheus(parts)`` merges registries
under extra labels).  The kind and help text are per-name metadata of the
registry, as in JAX, so the rendered ``# HELP`` / ``# TYPE`` lines match.

Histograms are fixed-bucket (Prometheus-style cumulative rendering): an
``observe`` is one bisect and one bump, and percentiles interpolate
linearly inside the hit bucket.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# default latency bucket ladder (seconds): ~geometric, 100us .. 60s
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# signed buckets for deadline slack (negative = finished past deadline)
SLACK_BUCKETS_S: Tuple[float, ...] = (
    -30.0, -10.0, -5.0, -1.0, -0.5, -0.1, -0.01, 0.0,
    0.01, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0)

LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotonic counter (floats allowed, e.g. accumulated wall seconds)."""

    __slots__ = ("name", "labels", "value")

    kind = "counter"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-value instrument (queue depth, occupancy, EWMA mirrors)."""

    __slots__ = ("name", "labels", "value")

    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket histogram: counts per bucket + running sum/count.

    ``edges`` are ascending upper bounds; an implicit +Inf bucket catches
    the overflow.
    """

    __slots__ = ("name", "labels", "edges", "counts", "sum", "count")

    kind = "histogram"

    def __init__(self, name: str, labels: LabelKey = (),
                 edges: Sequence[float] = LATENCY_BUCKETS_S):
        edges = tuple(float(e) for e in edges)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"{name}: histogram edges must be non-empty "
                             f"and strictly ascending, got {edges}")
        self.name = name
        self.labels = labels
        self.edges = edges
        self.counts = np.zeros(len(edges) + 1, np.int64)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile estimate (q in [0, 100]).

        The overflow bucket reports the last finite edge; the first bucket
        interpolates down from its edge toward 0 (latencies) or reports
        the edge when it is negative (slack histograms).
        """
        if self.count == 0:
            return float("nan")
        target = self.count * q / 100.0
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target:
                if i >= len(self.edges):            # +Inf bucket
                    return self.edges[-1]
                hi = self.edges[i]
                lo = self.edges[i - 1] if i > 0 else min(0.0, hi)
                frac = (target - cum) / max(c, 1)
                return lo + (hi - lo) * frac
            cum += c
        return self.edges[-1]

    def reset(self) -> None:
        self.counts[:] = 0
        self.sum = 0.0
        self.count = 0


def _label_key(labels: Dict) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create instrument store with consistent metadata per name."""

    def __init__(self):
        self._instruments: Dict[Tuple[str, LabelKey], object] = {}
        self._meta: Dict[str, Tuple[str, str]] = {}   # name -> (kind, help)

    def _get(self, cls, name: str, help_: str, labels: Dict, **kw):
        key = (name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            meta = self._meta.get(name)
            if meta is not None and meta[0] != cls.kind:
                raise ValueError(f"instrument {name!r} already registered "
                                 f"as a {meta[0]}, not a {cls.kind}")
            if meta is None or (not meta[1] and help_):
                self._meta[name] = (cls.kind, help_)
            inst = cls(name, key[1], **kw)
            self._instruments[key] = inst
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  edges: Sequence[float] = LATENCY_BUCKETS_S,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, edges=edges)

    def instruments(self) -> List[object]:
        return [self._instruments[k] for k in sorted(self._instruments)]

    def get(self, name: str, **labels):
        return self._instruments.get((name, _label_key(labels)))

    def help_for(self, name: str) -> Tuple[str, str]:
        return self._meta.get(name, ("", ""))

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict view: {name: {label_str: value-or-histogram-dict}}."""
        out: Dict[str, Dict] = {}
        for inst in self.instruments():
            lbl = ",".join(f"{k}={v}" for k, v in inst.labels)
            if isinstance(inst, Histogram):
                val = {"sum": inst.sum, "count": inst.count,
                       "buckets": dict(zip([*map(str, inst.edges), "+Inf"],
                                           inst.counts.tolist()))}
            else:
                val = inst.value
            out.setdefault(inst.name, {})[lbl] = val
        return out

    def reset(self) -> None:
        for inst in self._instruments.values():
            inst.reset()


# -------------------------------------------------------------- exporters
def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(pairs: Iterable[Tuple[str, str]]) -> str:
    items = [f'{k}="{_escape(str(v))}"' for k, v in pairs]
    return "{" + ",".join(items) + "}" if items else ""


def _fmt_num(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def render_prometheus(parts: Sequence[Tuple[MetricsRegistry, Dict]]) -> str:
    """Prometheus text exposition over one or more registries.

    ``parts`` is [(registry, extra_labels)]: a fleet renders its own
    registry plus every pool's under ``{"pool": id}``; series are grouped
    by metric name so # HELP / # TYPE headers appear exactly once.
    """
    series: Dict[str, List[Tuple[LabelKey, object]]] = {}
    meta: Dict[str, Tuple[str, str]] = {}
    for registry, extra in parts:
        extra_pairs = _label_key(extra or {})
        for inst in registry.instruments():
            if inst.name not in meta or not meta[inst.name][1]:
                meta[inst.name] = registry.help_for(inst.name)
            series.setdefault(inst.name, []).append(
                (extra_pairs + inst.labels, inst))
    lines: List[str] = []
    for name in sorted(series):
        kind, help_ = meta.get(name, ("gauge", ""))
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind or 'gauge'}")
        for labels, inst in series[name]:
            if isinstance(inst, Histogram):
                cum = 0
                for edge, c in zip([*inst.edges, float("inf")],
                                   inst.counts):
                    cum += int(c)
                    le = "+Inf" if edge == float("inf") else _fmt_num(edge)
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels([*labels, ('le', le)])} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_num(inst.sum)}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{inst.count}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_num(inst.value)}")
    return "\n".join(lines) + ("\n" if lines else "")
