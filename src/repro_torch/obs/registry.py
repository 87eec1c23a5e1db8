"""Metrics registry: host-side counters.

Port of the part of ``repro/obs/registry.py`` that the scheduler's
``stats()`` reads.  Every instrument is plain host-side Python state, so
instrumenting the tick loop adds no device work.  Instruments are
identified by (name, sorted label pairs); the engine's ``stats()`` dict is
a view over them.  The gauges, the histograms with their bucket ladders,
the Prometheus exporter and the percentile estimate wait with the rest of
the serving stack (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotonic counter (floats allowed, e.g. accumulated wall seconds)."""

    __slots__ = ("name", "labels", "help", "value")

    def __init__(self, name: str, labels: LabelKey = (), help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class MetricsRegistry:
    """Get-or-create counter store."""

    def __init__(self):
        self._instruments: Dict[Tuple[str, LabelKey], Counter] = {}

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        inst = self._instruments.get(key)
        if inst is None:
            inst = self._instruments[key] = Counter(name, key[1], help)
        return inst

    def instruments(self) -> List[Counter]:
        return [self._instruments[k] for k in sorted(self._instruments)]
