"""Fault flight recorder: a host-side ring of device probe frames (port
of ``repro/obs/flight.py``, the same JSONL format).

An engine with probes on can carry a :class:`FlightRecorder`: the tick's
host path pushes one frame record per probed tick (the ``(slots, 6)``
probe matrix plus the slot -> request map at that instant), and a caller
dumps the ring to a provenance-stamped JSONL postmortem when something
goes wrong.  The dump pins the failure to the exact (pool, slot, step)
via :func:`attribute_nonfinite`.  Everything here is host-side Python on
values the tick already copied to the host.

JSONL layout (schema constants in obs/schema.py):
  line 1   header record: version, reason, pool, wall_time, frame count,
           probe column order, nonfinite attribution, free-form context
  line 2+  frame records, oldest first: tick index, virtual/host time,
           slot -> request map, probe values (non-finite floats written
           as null; the signal for attribution is the finite_frac column,
           a finite number whenever it is computed)
"""
from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.schema import FLIGHT_SCHEMA_VERSION, PROBE_COLUMNS

_I_EPS = PROBE_COLUMNS.index("eps_rms")
_I_FINITE = PROBE_COLUMNS.index("finite_frac")


def _clean(v: Any) -> Any:
    """Recursively replace non-finite floats with None for JSONL."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    return v


def attribute_nonfinite(frames: List[Dict]) -> Optional[Dict]:
    """First (pool, slot, step) whose state went non-finite, or None.

    Scans oldest→newest for the first frame where an occupied slot's
    finite_frac dropped below 1.0 — that slot's recorded ``k`` is the
    sampler step that produced the corruption (the frame is captured
    before the tick's retire loop advances ``k``).
    """
    for fr in frames:
        for b, ent in enumerate(fr.get("slots") or []):
            if ent is None:
                continue
            row = fr["values"][b]
            v = row[_I_FINITE]
            if v is not None and math.isfinite(v) and v < 1.0:
                return {
                    "pool": fr.get("pool"), "slot": b,
                    "step": ent.get("k"), "request_id": ent.get("request_id"),
                    "tick": fr.get("tick"), "finite_frac": float(v),
                }
    return None


def detect_weight_corruption(frames: List[Dict], *,
                             factor: float = 3.0) -> Optional[Dict]:
    """First eps-activation blow-up consistent with corrupted weights.

    A weight-scaling fault leaves every sample finite but multiplies the
    eps trunk's output scale, so the per-slot eps_rms jumps by the
    corruption factor between consecutive frames of the SAME request —
    while a healthy trajectory's eps_rms drifts smoothly. Returns the
    first (pool, slot, step) where eps_rms grew by >= ``factor``.
    """
    last: Dict[Any, float] = {}
    for fr in frames:
        for b, ent in enumerate(fr.get("slots") or []):
            if ent is None:
                continue
            row = fr["values"][b]
            v = row[_I_EPS]
            if v is None or not math.isfinite(v):
                continue
            rid = ent.get("request_id")
            prev = last.get(rid)
            last[rid] = float(v)
            if prev is not None and prev > 0.0 and v >= factor * prev:
                return {
                    "pool": fr.get("pool"), "slot": b,
                    "step": ent.get("k"), "request_id": rid,
                    "tick": fr.get("tick"),
                    "ratio": float(v) / prev,
                }
    return None


class FlightRecorder:
    """Bounded ring of probe frames + JSONL postmortem dumper.

    One recorder per engine/pool. ``record`` is O(1) append (oldest
    frame evicted at capacity); ``dump`` never raises for I/O-free
    configurations — with no ``out_dir`` it returns None so callers can
    attach recorders for the in-memory ring/endpoint alone.
    """

    def __init__(self, capacity: int = 64, *, pool_id: Optional[int] = None,
                 out_dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = int(capacity)
        self.pool_id = pool_id
        self.out_dir = out_dir
        self.dumps = 0
        self.dump_paths: List[str] = []
        self._frames: collections.deque = collections.deque(maxlen=capacity)

    def record(self, frame: Dict) -> None:
        self._frames.append(frame)

    def frames(self) -> List[Dict]:
        return list(self._frames)

    def snapshot(self) -> Dict:
        """In-memory view for the gateway's /v1/debug/flight endpoint."""
        return {
            "pool": self.pool_id,
            "capacity": self.capacity,
            "dumps": self.dumps,
            "columns": list(PROBE_COLUMNS),
            "attribution": attribute_nonfinite(self.frames()),
            "frames": [_clean(fr) for fr in self.frames()],
        }

    def dump(self, reason: str, **context) -> Optional[str]:
        """Write the ring to a provenance-stamped JSONL postmortem.

        Returns the path, or None when no out_dir is configured (the
        ring stays intact either way — a later trigger can re-dump).
        """
        if self.out_dir is None:
            return None
        frames = self.frames()
        header = {
            "record": "header",
            "version": FLIGHT_SCHEMA_VERSION,
            "reason": reason,
            "pool": self.pool_id,
            "wall_time": time.time(),
            "frames": len(frames),
            "columns": list(PROBE_COLUMNS),
            "attribution": attribute_nonfinite(frames),
            "context": _clean(dict(context)),
        }
        os.makedirs(self.out_dir, exist_ok=True)
        name = f"flight_pool{self.pool_id}_{reason}_{self.dumps:03d}.jsonl"
        path = os.path.join(self.out_dir, name)
        with open(path, "w") as fh:
            fh.write(json.dumps(header) + "\n")
            for fr in frames:
                rec = {"record": "frame"}
                rec.update(_clean(fr))
                fh.write(json.dumps(rec) + "\n")
        self.dumps += 1
        self.dump_paths.append(path)
        return path


def read_flight(path: str):
    """Parse a flight JSONL dump → (header, [frame, ...])."""
    header, frames = None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("record") == "header":
                header = rec
            else:
                frames.append(rec)
    if header is None:
        raise ValueError(f"{path}: missing flight header record")
    return header, frames
