"""Admission queue for the continuous-batching scheduler (port of
``repro/serving/scheduler/queue.py``).

Earliest-deadline-first ordering (requests without a deadline sort last,
FIFO among themselves), an optional depth bound for back-pressure, and
expiry at pop time: a request whose deadline has passed is never admitted
to a slot; it comes back to the engine as a dropped miss.  ``pop`` takes a
``select`` hook run on the request it is about to return.  The
submitted / rejected / expired counters and the ``queue_depth`` gauge are
registry instruments of the owning tier's ``Observability``; the queue
emits the ``reject`` and ``expire`` span events.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Callable, List, Optional, Tuple

from repro_torch.obs import Observability

from .request import SampleRequest


class AdmissionQueue:
    """EDF-ordered admission queue with optional depth bound."""

    def __init__(self, max_depth: Optional[int] = None,
                 obs: Optional[Observability] = None):
        self.max_depth = max_depth
        self._heap: List[Tuple[float, int, SampleRequest]] = []
        self._seq = itertools.count()
        self.obs = obs if obs is not None else Observability()
        reg = self.obs.registry
        self._c_submitted = reg.counter(
            "queue_submitted_total", "requests accepted by the queue")
        self._c_rejected = reg.counter(
            "queue_rejected_total", "submissions refused at the depth bound")
        self._c_expired = reg.counter(
            "queue_expired_total", "requests expired un-served at pop")
        self._g_depth = reg.gauge(
            "queue_depth", "current admission-queue depth")

    @property
    def submitted(self) -> int:
        return int(self._c_submitted.value)

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def expired(self) -> int:
        return int(self._c_expired.value)

    def __len__(self) -> int:
        return len(self._heap)

    def _push(self, req: SampleRequest) -> None:
        key = req.deadline if req.deadline is not None else math.inf
        heapq.heappush(self._heap, (key, next(self._seq), req))

    def submit(self, req: SampleRequest, now: float) -> bool:
        """Enqueue; False means rejected for depth (back-pressure)."""
        if self.max_depth is not None and len(self._heap) >= self.max_depth:
            self._c_rejected.inc()
            if req.trace is not None:
                req.trace.emit("reject", now, reason="queue-full")
            return False
        req.submit_t = now if req.submit_t is None else req.submit_t
        self._push(req)
        self._c_submitted.inc()
        self._g_depth.set(len(self._heap))
        return True

    def requeue(self, req: SampleRequest, now: float) -> None:
        """Re-enter a previously accepted request without counting a new
        arrival or re-running the depth bound (its ``submit_t`` stays)."""
        self._push(req)

    def pop(self, now: float,
            select: Optional[Callable[[SampleRequest, float], None]] = None
            ) -> Tuple[Optional[SampleRequest], List[SampleRequest]]:
        """Next admissible request + any requests that expired un-served.
        ``select(req, now)`` runs on the request about to be returned."""
        missed: List[SampleRequest] = []
        out = None
        while self._heap:
            _, _, req = heapq.heappop(self._heap)
            if req.deadline is not None and req.deadline < now:
                missed.append(req)
                self._c_expired.inc()
                if req.trace is not None:
                    req.trace.emit("expire", now, deadline=req.deadline)
                continue
            if select is not None:
                select(req, now)
            out = req
            break
        self._g_depth.set(len(self._heap))
        return out, missed

    def remove_if(self, pred: Callable[[SampleRequest], bool]
                  ) -> List[SampleRequest]:
        """Remove every queued request matching ``pred``; return them in
        EDF order.  Kept requests keep their heap entries, so FIFO among
        equal deadlines survives."""
        removed, kept = [], []
        for entry in self._heap:
            (removed if pred(entry[2]) else kept).append(entry)
        if removed:
            heapq.heapify(kept)
            self._heap = kept
            self._g_depth.set(len(kept))
        return [r for _, _, r in sorted(removed, key=lambda e: e[:2])]

    def pending_requests(self) -> List[SampleRequest]:
        """Queued requests in EDF order (non-destructive)."""
        return [req for _, _, req in sorted(self._heap, key=lambda e: e[:2])]

    def drain_pending(self) -> List[SampleRequest]:
        """Remove and return every queued request (EDF order)."""
        out = self.pending_requests()
        self._heap.clear()
        self._g_depth.set(0)
        return out
