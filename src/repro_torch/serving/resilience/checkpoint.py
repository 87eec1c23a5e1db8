"""Latest-checkpoint store for trajectory migration (port of
``repro/serving/resilience/checkpoint.py``).

One :class:`SlotCheckpoint` per in-flight request — the supervisor's
periodic sweep overwrites it (only the LATEST snapshot matters: DDIM's
deterministic process replays the remaining steps exactly from any
prefix state, so keeping history would buy nothing), and terminal
events (retire/cancel) forget it. Memory is bounded by
``n_in_flight * slot_rows_bytes``, independent of trajectory length.
The snapshots are tensor copies on the engine's device (the memory is
device memory on the card).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.serving.scheduler.request import SlotCheckpoint


class CheckpointStore:
    """Latest per-request slot checkpoint."""

    def __init__(self):
        self._latest: Dict[object, SlotCheckpoint] = {}
        self.taken = 0        # snapshots ever stored (sweep telemetry)

    def __len__(self) -> int:
        return len(self._latest)

    def put(self, ck: SlotCheckpoint) -> None:
        self._latest[ck.request_id] = ck
        self.taken += 1

    def latest(self, request_id) -> Optional[SlotCheckpoint]:
        return self._latest.get(request_id)

    def forget(self, request_id) -> None:
        self._latest.pop(request_id, None)

    def clear(self) -> None:
        self._latest.clear()
