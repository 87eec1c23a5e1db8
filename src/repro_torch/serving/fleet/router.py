"""Routing policies for the slot-pool fleet's dispatch tier (port of
``repro/serving/fleet/router.py``; the same decisions).

The fleet pops requests from its global EDF queue and asks the router
which ACTIVE pool takes each one:

* **affinity**: requests carrying the same ``affinity_key`` prefer the
  same pool, by a deterministic crc32 over the pool count (stable across
  runs and processes).  A draining or full preferred pool falls back to
  least-loaded.
* **least-loaded**: pools ranked by estimated backlog-absorption time:
  remaining resident + queued steps over the pool's slots, at the pool's
  own tick EWMA (the fleet mean, or 1.0, before a pool has one).
* **health**: ``SlotPool.health`` (1.0 on a fault-free pool) divides the
  least-loaded rank, and affinity yields to least-loaded when the
  preferred pool's health is below ``AFFINITY_HEALTH_MIN``.
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Sequence

from .pool import SlotPool

# a sticky preference is only honored while the pool is this healthy —
# below it the request falls back to the (health-weighted) least-loaded
# rank rather than following a session key onto a flaky backend
AFFINITY_HEALTH_MIN = 0.5


def affinity_pool(key, n_pools: int) -> int:
    """Deterministic affinity_key -> preferred pool index."""
    return zlib.crc32(repr(key).encode()) % n_pools


def _default_tick_s(pools: Sequence[SlotPool]) -> float:
    known = [p.tick_ewma_s for p in pools if p.tick_ewma_s is not None]
    return sum(known) / len(known) if known else 1.0


def pick_pool(pools: Sequence[SlotPool], req, explain: bool = False):
    """The dispatch decision for one popped request.

    Returns None when no active pool has capacity (the fleet stops
    popping — the request stays in the global EDF queue rather than
    deep-queueing behind one backend, which would re-order deadlines).

    ``explain=True`` returns ``(pool, reason)`` instead, with reason one
    of ``"affinity"`` (sticky preference honored), ``"least-loaded"``
    (ranked by backlog-absorption time), or ``"full"`` (pool is None) —
    the label the fleet stamps on its routing counters and ``route``
    trace events.
    """
    model = getattr(req, "model", None)
    eligible: List[SlotPool] = ([p for p in pools if p.model == model]
                                if model is not None else list(pools))
    cands: List[SlotPool] = [p for p in eligible if p.capacity > 0]
    pool: Optional[SlotPool] = None
    reason = "full"
    if cands:
        key = getattr(req, "affinity_key", None)
        # affinity hashes over the model-ELIGIBLE subset: the sticky pick
        # must be a pool that can serve the request's checkpoint, and the
        # mapping stays stable for a given (key, model) pair even as other
        # models' pools drain and restore
        pref = (eligible[affinity_pool(key, len(eligible))]
                if key is not None and eligible else None)
        if (pref is not None and pref.capacity > 0
                and pref.health >= AFFINITY_HEALTH_MIN):
            pool, reason = pref, "affinity"
        else:
            default = _default_tick_s(pools)
            # (load + one tick) / health: a monotone transform of the
            # load rank when healths are equal, but an unhealthy idle
            # pool ranks behind a healthy idle one
            pool = min(cands,
                       key=lambda p: ((p.load_eta_s(default) + default)
                                      / max(p.health, 1e-3), p.pool_id))
            reason = "least-loaded"
    return (pool, reason) if explain else pool
