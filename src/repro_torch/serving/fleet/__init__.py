"""Slot-pool fleet (port of ``repro.serving.fleet``): N continuous-batching
slot pools behind a global EDF admission queue with affinity /
least-loaded routing, graceful drain / refill, weight hot-swap on idle
pools and aggregated stats.  On one card the pools share it; the demo
trunk of ``sharded.py`` runs unsharded, and its mesh entry points raise
``NotImplementedError`` (they need a second GPU)."""
from .fleet import PoolFleet
from .pool import PoolState, SlotPool
from .router import AFFINITY_HEALTH_MIN, affinity_pool, pick_pool
from .sharded import (make_sharded_eps, make_trunk_params,
                      make_unsharded_eps, sharded_eps_from_apply,
                      trunk_apply)

__all__ = ["AFFINITY_HEALTH_MIN", "PoolFleet", "PoolState", "SlotPool",
           "affinity_pool", "pick_pool",
           "make_trunk_params", "trunk_apply", "make_unsharded_eps",
           "make_sharded_eps", "sharded_eps_from_apply"]
