"""Slot-pool fleet (port of ``repro.serving.fleet``): N continuous-batching
slot pools behind a global EDF admission queue with affinity /
least-loaded routing, graceful drain / refill, weight hot-swap on idle
pools and aggregated stats.  On one card the pools share it; the JAX
package's mesh-sharded trunks (``sharded.py``) are not ported."""
from .fleet import PoolFleet
from .pool import PoolState, SlotPool
from .router import AFFINITY_HEALTH_MIN, affinity_pool, pick_pool

__all__ = ["AFFINITY_HEALTH_MIN", "PoolFleet", "PoolState", "SlotPool",
           "affinity_pool", "pick_pool"]
