"""Documented stats() / probe-frame schemas: the exporter contract (port
of ``repro/obs/schema.py``; the key sets are the same).

``ContinuousBatchingEngine.stats()``, ``SlotPool.stats()`` and
``PoolFleet.stats()`` are registry-backed views whose KEY SETS are frozen
here.  Exporters (the Prometheus snapshot, the console dashboard) key on
these names, so adding a key means updating this module, and removing or
renaming one is a breaking change.

The probe frame is a (slots, len(PROBE_COLUMNS)) float32 matrix whose
column ORDER is part of the contract (flight postmortems and the
dashboard's quality columns index into it), and every flight-recorder
JSONL record is keyed by the field names below.
"""
from __future__ import annotations

ENGINE_STATS_KEYS = frozenset({
    "pool_id", "mesh", "state_sharded", "slots", "active",
    "ticks", "tick_variant", "slot_steps", "occupancy",
    "completed", "dropped", "cancelled", "resumed",
    "deadline_missed", "previews_sent",
    "queued", "queue_rejected",
    "tick_wall_s", "tick_ewma_s", "steps_per_s", "compiled_ticks",
    "plan_bank", "bank_selected",
    "stochastic", "preview", "max_order", "mega_tick", "dtype", "donated",
    "probes", "probe_frames", "probe_defect_max", "probe_finite_min",
})

# device-probe frame columns, IN ORDER (obs/probes.py fills them; a probe
# disabled in the engine's ProbeSpec reports NaN in its columns so the
# frame shape never depends on the spec):
#   eps_rms      per-slot RMS of the current eps evaluation (live elements)
#   x0_min/max/mean   range stats of the Eq. 12 predicted x0
#   finite_frac  fraction of the post-step state that is finite
#   defect       one-eval step-doubling defect proxy: RMS drift of eps
#                since the previous tick's evaluation (NaN at a slot's
#                first step — there is no previous eval yet)
PROBE_COLUMNS = ("eps_rms", "x0_min", "x0_max", "x0_mean",
                 "finite_frac", "defect")

# flight-recorder JSONL records (obs/flight.py): one header line, then
# one line per buffered probe frame, oldest first
FLIGHT_HEADER_KEYS = frozenset({
    "record", "version", "reason", "pool", "wall_time", "frames",
    "columns", "attribution", "context",
})
FLIGHT_FRAME_KEYS = frozenset({
    "record", "tick", "now", "pool", "slots", "values",
})
FLIGHT_SCHEMA_VERSION = 1

# a SlotPool's stats() is its engine's plus the lifecycle/load fields
POOL_STATS_KEYS = ENGINE_STATS_KEYS | frozenset({
    "state", "model", "health", "drained_requests", "pending_steps",
    "weight_swaps",
})

FLEET_STATS_KEYS = frozenset({
    "n_pools", "queued", "queue_rejected",
    "completed", "dropped", "drained_requests",
    "ticks", "slot_steps", "occupancy", "mega_tick_ratio",
    "tick_ewma_s", "pools",
})

# the gateway tier's stats() (serving/gateway/core.py, JAX's keys):
# front-door admission/overload/stream counters plus the wrapped
# fleet's stats dict; "resilience" is the pool supervisor's tree
GATEWAY_STATS_KEYS = frozenset({
    "requests", "rejected", "shed", "expired",
    "cancelled", "nonfinite",
    "streams", "previews_streamed", "results_streamed",
    "swaps", "models", "queue_depth", "fleet", "resilience",
})
