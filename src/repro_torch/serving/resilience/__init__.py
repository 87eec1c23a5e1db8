"""Fault-tolerant serving: deterministic fault injection, pool
quarantine with circuit breakers, and trajectory checkpoint/migrate (port
of ``repro.serving.resilience``).

The layer that turns "one bad pool poisons the bridge" into "one bad
pool is quarantined while the fleet keeps serving" (docs/resilience.md):

  faults.FaultInjector      seeded, replayable fault plans (tick
                            exceptions, NaN-poisoned eps, injected tick
                            latency, mid-stream SSE disconnects) threaded
                            through an OPTIONAL supervisor hook — a
                            disabled injector is ``None`` and the guarded
                            path costs one host-side identity test
  checkpoint.CheckpointStore  latest per-request SlotCheckpoint (the
                            engine's ``snapshot_slot`` output): DDIM's
                            deterministic process makes a slot's
                            ``(x_t rows, k, eps-history)`` a complete
                            trajectory state, so migration is a refill,
                            never a rebuild — eta=0 order-1 resumed
                            output is bit-identical to the uninterrupted
                            run
  supervisor.PoolSupervisor fleet tick wrapper with per-pool circuit
                            breakers: a tick exception quarantines ONLY
                            the offending pool, re-routes its queued and
                            resident work through the global EDF queue
                            (submit stamps preserved, checkpoints
                            attached), probes re-admission with
                            exponential backoff, and feeds a health score
                            into the router
"""
from .checkpoint import CheckpointStore
from .faults import FAULT_KINDS, Fault, FaultPlan, FaultInjector, \
    InjectedFault
from .supervisor import BreakerPolicy, BreakerState, PoolSupervisor

__all__ = [
    "BreakerPolicy", "BreakerState", "CheckpointStore",
    "FAULT_KINDS", "Fault", "FaultInjector", "FaultPlan",
    "InjectedFault", "PoolSupervisor",
]
