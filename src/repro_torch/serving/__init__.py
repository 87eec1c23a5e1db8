"""Serving surfaces of the port: the lockstep DiffusionSampler, the
continuous-batching scheduler, the slot-pool fleet, its resilience layer
and (``serving.gateway``) the HTTP/SSE front door.  JAX's
``ARGenerator`` / ``GenRequest`` / ``GenResult`` are not ported yet."""
from .engine import DiffusionSampler
from .errors import RejectCode, RequestError
from .fleet import PoolFleet, PoolState, SlotPool
from .resilience import (BreakerPolicy, BreakerState, CheckpointStore,
                         FaultInjector, FaultPlan, PoolSupervisor)
from .scheduler import (AdmissionQueue, ContinuousBatchingEngine,
                        SampleRequest, SampleResult, SlotCheckpoint)

__all__ = ["AdmissionQueue", "BreakerPolicy", "BreakerState",
           "CheckpointStore", "ContinuousBatchingEngine", "DiffusionSampler",
           "FaultInjector", "FaultPlan", "PoolFleet", "PoolState",
           "PoolSupervisor", "RejectCode", "RequestError", "SampleRequest",
           "SampleResult", "SlotCheckpoint", "SlotPool"]
