"""Serving surfaces of the port: the autoregressive ARGenerator, the
lockstep DiffusionSampler, the continuous-batching scheduler, the
slot-pool fleet, its resilience layer and (``serving.gateway``) the
HTTP/SSE front door."""
from .engine import ARGenerator, DiffusionSampler, GenRequest, GenResult
from .errors import RejectCode, RequestError
from .fleet import PoolFleet, PoolState, SlotPool
from .resilience import (BreakerPolicy, BreakerState, CheckpointStore,
                         FaultInjector, FaultPlan, PoolSupervisor)
from .scheduler import (AdmissionQueue, ContinuousBatchingEngine,
                        SampleRequest, SampleResult, SlotCheckpoint)

__all__ = ["ARGenerator", "AdmissionQueue", "BreakerPolicy", "BreakerState",
           "CheckpointStore", "ContinuousBatchingEngine", "DiffusionSampler",
           "FaultInjector", "FaultPlan", "GenRequest", "GenResult",
           "PoolFleet", "PoolState", "PoolSupervisor", "RejectCode",
           "RequestError", "SampleRequest", "SampleResult", "SlotCheckpoint",
           "SlotPool"]
