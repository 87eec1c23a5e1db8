"""Serving surfaces of the port: the lockstep DiffusionSampler, the
continuous-batching scheduler and the slot-pool fleet."""
from .engine import DiffusionSampler
from .errors import RejectCode, RequestError
from .fleet import PoolFleet, PoolState, SlotPool
from .scheduler import (AdmissionQueue, ContinuousBatchingEngine,
                        SampleRequest, SampleResult, SlotCheckpoint)

__all__ = ["AdmissionQueue", "ContinuousBatchingEngine", "DiffusionSampler",
           "PoolFleet", "PoolState", "RejectCode", "RequestError",
           "SampleRequest", "SampleResult", "SlotCheckpoint", "SlotPool"]
