"""Serving surfaces of the port: the lockstep DiffusionSampler and the
continuous-batching scheduler."""
from .engine import DiffusionSampler
from .errors import RejectCode, RequestError
from .scheduler import (AdmissionQueue, ContinuousBatchingEngine,
                        SampleRequest, SampleResult, SlotCheckpoint)

__all__ = ["AdmissionQueue", "ContinuousBatchingEngine", "DiffusionSampler",
           "RejectCode", "RequestError", "SampleRequest", "SampleResult",
           "SlotCheckpoint"]
