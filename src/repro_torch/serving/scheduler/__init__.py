"""Step-multiplexed continuous-batching scheduler for DDIM serving (port
of ``repro.serving.scheduler``): resident slots, one tick per step over
the per-row sampler-step kernel (or the fused scheduler-tick megakernel),
mid-flight admission and retirement, deadlines and x0 previews."""
from .engine import ContinuousBatchingEngine
from .queue import AdmissionQueue
from .request import SampleRequest, SampleResult, SlotCheckpoint

__all__ = ["AdmissionQueue", "ContinuousBatchingEngine", "SampleRequest",
           "SampleResult", "SlotCheckpoint"]
