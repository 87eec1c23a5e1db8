"""The legacy fused DDIM update with external noise (B7): the CUDA kernel,
its plain version and the Eq. 12 oracle.  No sampling path calls it; the
sampler-step kernels (``kernels/sampler_step``) replaced it, and the
deprecated StepImpl shim ``fused_ddim_step`` (``ops.py``) runs B1."""
from .kernel import ddim_step_2d
from .ops import fused_ddim_step
from .ref import ddim_step_ref

__all__ = ["ddim_step_2d", "ddim_step_ref", "fused_ddim_step"]
