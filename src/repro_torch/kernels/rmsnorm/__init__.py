"""Row-wise RMSNorm: the CUDA kernel, its plain version and the padding
wrapper."""
from .kernel import rms_norm_2d
from .ops import rms_norm

__all__ = ["rms_norm", "rms_norm_2d"]
