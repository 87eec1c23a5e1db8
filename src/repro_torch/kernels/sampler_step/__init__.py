"""The fused DDIM sampler step: CUDA kernels, plain versions, layout."""
from .kernel import sampler_step_2d, sampler_step_rows_2d

__all__ = ["sampler_step_2d", "sampler_step_rows_2d"]
