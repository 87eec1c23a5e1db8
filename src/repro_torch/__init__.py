"""PyTorch + CUDA port of the DDIM sampling service (H100, sm_90a).

Mirrors the layout of the JAX package ``repro``: the counterpart of
``repro/X/Y.py`` is ``repro_torch/X/Y.py``.  This package imports torch and
numpy only — never jax and nothing of ``repro`` — and keeps its own copies
of what it needs.  Entry points run on the CUDA device unless the caller
asks for another (``device="cpu"``); on the CPU every hand-written kernel
is replaced by its plain PyTorch version (``kernels/*/ref.py``).

Ported so far: noise schedules, the SamplerPlan coefficient table, the
eager / tile-resident / rows sampler backends over the two sampler-step
CUDA kernels, the paper's U-Net, and the lockstep ``DiffusionSampler``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
