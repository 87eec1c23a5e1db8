"""PyTorch + CUDA port of the DDIM sampling service (H100, sm_90a).

Mirrors the layout of the JAX package ``repro``: the counterpart of
``repro/X/Y.py`` is ``repro_torch/X/Y.py``.  This package imports torch and
numpy only — never jax and nothing of ``repro`` — and keeps its own copies
of what it needs.  Entry points run on the CUDA device unless the caller
asks for another (``device="cpu"``); on the CPU every hand-written kernel
is replaced by its plain PyTorch version (``kernels/*/ref.py``).

Ported so far: noise schedules, the SamplerPlan coefficient table and
its backends (eager, tile-resident, rows, mega) over the CUDA kernels, the
paper's U-Net and the dense diffusion-LM trunk, the ODE view (encode /
decode / interpolation), the lockstep ``DiffusionSampler`` and the
continuous-batching scheduler, the sample-quality metrics and ELBO table
(``eval``), the trajectory autotuner with its plan bank (``autoplan``),
serving telemetry (``obs``: metrics, spans, device probes, flight
recorder, profiler ranges) with the engine's weight hot-swap, the
slot-pool fleet (``serving.fleet``), the HTTP/SSE gateway and the
resilience layer (``serving.gateway``, ``serving.resilience``), checkpoint
files (``training.checkpoint``) and the U-Net serving CLI
(``launch.serve``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
