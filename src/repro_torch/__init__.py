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
files (``training.checkpoint``), the U-Net serving CLI
(``launch.serve``), and autoregressive serving of every LM family of the
JAX package, dense, moe (MLA or GQA), ssm (rwkv6), hybrid (Mamba2 +
shared attention), audio (enc-dec) and vlm: the cache paths
(``models.dense``, ``moe``, ``rwkv6``, ``mamba2``, ``hybrid``,
``encdec``, ``vlm``, ``attention``), the family registry
(``models.get_api``), the architecture configs (``configs.get``),
``serving.ARGenerator`` and the CLI's ``--arch`` LM paths; JAX's random
draws from one seed (``prng``: threefry keys, bits, ``normal``,
``randint``, ``truncated_normal``) at every draw site, the initial
weights of every family included; training: the synthetic data
(``data``), the optimizers and train steps (``training``) and the
training CLI (``launch.train``); and the rest of ``core``: the paper's
App. A multinomial process (``core.discrete``), the v-prediction and
guidance adapters (``core.extensions``) and the retired StepImpl shim
(``kernels.ddim_step.fused_ddim_step``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
