"""RETIRED legacy hot path (port of ``repro/kernels/ddim_step/ops.py``):
the StepImpl shim routes through the production sampler-step kernel.

``fused_ddim_step`` keeps its StepImpl signature so old call sites
(``sample(..., step_impl=fused_ddim_step)``) still run, but the update
runs in the deterministic ``sampler_step_2d`` (B1) over the tile layout;
the caller's externally drawn noise is added outside, as in JAX.  So B1
runs once per call on the card, and the legacy B7 (``ddim_step_2d``)
still has no caller.  Each call warns (DeprecationWarning): build a
``repro_torch.sampling.SamplerPlan`` and run the 'tile_resident' backend
instead, which keeps the state in the tile layout for the whole loop
rather than re-entering it every step.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.kernels.sampler_step.ops import (from_tile_layout,
                                                  sampler_step_tiles,
                                                  to_tile_layout)


def _f32(c) -> np.float32:
    if isinstance(c, torch.Tensor):
        c = c.detach().float().cpu().item()
    return np.float32(c)


def _shim(x: torch.Tensor, eps: torch.Tensor, noise, c_x0, c_dir, c_noise,
          sqrt_a_t, sqrt_1m_a_t) -> torch.Tensor:
    # the deterministic kernel computes the Eq. 12 update with c_noise 0;
    # the legacy external noise is applied outside
    coefs = np.array([_f32(c) for c in (c_x0, c_dir, 0.0, sqrt_a_t,
                                        sqrt_1m_a_t)], np.float32)
    x2, n = to_tile_layout(x)
    e2, _ = to_tile_layout(eps)
    out2 = sampler_step_tiles(x2.contiguous(), e2.contiguous(), coefs, None,
                              clip=None, stochastic=False)
    out = from_tile_layout(out2, n, x.shape)
    if noise is not None:
        out = out + torch.as_tensor(c_noise, device=out.device).to(
            out.dtype) * noise
    return out


def fused_ddim_step(x: torch.Tensor, eps: torch.Tensor, noise, c_x0, c_dir,
                    c_noise, sqrt_a_t, sqrt_1m_a_t) -> torch.Tensor:
    """DEPRECATED drop-in StepImpl, backed by ``kernels/sampler_step``.

    ``noise`` may be None (the deterministic path): the noise term is
    skipped entirely.  Each call still pays the pad -> kernel -> unpad
    round trip; a SamplerPlan 'tile_resident' run has none.
    """
    warnings.warn(
        "kernels.ddim_step.fused_ddim_step is deprecated: build a "
        "repro_torch.sampling.SamplerPlan and run backend='tile_resident' "
        "(kernels/sampler_step) instead",
        DeprecationWarning, stacklevel=2)
    return _shim(x, eps, noise, c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t)
