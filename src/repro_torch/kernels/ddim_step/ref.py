"""Plain PyTorch versions of the legacy DDIM-update kernel (port of
``repro/kernels/ddim_step/ref.py`` and of the body of ``ddim_step_2d`` in
its ``kernel.py``).

  * ``ddim_step_ref`` is the Eq. 12 oracle as the JAX package writes it:
    x0 = (x - sqrt(1-a_t) eps) / sqrt(a_t), then
    c_x0 x0 + c_dir eps + c_noise noise, every op rounded on its own.
  * ``ddim_step_body`` is the kernel's arithmetic, the CPU path of
    ``kernel.ddim_step_2d`` and the yardstick the CUDA kernel
    (``csrc/ddim_step.cu``) is held against on the card.  The coefficients
    are cast to x's dtype first (the JAX kernel passes
    ``coefs.astype(x.dtype)``).  Bitwise probing of the interpret-mode
    kernel on XLA:CPU gives, in float32, the contracted form
        a = c_x0 / sqrt_a_t;  b = fma(-a, sqrt_1m_a_t, c_dir)
        out = fma(c_noise, noise, fma(a, x, b * eps))
    and, in bfloat16, every op rounded to bfloat16 with no contraction.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sampler_step.ref import _fma


def ddim_step_body(x: torch.Tensor, eps: torch.Tensor, noise: torch.Tensor,
                   coefs: torch.Tensor) -> torch.Tensor:
    """The kernel's update over (R, C) tensors of x's dtype; coefs: (5,)
    [c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t]."""
    c = coefs.to(device=x.device, dtype=x.dtype)
    a = c[0] / c[3]
    if x.dtype == torch.float32:
        b = _fma(-a, c[4], c[1])
        return _fma(c[2], noise, _fma(a, x, b * eps))
    b = c[1] - a * c[4]
    return (a * x + b * eps) + c[2] * noise


def ddim_step_ref(x: torch.Tensor, eps: torch.Tensor, noise: torch.Tensor,
                  c_x0, c_dir, c_noise, sqrt_a_t,
                  sqrt_1m_a_t) -> torch.Tensor:
    """Eq. 12 with external noise, in the JAX oracle's op order."""
    x0 = (x - sqrt_1m_a_t * eps) / sqrt_a_t
    return c_x0 * x0 + c_dir * eps + c_noise * noise
