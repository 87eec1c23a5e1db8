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
    in bfloat16, every op rounded to bfloat16 with no contraction; and in
    float16 the same contraction with each contracted op rounded once,
    straight to float16 (a float32 result rounded again to float16 differs
    where it sits on a float16 midpoint):
        a = f16(c_x0 / sqrt_a_t);  b = f16(fma(-a, sqrt_1m_a_t, c_dir))
        out = f16(fma(c_noise, noise, f16(fma(a, x, f16(b * eps)))))
    ``_round_f16`` rounds the float64 fma once: PyTorch's float64 to
    float16 cast goes through float32 and rounds twice.  A float32 x over
    bfloat16 or float16 eps / noise widens them first (JAX promotes them
    to float32; the widening is exact), then takes the float32 form.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sampler_step.ref import _fma


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float64: exact for float16 operands within 2^30 of
    each other (the product of two float16 is exact in float32)."""
    return a.double() * b.double() + c.double()


def _round_f16(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float16 rounded once, to nearest even: float32 rounded to
    odd first (truncated toward zero, its last bit set where inexact), which
    keeps the bits float16's rounding needs, then float16."""
    t = v.float()
    back = t.double()
    bits = t.view(torch.int32) - (back.abs() > v.abs()).to(torch.int32)
    bits = bits | (back != v).to(torch.int32)
    return bits.view(torch.float32).half()


def ddim_step_body(x: torch.Tensor, eps: torch.Tensor, noise: torch.Tensor,
                   coefs: torch.Tensor) -> torch.Tensor:
    """The kernel's update over (R, C) tensors of x's dtype; coefs: (5,)
    [c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t]."""
    c = coefs.to(device=x.device, dtype=x.dtype)
    a = c[0] / c[3]
    if x.dtype == torch.float32:
        eps, noise = eps.float(), noise.float()
        b = _fma(-a, c[4], c[1])
        return _fma(c[2], noise, _fma(a, x, b * eps))
    if x.dtype == torch.float16:
        b = _round_f16(_fma64(-a, c[4], c[1]))
        s = _round_f16(_fma64(a, x, b * eps))
        return _round_f16(_fma64(c[2], noise, s))
    b = c[1] - a * c[4]
    return (a * x + b * eps) + c[2] * noise


def ddim_step_ref(x: torch.Tensor, eps: torch.Tensor, noise: torch.Tensor,
                  c_x0, c_dir, c_noise, sqrt_a_t,
                  sqrt_1m_a_t) -> torch.Tensor:
    """Eq. 12 with external noise, in the JAX oracle's op order."""
    x0 = (x - sqrt_1m_a_t * eps) / sqrt_a_t
    return c_x0 * x0 + c_dir * eps + c_noise * noise
