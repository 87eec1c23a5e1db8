"""Plain PyTorch version of the RMSNorm kernel (port of
``repro/kernels/rmsnorm/ref.py`` and of ``rms_norm_body``).

The CPU path of ``kernel.rms_norm_2d`` and the yardstick the CUDA kernel
(``csrc/rmsnorm.cu``) is held against on the card.  Same op order as
``repro_torch.models.common.rms_norm``: float32 mean of squares,
``rsqrt(ms + eps)`` cast to x's dtype, then ``(x * inv) * scale``.
"""
from __future__ import annotations

import torch


def rms_norm_body(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """RMSNorm over the last axis, any leading shape."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return (x * inv) * scale
