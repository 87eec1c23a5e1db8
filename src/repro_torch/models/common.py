"""Shared model building blocks (port of ``repro/models/common.py``).

Only what the U-Net needs so far: the sinusoidal time embedding.
"""
from __future__ import annotations

import math

import torch


def sinusoidal_time_embedding(t: torch.Tensor, dim: int,
                              max_period: float = 10000.0) -> torch.Tensor:
    """Transformer/DDPM sinusoidal embedding of integer timesteps, float32.

    t: (B,) integer tensor.  Returns (B, dim) float32 [cos | sin].
    """
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
