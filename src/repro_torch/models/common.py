"""Shared model building blocks (port of ``repro/models/common.py``).

The sinusoidal time embedding (U-Net and diffusion-LM), the architecture
config, the dense-trunk numerics (RMSNorm, SwiGLU, rotary embeddings, the
causal mask) and the dense inits.  Each keeps the JAX function's op order,
so float32 results differ only by the order of the sums inside matrix
products.  The inits draw the JAX distributions from a ``torch.Generator``
on its own device: the same scheme, not the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (``repro/models/common.py:22``): the fields the
    dense family reads.  MoE / MLA / SSM / enc-dec fields are not ported.
    """

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""
    head_dim: Optional[int] = None  # default d_model // n_heads
    tie_embeddings: bool = False   # logits = h @ embed.T (no "unembed")
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    sliding_window: int = 0        # 0 = full attention

    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> None:
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")


def causal_mask(S: int, dtype=torch.float32, window: int = 0,
                device=None) -> torch.Tensor:
    """(S, S) additive mask; optional sliding window (local attention)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = j <= i
    if window:
        ok &= j > i - window
    return torch.where(ok, 0.0, float("-inf")).to(dtype)


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal ([-3, 3]) fan-in init, fan_in = shape[0]."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.mul_(std).to(dtype)


def embed_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype) -> torch.Tensor:
    """normal * 0.02, drawn and scaled in one buffer (``torch.randn``'s
    numbers: it is ``empty().normal_()``)."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    w.normal_(generator=generator)
    return w.mul_(0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """float32 mean of squares, rsqrt cast to x's dtype, (x * inv) * scale
    (``common.py:84-85``)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    g = F.silu(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def rope_freqs(positions: torch.Tensor, dim: int,
               theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings. positions: (..., S) int.

    Returns two (..., S, dim/2) float32 tensors.
    """
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin broadcastable to (..., S, D/2).

    The head dim splits into two HALVES (not interleaved pairs).
    """
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


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
        emb = F.pad(emb, (0, 1))
    return emb
