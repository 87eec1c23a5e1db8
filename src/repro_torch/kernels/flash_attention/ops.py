"""(B, H, S, D) MHA and (B, S, H, D) GQA layouts -> the flash kernel
(port of ``repro/kernels/flash_attention/ops.py``)."""
from __future__ import annotations

import torch

from .kernel import flash_attention


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, block_q: int = 128,
              block_k: int = 128) -> torch.Tensor:
    """q/k/v: (B, H, S, D) -> (B, H, S, D)."""
    B, H, S, D = q.shape
    out = flash_attention(q.reshape(B * H, S, D).contiguous(),
                          k.reshape(B * H, S, D).contiguous(),
                          v.reshape(B * H, S, D).contiguous(),
                          causal=causal, block_q=block_q, block_k=block_k)
    return out.reshape(B, H, S, D)


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, Hkv, D) — models.attention layout.
    q head h reads kv head h // (H / Hkv)."""
    G = q.shape[2] // k.shape[2]
    kr = torch.repeat_interleave(k, G, dim=2)
    vr = torch.repeat_interleave(v, G, dim=2)
    out = mha_flash(q.transpose(1, 2), kr.transpose(1, 2),
                    vr.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)
