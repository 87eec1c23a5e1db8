"""Grouped-query attention of the dense trunk (port of
``repro/models/attention.py:29-54,119-145``).

Layouts as the JAX module: activations (B, S, d_model), q (B, S, H, D),
k / v (B, S, Hkv, D).  q head h reads kv head h // (H / Hkv).  The scores
are the dot divided by sqrt(D), plus the additive mask, then a float32
softmax.  The JAX ``FLAGS.attn_chunk`` branch (off by default) is not
ported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .common import (ArchConfig, apply_rope, causal_mask, dense_init,
                     rope_freqs)

_NEG = -1e30  # large-negative instead of -inf: safe under bf16 softmax


def init_gqa_params(generator: torch.Generator, cfg: ArchConfig,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    return {
        "wq": dense_init(generator, (d, H * D), dtype),
        "wk": dense_init(generator, (d, Hkv * D), dtype),
        "wv": dense_init(generator, (d, Hkv * D), dtype),
        "wo": dense_init(generator, (H * D, d), dtype),
    }


def _grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D), mask additive broadcast to
    (B,Hkv,G,Sq,Sk). Returns (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(D)
    scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def gqa_forward(params: Dict[str, torch.Tensor], cfg: ArchConfig,
                x: torch.Tensor, positions: torch.Tensor, causal: bool = True,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill). positions: (B, S)."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q = (x @ params["wq"]).reshape(B, S, H, D)
    k = (x @ params["wk"]).reshape(B, S, Hkv, D)
    v = (x @ params["wv"]).reshape(B, S, Hkv, D)
    cos, sin = rope_freqs(positions, D, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if mask is None:
        if causal:
            mask = causal_mask(S, torch.float32, cfg.sliding_window,
                               device=x.device)
        else:
            mask = torch.zeros((S, S), dtype=torch.float32, device=x.device)
    mask = torch.clamp(mask, min=_NEG)
    out = _grouped_attention(q, k, v, mask)
    return out.reshape(B, S, H * D) @ params["wo"]
