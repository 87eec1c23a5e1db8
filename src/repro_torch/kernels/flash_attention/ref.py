"""Plain PyTorch versions for the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py`` and of the bodies in its
``kernel.py``).

  * ``attention_ref``: standard (causal or full) softmax attention.
  * ``online_softmax_step`` / ``streaming_attention_body``: the streaming-
    softmax recurrence over KV blocks (kernel.py:28, :55), which the
    megastep 'flash' trunk inlines.
  * ``flash_attention_ref``: the plain version of the kernel itself, the
    CPU path of ``kernel.flash_attention`` and its yardstick on the card.
    It runs the recurrence over KV blocks of ``block_k`` for all query rows
    at once: the TPU kernel's query blocks only partition the rows, and the
    KV blocks it skips above the causal diagonal would add p = 0 with
    alpha = 1, so the result is the same.
"""
from __future__ import annotations

import math

import torch

_NEG = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False) -> torch.Tensor:
    """q, k, v: (B, H, S, D) -> (B, H, S, D), softmax in float32."""
    D = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D)
    if causal:
        S = q.shape[2]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)


def online_softmax_step(q, k, v, m_prev, l_prev, acc_prev, *, q_start: int,
                        k_start: int, causal: bool):
    """One KV-block update; q pre-scaled, all float32, leading batch dims
    allowed.  Returns (m, l, acc)."""
    s = q @ k.transpose(-1, -2)
    if causal:
        bq, bk = s.shape[-2:]
        rows = q_start + torch.arange(bq, device=s.device)[:, None]
        cols = k_start + torch.arange(bk, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, _NEG)
    m_cur = torch.amax(s, dim=-1, keepdim=True)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + torch.sum(p, dim=-1, keepdim=True)
    acc = acc_prev * alpha + p @ v
    return m_new, l_new, acc


def streaming_attention_body(q, k, v, *, scale: float, causal: bool = False,
                             block_k: int = 128) -> torch.Tensor:
    """Whole-sequence attention by the recurrence: q, k, v (..., S, D)
    float32.  Returns acc / max(l, 1e-20)."""
    S = q.shape[-2]
    bk = min(block_k, S)
    qs = q * scale
    lead = q.shape[:-1] + (1,)
    m = torch.full(lead, _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(lead, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, S, bk):           # ragged tail = one narrower block
        k1 = min(k0 + bk, S)
        m, l, acc = online_softmax_step(
            qs, k[..., k0:k1, :], v[..., k0:k1, :], m, l, acc,
            q_start=0, k_start=k0, causal=causal)
    return acc / torch.clamp(l, min=1e-20)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        block_k: int = 128) -> torch.Tensor:
    """(BH, S, D) in any float dtype -> (BH, S, D) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = streaming_attention_body(q.float(), k.float(), v.float(),
                                   scale=scale, causal=causal,
                                   block_k=block_k)
    return out.to(q.dtype)
