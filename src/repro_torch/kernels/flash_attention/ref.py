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
  * ``flash_attention_tiles_ref``: the CUDA kernel's float32 tile
    arithmetic (64-row q tiles, its KV tiles in ascending order, 3xTF32
    products), for the CPU tests to hold against the JAX kernel.
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


Q_TILE = 64   # query rows of the CUDA kernel's largest block


def kernel_kv_tile(d: int, dtype: torch.dtype) -> int:
    """KV rows per stage of the CUDA kernel (``Tiles<T, D>::BK`` in
    ``csrc/flash_mma.cuh``): 64, or 32 for float32 at head dim 128."""
    return 4096 // d if dtype == torch.float32 else 64


def kernel_kv_split(bh: int, s: int, n_sm: int) -> int:
    """The warps P that split the KV columns of 16 query rows
    (``with_split`` in ``csrc/flash_attention.cu``): 1 while the 64-row q
    tiles are at least the SMs, else 2 while twice as many are, else 4."""
    tiles = bh * (s // Q_TILE)
    return 1 if tiles >= n_sm else 2 if 2 * tiles >= n_sm else 4


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


def flash_attention_tiles_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = False,
                              kv_split: int = 1) -> torch.Tensor:
    """(BH, S, D) float32 -> (BH, S, D) float32 by the CUDA kernel's
    float32 arithmetic: q tiles of ``Q_TILE / kv_split`` rows, q scaled
    before the dot; for each, the KV tiles of ``kernel_kv_tile`` rows in
    ascending order, under causal up to the one holding the tile's last
    row, the recurrence of ``online_softmax_step`` with both products by
    the 3xTF32 split (``megastep.ref.tf32x3_matmul``).  With ``kv_split`` P > 1 (the
    kernel's choice for grids with fewer q tiles than SMs) every KV tile's
    columns are cut into P slices, each slice runs its own recurrence,
    and the P states merge at the end: m = max m_i, l = sum l_i e^(m_i -
    m), acc likewise, in slice order."""
    from repro_torch.kernels.megastep.ref import tf32x3_matmul
    BH, S, D = q.shape
    bk = kernel_kv_tile(D, torch.float32)
    width, rows = bk // kv_split, Q_TILE // kv_split
    scale = 1.0 / math.sqrt(D)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, S, rows):
        q1 = min(q0 + rows, S)
        qs = q[:, q0:q1].float() * scale
        lead = (BH, q1 - q0, 1)
        rows_i = torch.arange(q0, q1, device=q.device)[:, None]
        cols_i = torch.arange(width, device=q.device)[None, :]
        states = []
        for p in range(kv_split):
            m = torch.full(lead, _NEG, dtype=torch.float32, device=q.device)
            l = torch.zeros(lead, dtype=torch.float32, device=q.device)
            acc = torch.zeros(qs.shape, dtype=torch.float32, device=q.device)
            for k0 in range(0, q1 if causal else S, bk):
                c0 = k0 + p * width
                sc = tf32x3_matmul(
                    qs, k[:, c0:c0 + width].float().transpose(-1, -2))
                if causal:
                    sc = torch.where(rows_i >= c0 + cols_i, sc, _NEG)
                m_new = torch.maximum(m, torch.amax(sc, -1, keepdim=True))
                pr = torch.exp(sc - m_new)
                alpha = torch.exp(m - m_new)
                l = alpha * l + torch.sum(pr, -1, keepdim=True)
                acc = acc * alpha + tf32x3_matmul(
                    pr, v[:, c0:c0 + width].float())
                m = m_new
            states.append((m, l, acc))
        m, l, acc = states[0]
        for mi, li, acci in states[1:]:
            mn = torch.maximum(m, mi)
            a0, a1 = torch.exp(m - mn), torch.exp(mi - mn)
            m, l, acc = mn, l * a0 + li * a1, acc * a0 + acci * a1
        out[:, q0:q1] = acc / torch.clamp(l, min=1e-20)
    return out
