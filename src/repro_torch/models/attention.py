"""Grouped-query attention of the dense family and its KV cache (port of
``repro/models/attention.py:29-250``, GQA only).

Layouts as the JAX module:
  activations  x: (B, S, d_model)
  q            : (B, S, H, D)
  k, v         : (B, S_kv, H_kv, D)
  KV cache     : dict(k=(L, B, M, H_kv, D), v=(L, B, M, H_kv, D), idx=0-dim
                 int32 tensor on the cache's device); M = max_len, or the
                 sliding window (a ring buffer).
q head h reads kv head h // (H / Hkv).  The scores are the dot divided by
sqrt(D), plus the additive mask, then a float32 softmax.
``FLAGS.attn_chunk`` selects the online-softmax
``chunked_grouped_attention`` where the sequence divides into chunks.

The cache is written in place (``index_copy_`` / ``copy_`` into the
layer's slice of the stacked tensors), the counterpart of the JAX decode
step's donated cache: a step allocates no new cache and reads the slot
from ``idx`` on the device, so it never waits for the host.  MLA (JAX
``:253-377``, deepseek-v2) is not ported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .common import (ArchConfig, apply_rope, causal_mask, dense_init,
                     rope_freqs)
from .runtime_flags import FLAGS

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


def chunked_grouped_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool, q_chunk: int,
                              k_chunk: int, window: int = 0) -> torch.Tensor:
    """Online-softmax attention with (q_chunk, k_chunk) score blocks.

    The JAX package's plain equivalent of its flash kernel (float32
    running max, sum and accumulator; q pre-scaled by 1/sqrt(D); masked
    scores set to -1e30; acc / max(l, 1e-20)).  q: (B,Sq,H,D); k/v:
    (B,Sk,Hkv,D).  Returns (B,Sq,H,D).
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
    assert Sq % qc == 0 and Sk % kc == 0, (Sq, qc, Sk, kc)
    nq, nk = Sq // qc, Sk // kc
    qg = q.reshape(B, nq, qc, Hkv, G, D)
    kg = k.reshape(B, nk, kc, Hkv, D)
    vg = v.reshape(B, nk, kc, Hkv, D)
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=q.dtype, device=q.device)
    r = torch.arange(qc, device=q.device)[:, None]
    c = torch.arange(kc, device=q.device)[None, :]
    blocks = []
    for qi in range(nq):
        qb = qg[:, qi] * scale                            # (B,qc,Hkv,G,D)
        m = torch.full((B, Hkv, G, qc, 1), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, qc, 1), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Hkv, G, qc, D), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            s = torch.einsum("bqkgd,bckd->bkgqc", qb, kg[:, ki]).float()
            rows, cols = qi * qc + r, ki * kc + c
            ok = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                ok &= rows >= cols
            if window:
                ok &= cols > rows - window
            s = torch.where(ok, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(q.dtype), vg[:, ki]).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)
        blocks.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B,qc,Hkv,G,D)
    return torch.cat(blocks, dim=1).reshape(B, Sq, H, D)


def _chunk_applies(S: int) -> bool:
    c = FLAGS.attn_chunk
    return bool(c) and S > c and S % c == 0


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
    if mask is None and _chunk_applies(S):
        out = chunked_grouped_attention(q, k, v, causal, FLAGS.attn_chunk,
                                        FLAGS.attn_chunk,
                                        window=cfg.sliding_window)
        return out.reshape(B, S, H * D) @ params["wo"]
    if mask is None:
        if causal:
            mask = causal_mask(S, torch.float32, cfg.sliding_window,
                               device=x.device)
        else:
            mask = torch.zeros((S, S), dtype=torch.float32, device=x.device)
    mask = torch.clamp(mask, min=_NEG)
    out = _grouped_attention(q, k, v, mask)
    return out.reshape(B, S, H * D) @ params["wo"]


# ---------------------------------------------------------------- KV cache
def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Stacked-over-layers KV cache. For sliding-window configs the buffer is
    a ring of size ``min(window, max_len)``."""
    M = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
    Hkv, D = cfg.n_kv_heads, cfg.hd()
    shape = (n_layers, batch, M, Hkv, D)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def _ring_slot_positions(idx: torch.Tensor, M: int) -> torch.Tensor:
    """Absolute position held by each ring slot after ``idx`` writes.

    Slot i holds position p = n - ((n - i) mod M) with n = idx - 1 (the last
    written position); p < 0 means the slot is still empty.
    """
    n = idx - 1
    i = torch.arange(M, device=idx.device)
    return n - torch.remainder(n - i, M)


def decode_tables(idx: torch.Tensor, B: int, M: int, D: int, theta: float
                  ) -> Tuple[torch.Tensor, ...]:
    """What one decode step shares across its layers: the ring slot
    ``idx mod M`` (a 1-element long tensor), the incoming token's rotary
    tables and the (1,1,1,1,M) additive mask over the ring slots that hold
    a position once it is written."""
    slot = torch.remainder(idx, M).reshape(1).long()
    cos, sin = rope_freqs(idx.to(torch.int32).expand(B, 1), D, theta)
    valid = _ring_slot_positions(idx + 1, M) >= 0
    mask = torch.where(valid, 0.0, _NEG)[None, None, None, None, :]
    return slot, cos, sin, mask


def _write_slot(layer_cache: torch.Tensor, slot: torch.Tensor,
                row: torch.Tensor) -> None:
    """layer_cache[:, slot] = row[:, 0] in place; slot a 1-element tensor."""
    layer_cache.index_copy_(1, slot, row.to(layer_cache.dtype))


def decode_attend(layer_k: torch.Tensor, layer_v: torch.Tensor,
                  tables: Tuple[torch.Tensor, ...], params: Dict,
                  cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """One layer's attention for the incoming token x (B, 1, d), given the
    step's ``decode_tables``: writes its k / v into the layer's cache at
    the slot, then attends over the ring.  Returns attn_out (B, 1, d)."""
    slot, cos, sin, mask = tables
    B = x.shape[0]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q = apply_rope((x @ params["wq"]).reshape(B, 1, H, D), cos, sin)
    k = apply_rope((x @ params["wk"]).reshape(B, 1, Hkv, D), cos, sin)
    v = (x @ params["wv"]).reshape(B, 1, Hkv, D)
    _write_slot(layer_k, slot, k)
    _write_slot(layer_v, slot, v)
    out = _grouped_attention(q, layer_k, layer_v, mask)
    return out.reshape(B, 1, H * D) @ params["wo"]


def gqa_decode_step(layer_k: torch.Tensor, layer_v: torch.Tensor,
                    idx: torch.Tensor, params: Dict, cfg: ArchConfig,
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """One decode step for ONE layer.

    layer_k/layer_v: (B, M, Hkv, D) this layer's cache, written in place at
    slot ``idx mod M``; idx: tokens written so far (== position of the
    incoming token), a 0-dim tensor. x: (B, 1, d).
    Returns (attn_out (B,1,d), layer_k, layer_v).
    """
    tables = decode_tables(idx, x.shape[0], layer_k.shape[1], cfg.hd(),
                           cfg.rope_theta)
    return (decode_attend(layer_k, layer_v, tables, params, cfg, x),
            layer_k, layer_v)


def gqa_prefill(layer_k: torch.Tensor, layer_v: torch.Tensor, params: Dict,
                cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence prefill for one layer, writing the cache in place:
    rows [0, S), or the last M rows of the prompt when S >= M.
    Returns (attn_out (B,S,d), layer_k, layer_v)."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    M = layer_k.shape[1]
    q = (x @ params["wq"]).reshape(B, S, H, D)
    k = (x @ params["wk"]).reshape(B, S, Hkv, D)
    v = (x @ params["wv"]).reshape(B, S, Hkv, D)
    cos, sin = rope_freqs(positions, D, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if _chunk_applies(S):
        out = chunked_grouped_attention(q, k, v, True, FLAGS.attn_chunk,
                                        FLAGS.attn_chunk,
                                        window=cfg.sliding_window)
    else:
        mask = torch.clamp(causal_mask(S, torch.float32, cfg.sliding_window,
                                       device=x.device), min=_NEG)
        out = _grouped_attention(q, k, v, mask)
    if S >= M:
        layer_k.copy_(k[:, S - M:])
        layer_v.copy_(v[:, S - M:])
    else:
        layer_k[:, :S].copy_(k)
        layer_v[:, :S].copy_(v)
    return out.reshape(B, S, H * D) @ params["wo"], layer_k, layer_v
