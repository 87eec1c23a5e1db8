"""Grouped-query attention of the dense family, Multi-head Latent
Attention (MLA, deepseek-v2) and their caches (port of
``repro/models/attention.py``).

Layouts as the JAX module:
  activations  x: (B, S, d_model)
  q            : (B, S, H, D)
  k, v         : (B, S_kv, H_kv, D)
  KV cache     : dict(k=(L, B, M, H_kv, D), v=(L, B, M, H_kv, D), idx=0-dim
                 int32 tensor on the cache's device); M = max_len, or the
                 sliding window (a ring buffer).
  MLA cache    : dict(ckv=(L, B, M, kv_lora), krope=(L, B, M, rope_dim),
                 idx)
q head h reads kv head h // (H / Hkv).  The scores are the dot divided by
sqrt(D), plus the additive mask, then a float32 softmax.
``FLAGS.attn_chunk`` selects the online-softmax
``chunked_grouped_attention`` where the sequence divides into chunks.

The cache is written in place (``index_copy_`` / ``copy_`` into the
layer's slice of the stacked tensors), the counterpart of the JAX decode
step's donated cache: a step allocates no new cache and reads the slot
from ``idx`` on the device, so it never waits for the host.  MLA keeps
JAX's un-absorbed math: each decode step expands the whole latent cache
through ``w_uk`` / ``w_uv`` (``ckv @ w_uk``), as ``_mla_attend`` does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .common import (ArchConfig, KeyGen, apply_rope, causal_mask,
                     dense_init, einsum, matmul, rms_norm, rope_freqs)
from .runtime_flags import FLAGS

_NEG = -1e30  # large-negative instead of -inf: safe under bf16 softmax


def init_gqa_params(keygen: KeyGen, cfg: ArchConfig,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    return {
        "wq": dense_init(keygen(), (d, H * D), dtype),
        "wk": dense_init(keygen(), (d, Hkv * D), dtype),
        "wv": dense_init(keygen(), (d, Hkv * D), dtype),
        "wo": dense_init(keygen(), (H * D, d), dtype),
    }


def gqa_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, int]]:
    """``init_gqa_params``' leaves as a dict of shapes."""
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.hd(), cfg.n_kv_heads * cfg.hd()
    return {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d)}


def _grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D), mask additive broadcast to
    (B,Hkv,G,Sq,Sk). Returns (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(D)
    scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = einsum("bkgqs,bskd->bqkgd", probs, v)
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
            s = einsum("bqkgd,bckd->bkgqc", qb, kg[:, ki]).float()
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
            acc = alpha * acc + einsum(
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
    q = matmul(x, params["wq"]).reshape(B, S, H, D)
    k = matmul(x, params["wk"]).reshape(B, S, Hkv, D)
    v = matmul(x, params["wv"]).reshape(B, S, Hkv, D)
    cos, sin = rope_freqs(positions, D, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if mask is None and _chunk_applies(S):
        out = chunked_grouped_attention(q, k, v, causal, FLAGS.attn_chunk,
                                        FLAGS.attn_chunk,
                                        window=cfg.sliding_window)
        return matmul(out.reshape(B, S, H * D), params["wo"])
    if mask is None:
        if causal:
            mask = causal_mask(S, torch.float32, cfg.sliding_window,
                               device=x.device)
        else:
            mask = torch.zeros((S, S), dtype=torch.float32, device=x.device)
    mask = torch.clamp(mask, min=_NEG)
    out = _grouped_attention(q, k, v, mask)
    return matmul(out.reshape(B, S, H * D), params["wo"])


def cross_kv(params: Dict[str, torch.Tensor], cfg: ArchConfig,
             kv_src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values of kv_src (B, Sk, d): two
    (B, Sk, Hkv, D) tensors, no RoPE."""
    B, Sk, _ = kv_src.shape
    Hkv, D = cfg.n_kv_heads, cfg.hd()
    return (matmul(kv_src, params["wk"]).reshape(B, Sk, Hkv, D),
            matmul(kv_src, params["wv"]).reshape(B, Sk, Hkv, D))


def cross_attend(params: Dict[str, torch.Tensor], cfg: ArchConfig,
                 x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Queries from x (B, S, d) against given cross keys / values, no
    RoPE, the additive ``mask``; returns (B, S, d)."""
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.hd()
    q = matmul(x, params["wq"]).reshape(B, S, H, D)
    out = _grouped_attention(q, k, v, mask)
    return matmul(out.reshape(B, S, H * D), params["wo"])


def gqa_cross_forward(params: Dict[str, torch.Tensor], cfg: ArchConfig,
                      x: torch.Tensor, kv_src: torch.Tensor) -> torch.Tensor:
    """Cross-attention (enc-dec decoder, ``attention.py:148``): queries
    from x, keys / values from kv_src (the encoder output).  No RoPE
    across modalities and no causal mask: a zero (S, Sk) mask."""
    k, v = cross_kv(params, cfg, kv_src)
    mask = torch.zeros((x.shape[1], kv_src.shape[1]), dtype=torch.float32,
                       device=x.device)
    return cross_attend(params, cfg, x, k, v, mask)


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
    q = apply_rope(matmul(x, params["wq"]).reshape(B, 1, H, D), cos, sin)
    k = apply_rope(matmul(x, params["wk"]).reshape(B, 1, Hkv, D), cos,
                   sin)
    v = matmul(x, params["wv"]).reshape(B, 1, Hkv, D)
    _write_slot(layer_k, slot, k)
    _write_slot(layer_v, slot, v)
    out = _grouped_attention(q, layer_k, layer_v, mask)
    return matmul(out.reshape(B, 1, H * D), params["wo"])


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
    q = matmul(x, params["wq"]).reshape(B, S, H, D)
    k = matmul(x, params["wk"]).reshape(B, S, Hkv, D)
    v = matmul(x, params["wv"]).reshape(B, S, Hkv, D)
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
    return matmul(out.reshape(B, S, H * D), params["wo"]), layer_k, layer_v


# ====================================================================== MLA
def init_mla_params(keygen: KeyGen, cfg: ArchConfig,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

    K / V are compressed into a ``kv_lora``-dim latent c_kv; decode caches
    only (c_kv, k_rope).  Queries go through their own low-rank
    bottleneck when ``q_lora`` is set.  Draws in JAX's key order.
    """
    d, H = cfg.d_model, cfg.n_heads
    qk_nope, qk_rope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qd = qk_nope + qk_rope
    p = {"w_dkv": dense_init(keygen(), (d, cfg.kv_lora), dtype),
         "w_krope": dense_init(keygen(), (d, qk_rope), dtype)}
    p["kv_norm"] = torch.ones((cfg.kv_lora,), dtype=dtype,
                              device=p["w_dkv"].device)
    p["w_uk"] = dense_init(keygen(), (cfg.kv_lora, H * qk_nope), dtype)
    p["w_uv"] = dense_init(keygen(), (cfg.kv_lora, H * dv), dtype)
    p["wo"] = dense_init(keygen(), (H * dv, d), dtype)
    if cfg.q_lora:
        p["w_dq"] = dense_init(keygen(), (d, cfg.q_lora), dtype)
        p["q_norm"] = torch.ones((cfg.q_lora,), dtype=dtype,
                                 device=p["w_dq"].device)
        p["w_uq"] = dense_init(keygen(), (cfg.q_lora, H * qd), dtype)
    else:
        p["wq"] = dense_init(keygen(), (d, H * qd), dtype)
    return p


def _mla_q(params: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora:
        cq = rms_norm(matmul(x, params["w_dq"]), params["q_norm"],
                      cfg.norm_eps)
        q = matmul(cq, params["w_uq"])
    else:
        q = matmul(x, params["wq"])
    return q.reshape(B, S, cfg.n_heads, qd)


def _mla_latent(params: Dict, cfg: ArchConfig, x: torch.Tensor):
    """(c_kv, k_rope before rotation) of x: what the cache holds."""
    ckv = rms_norm(matmul(x, params["w_dkv"]), params["kv_norm"],
                   cfg.norm_eps)
    return ckv, matmul(x, params["w_krope"])


def _mla_scale(cfg: ArchConfig) -> float:
    """1 / sqrt(qk_nope + qk_rope), rounded as JAX's float32 ops round it
    (a float32 square root, then a float32 quotient)."""
    d = np.float32(cfg.qk_nope_dim + cfg.qk_rope_dim)
    return float(np.float32(1.0) / np.sqrt(d))


def _mla_attend_rot(params: Dict, cfg: ArchConfig, q_nope: torch.Tensor,
                    q_rope: torch.Tensor, ckv: torch.Tensor,
                    k_rope: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The MLA attention over rotated q_rope (B,Sq,H,rope) / k_rope
    (B,Sk,rope): the latent expanded through w_uk / w_uv, a float32
    softmax of (q_nope . k_nope + q_rope . k_rope) * scale + mask."""
    B, Sq, H, _ = q_nope.shape
    Sk = ckv.shape[1]
    nope, dv = cfg.qk_nope_dim, cfg.v_head_dim
    k_nope = matmul(ckv, params["w_uk"]).reshape(B, Sk, H, nope)
    v = matmul(ckv, params["w_uv"]).reshape(B, Sk, H, dv)
    scores = (einsum("bqhd,bshd->bhqs", q_nope, k_nope)
              + einsum("bqhd,bsd->bhqs", q_rope, k_rope)) \
        * _mla_scale(cfg)
    scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q_nope.dtype)
    out = einsum("bhqs,bshd->bqhd", probs, v)
    return matmul(out.reshape(B, Sq, H * dv), params["wo"])


def _mla_attend(params: Dict, cfg: ArchConfig, q: torch.Tensor,
                ckv: torch.Tensor, krope: torch.Tensor, mask: torch.Tensor,
                positions_q: torch.Tensor,
                positions_k: torch.Tensor) -> torch.Tensor:
    """Shared MLA attention math (``attention.py:297``). q: (B,Sq,H,qd);
    ckv: (B,Sk,kv_lora); krope: (B,Sk,rope)."""
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    cos_q, sin_q = rope_freqs(positions_q, rope, cfg.rope_theta)
    cos_k, sin_k = rope_freqs(positions_k, rope, cfg.rope_theta)
    q_rope = apply_rope(q[..., nope:], cos_q, sin_q)
    k_rope = apply_rope(krope[:, :, None, :], cos_k, sin_k)[:, :, 0]
    return _mla_attend_rot(params, cfg, q[..., :nope], q_rope, ckv, k_rope,
                           mask)


def _causal(S: int, cfg: ArchConfig, device) -> torch.Tensor:
    return torch.clamp(causal_mask(S, torch.float32, cfg.sliding_window,
                                   device=device), min=_NEG)


def mla_forward(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA (training / the diffusion-LM trunk, which
    is causal here as in JAX)."""
    q = _mla_q(params, cfg, x)
    ckv, krope = _mla_latent(params, cfg, x)
    return _mla_attend(params, cfg, q, ckv, krope,
                       _causal(x.shape[1], cfg, x.device), positions,
                       positions)


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, n_layers: int,
                   dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Stacked latent cache: (n_layers, B, M, kv_lora) c_kv and
    (n_layers, B, M, rope) un-rotated k_rope; M as ``init_kv_cache``."""
    M = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
    return {
        "ckv": torch.zeros((n_layers, batch, M, cfg.kv_lora), dtype=dtype,
                           device=device),
        "krope": torch.zeros((n_layers, batch, M, cfg.qk_rope_dim),
                             dtype=dtype, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_decode_tables(idx: torch.Tensor, B: int, M: int, cfg: ArchConfig
                      ) -> Tuple[torch.Tensor, ...]:
    """What one MLA decode step shares across its layers: the ring slot,
    the incoming token's rotary tables, every slot's rotary tables (the
    position it holds once the token is written, 0 where empty) and the
    (1,1,1,M) additive mask over the held slots."""
    slot = torch.remainder(idx, M).reshape(1).long()
    slot_pos = _ring_slot_positions(idx + 1, M)
    mask = torch.where(slot_pos >= 0, 0.0, _NEG)[None, None, None, :]
    pos_q = idx.to(torch.int32).expand(B, 1)
    pos_k = torch.clamp(slot_pos, min=0)[None].expand(B, M)
    cos_q, sin_q = rope_freqs(pos_q, cfg.qk_rope_dim, cfg.rope_theta)
    cos_k, sin_k = rope_freqs(pos_k, cfg.qk_rope_dim, cfg.rope_theta)
    return slot, cos_q, sin_q, cos_k, sin_k, mask


def mla_decode_attend(layer_ckv: torch.Tensor, layer_krope: torch.Tensor,
                      tables: Tuple[torch.Tensor, ...], params: Dict,
                      cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """One layer's MLA for the incoming token x (B, 1, d), given the
    step's ``mla_decode_tables``: writes its c_kv / k_rope into the
    layer's cache at the slot, then attends over the whole ring (the
    latent expanded through w_uk / w_uv every step, as in JAX)."""
    slot, cos_q, sin_q, cos_k, sin_k, mask = tables
    nope = cfg.qk_nope_dim
    q = _mla_q(params, cfg, x)                               # (B,1,H,qd)
    ckv_new, krope_new = _mla_latent(params, cfg, x)
    _write_slot(layer_ckv, slot, ckv_new)
    _write_slot(layer_krope, slot, krope_new)
    q_rope = apply_rope(q[..., nope:], cos_q, sin_q)
    k_rope = apply_rope(layer_krope[:, :, None, :], cos_k, sin_k)[:, :, 0]
    return _mla_attend_rot(params, cfg, q[..., :nope], q_rope, layer_ckv,
                           k_rope, mask)


def mla_decode_step(layer_ckv: torch.Tensor, layer_krope: torch.Tensor,
                    idx: torch.Tensor, params: Dict, cfg: ArchConfig,
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """One MLA decode step for ONE layer, its cache written in place at
    slot ``idx mod M``.  Returns (attn_out (B,1,d), layer_ckv,
    layer_krope)."""
    tables = mla_decode_tables(idx, x.shape[0], layer_ckv.shape[1], cfg)
    return (mla_decode_attend(layer_ckv, layer_krope, tables, params, cfg,
                              x), layer_ckv, layer_krope)


def mla_prefill(layer_ckv: torch.Tensor, layer_krope: torch.Tensor,
                params: Dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence MLA prefill for one layer, writing the latent cache
    in place: rows [0, S), or the last M rows when S >= M."""
    S = x.shape[1]
    M = layer_ckv.shape[1]
    q = _mla_q(params, cfg, x)
    ckv, krope = _mla_latent(params, cfg, x)
    out = _mla_attend(params, cfg, q, ckv, krope, _causal(S, cfg, x.device),
                      positions, positions)
    if S >= M:
        layer_ckv.copy_(ckv[:, S - M:])
        layer_krope.copy_(krope[:, S - M:])
    else:
        layer_ckv[:, :S].copy_(ckv)
        layer_krope[:, :S].copy_(krope)
    return out, layer_ckv, layer_krope
