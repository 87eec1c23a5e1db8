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
    products, the head dim zero-padded to the kernel's width, a ragged
    last tile), for the CPU tests to hold against the JAX kernel; past
    head dim 256 the XL kernel's (its output slices take the same scores,
    so the arithmetic of an output element is that of one slice).
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
# The head widths the one-pass CUDA kernel is built at (``csrc/*.cu`` but
# ``*_xl.cu``): a head dim d up to 256 runs at the least width >= d,
# zero-padded (width - d < 32).
HEAD_WIDTHS = (32, 64, 96, 128, 160, 192, 224, 256)
MAX_HEAD_DIM = HEAD_WIDTHS[-1]
# Past 256 the XL kernel (``csrc/flash_xl.cuh``) streams the scores over
# the depth in chunks of XL_DEPTH (d zero-padded to whole chunks) and
# writes the output in slices of XL_SLICE columns, one block each.
XL_DEPTH = 64
XL_SLICE = 256


def kernel_head_width(d: int) -> int:
    """The width the CUDA kernel runs head dim ``d`` at: ``D`` of
    ``flash_mma_kernel`` up to 256, past it the XL kernel's depth padded
    to whole chunks."""
    if d < 1:
        raise ValueError(f"the CUDA kernel takes head dims from 1, got {d}")
    if d <= MAX_HEAD_DIM:
        return next(w for w in HEAD_WIDTHS if w >= d)
    return -(-d // XL_DEPTH) * XL_DEPTH


def kernel_slices(d: int) -> int:
    """Output slices (grid z) of the CUDA kernel at head dim ``d``: one up
    to 256, else ceil(d / XL_SLICE), each recomputing the scores."""
    return 1 if d <= MAX_HEAD_DIM else -(-d // XL_SLICE)


def kernel_kv_tile(d: int, dtype: torch.dtype) -> int:
    """KV rows per stage of the CUDA kernel (``Tiles<T, D>::BK`` in
    ``csrc/flash_mma.cuh``; the XL kernel's are those of width 256) at
    head dim ``d``: 64, or 32 for float32 past width 64."""
    if dtype == torch.float32 and kernel_head_width(d) > 64:
        return 32
    return 64


def kernel_kv_split(bh: int, s: int, n_sm: int, d: int = 1) -> int:
    """The warps P that split the KV columns of 16 query rows
    (``with_split`` in ``csrc/flash_launch.cuh``): 1 while the 64-row q
    tiles (the last one ragged) are at least the SMs, else 2 while twice
    as many are, else 4.  The XL kernel (head dim ``d`` past 256) never
    splits."""
    if d > MAX_HEAD_DIM:
        return 1
    tiles = bh * -(-s // Q_TILE)
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
    float32 arithmetic: the head dim zero-padded to the kernel's width and
    S to whole tiles; q tiles of ``Q_TILE / kv_split`` rows, q scaled (by
    1 / sqrt(D) of the true D) before the dot; for each, the KV tiles of
    ``kernel_kv_tile`` rows in ascending order, scores at or past S (and,
    under causal, above the diagonal) masked to -1e30, the recurrence of
    ``online_softmax_step`` with both products by the 3xTF32 split
    (``megastep.ref.tf32x3_matmul``).  With ``kv_split`` P > 1 (the
    kernel's choice for grids with fewer q tiles than SMs) every KV tile's
    columns are cut into P slices, each slice runs its own recurrence, and
    the P states merge at the end: m = max m_i, l = sum l_i e^(m_i - m),
    acc likewise, in slice order.

    Every q tile and slice runs as one batch over the KV tiles up to the
    last real row's: where the kernel stops a q tile at its own diagonal,
    the later tiles are masked whole, and add p = 0 with alpha = 1 to a
    slice that has seen a real score (the same bits), or carry weight 0
    into the merge."""
    from repro_torch.kernels.megastep.ref import tf32x3_matmul
    BH, S, D = q.shape
    W = kernel_head_width(D)
    bk = kernel_kv_tile(D, torch.float32)
    P = kv_split
    width, rows = bk // P, Q_TILE // P
    nq = -(-S // rows)                    # q tiles that hold a real row
    s_pad = -(-S // Q_TILE) * Q_TILE      # a multiple of every tile
    qp, kp, vp = (torch.nn.functional.pad(t.float(), (0, W - D, 0, s_pad - S))
                  for t in (q, k, v))
    qs = (qp[:, :nq * rows] * (1.0 / math.sqrt(D))).reshape(
        BH, nq, 1, rows, W)
    row = torch.arange(nq * rows, device=q.device).reshape(nq, 1, rows, 1)
    col = (torch.arange(P, device=q.device).reshape(P, 1, 1) * width
           + torch.arange(width, device=q.device))        # (P, 1, width)
    lead = (BH, nq, P, rows, 1)
    m = torch.full(lead, _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(lead, dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, nq, P, rows, W), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, min(nq * rows, S) if causal else S, bk):
        kt, vt = (t[:, k0:k0 + bk].reshape(BH, 1, P, width, W)
                  for t in (kp, vp))
        sc = tf32x3_matmul(qs, kt.transpose(-1, -2))    # (BH, nq, P, rows, w)
        keep = k0 + col < S
        if causal:
            keep = keep & (row >= k0 + col)
        sc = torch.where(keep, sc, _NEG)
        m_new = torch.maximum(m, torch.amax(sc, -1, keepdim=True))
        pr = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(pr, -1, keepdim=True)
        acc = acc * alpha + tf32x3_matmul(pr, vt)
        m = m_new
    mm, ll, aa = m[:, :, 0], l[:, :, 0], acc[:, :, 0]
    for i in range(1, P):
        mn = torch.maximum(mm, m[:, :, i])
        a0, a1 = torch.exp(mm - mn), torch.exp(m[:, :, i] - mn)
        mm, ll, aa = mn, ll * a0 + l[:, :, i] * a1, aa * a0 + acc[:, :, i] * a1
    out = (aa / torch.clamp(ll, min=1e-20)).reshape(BH, nq * rows, W)
    return out[:, :S, :D].contiguous()
