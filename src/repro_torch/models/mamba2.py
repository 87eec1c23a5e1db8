"""Mamba2 (SSD, state-space duality) blocks of zamba2-2.7b (port of
``repro/models/mamba2.py``).

Recurrence per head h (head_dim P, state N):
  a_t   = exp(dt_t * A)                       (scalar decay per head/step)
  state = a_t * state + dt_t * x_t (x) B_t    -> (P, N)
  y_t   = state @ C_t + D * x_t

``forward`` and prefill run the chunked SSD, as JAX does: chunks of L =
``CHUNK`` steps, with c_i the within-chunk cumulated log-decay,
  intra: Y[i] = sum_{j<=i} exp(c_i - c_j) (C_i . B_j) dt_j x_j
  state: S_c  = sum_j exp(c_L - c_j) dt_j x_j (x) B_j
  inter: H_c  = exp(c_L) H_{c-1} + S_c ;  Y[i] += exp(c_i) (C_i . H_{c-1})
The (L, L) products are batched matrix products; the inter-chunk carry
is a Python loop over S / L chunks.  ``mamba_decode_step`` runs the
single-token recurrence.  The two sum in another order, so a cached
decode agrees with the chunked forward to a tolerance, not bitwise.

Above the diagonal ``exp(c_i - c_j)`` overflows at zamba2 width (the
exponent is >= 0 and passes 88): the exponent is set to -inf there
before ``exp``, so the forward is JAX's ``jnp.where`` mask bit for bit
and the gradient there is 0 (JAX's is 0 * inf = NaN), never a 0/1
multiply (inf * 0 is NaN).  The three-operand contractions of JAX's einsums are written as two
steps that never form a (B, nc, L, L, H, P) tensor.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng

from .common import (ArchConfig, KeyGen, dense_init, einsum, matmul,
                     rms_norm)

CHUNK = 128  # SSD chunk length


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def _conv_dim(cfg: ArchConfig) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state   # x, B, C go through the conv


def init_mamba_params(kg: KeyGen, cfg: ArchConfig,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One block's leaves in JAX's key order (``mamba2.py:38``).  Two
    leaves are not plain draws: ``A_log = log(linspace(1, 16, H))`` and
    ``dt_bias = log(expm1(exp(u (log 0.1 - log 1e-3) + log 1e-3)))`` of a
    uniform u, both in float32 torch ops (within a few ulps of XLA's)."""
    d, di = cfg.d_model, d_inner(cfg)
    H, N = n_ssm_heads(cfg), cfg.ssm_state
    cd = _conv_dim(cfg)
    w_in = dense_init(kg(), (d, 2 * di + 2 * N + H), dtype)
    dev = w_in.device
    conv_w = dense_init(kg(), (cfg.ssm_conv, cd), dtype,
                        scale=cfg.ssm_conv ** -0.5)
    u = prng.uniform(kg(), (H,))
    lo = torch.log(torch.tensor(1e-3, dtype=torch.float32, device=dev))
    hi = torch.log(torch.tensor(0.1, dtype=torch.float32, device=dev))
    dt_bias = torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo)))
    return {
        # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((cd,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        "dt_bias": dt_bias.to(dtype),
        "gate_norm": torch.ones((di,), dtype=dtype, device=dev),
        "w_out": dense_init(kg(), (di, d), dtype),
    }


def mamba_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """``init_mamba_params``' leaves as a dict of shapes."""
    d, di = cfg.d_model, d_inner(cfg)
    H, N, cd = n_ssm_heads(cfg), cfg.ssm_state, _conv_dim(cfg)
    return {"w_in": (d, 2 * di + 2 * N + H), "conv_w": (cfg.ssm_conv, cd),
            "conv_b": (cd,), "A_log": (H,), "D": (H,), "dt_bias": (H,),
            "gate_norm": (di,), "w_out": (di, d)}


def _split_in(proj: torch.Tensor, cfg: ArchConfig):
    """The z | x | B | C | dt column blocks of ``x @ w_in``."""
    di = d_inner(cfg)
    N = cfg.ssm_state
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    B = proj[..., 2 * di:2 * di + N]
    C = proj[..., 2 * di + N:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:]
    return z, x, B, C, dt


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time, then SiLU.  seq: (B, S, Cd);
    prev: (B, K-1, Cd), the carry-in from the previous segment.  Returns
    (out, new carry: the last K-1 rows)."""
    K = w.shape[0]
    full = torch.cat([prev, seq], dim=1)
    out = sum(full[:, i:i + seq.shape[1]] * w[i] for i in range(K))
    new_prev = full[:, full.shape[1] - (K - 1):]
    return F.silu(out + b), new_prev


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x: (Bt, S, H, P), dt: (Bt, S, H), A: (H,) negative,
    B / C: (Bt, S, N) (one group, broadcast over heads), state0:
    (Bt, H, P, N).  Returns (y (Bt, S, H, P), final float32 state); y is
    in the operands' promoted type, float32 in bfloat16 since ``A`` is
    float32, as JAX's is."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    L = min(CHUNK, S)
    S_in = S
    if S % L:
        # pad with dt = 0 steps: decay exp(0) = 1 and zero input leave the
        # recurrence untouched; padded outputs are sliced off below.
        pad = L - S % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        S = S + pad
    nc = S // L

    xr = x.reshape(Bt, nc, L, H, P)
    dtr = dt.reshape(Bt, nc, L, H)
    Br = B.reshape(Bt, nc, L, N)
    Cr = C.reshape(Bt, nc, L, N)

    loga = dtr * A                                       # (Bt,nc,L,H), <= 0
    cum = torch.cumsum(loga, dim=2)                      # within-chunk
    total = cum[:, :, -1]                                # (Bt,nc,H)

    # intra-chunk: M[i,j] = exp(cum_i - cum_j) * (C_i . B_j), j <= i
    scores = einsum("bcln,bcmn->bclm", Cr, Br)     # (Bt,nc,L,L)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (Bt,nc,L,L,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # exp only below the diagonal: above it decay > 0 can overflow to inf,
    # and where(mask, exp(decay), 0)'s gradient there is 0 * inf = NaN
    # (JAX's is).  exp(-inf) = 0 gives the same forward bits, a 0 gradient.
    M = torch.exp(decay.masked_fill(~mask[None, None, :, :, None],
                                    float("-inf"))) * scores[..., None]
    # "bclmh,bcmh,bcmhp->bclhp": dt_j folds into M, then one product over m
    y = einsum("bclmh,bcmhp->bclhp", M * dtr[:, :, None], xr)
    del M, decay

    # chunk summaries: S_c = sum_j exp(total - cum_j) dt_j x_j (x) B_j
    w_j = torch.exp(total[:, :, None] - cum) * dtr        # (Bt,nc,L,H)
    chunk_states = einsum("bclhp,bcln->bchpn", w_j[..., None] * xr,
                          Br).float()

    # inter-chunk carries; each chunk sees the state BEFORE it
    h = state0.float()
    before = []
    for c in range(nc):
        before.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + chunk_states[:, c]
    h_before = torch.stack(before, dim=1)                # (Bt,nc,H,P,N)

    # inter-chunk contribution: y[i] += exp(cum_i) * C_i . H_{c-1}
    y = y + torch.exp(cum)[..., None] * einsum(
        "bcln,bchpn->bclhp", Cr, h_before)
    y = y + D[None, None, :, None] * xr
    return y.reshape(Bt, S, H, P)[:, :S_in], h


def _in_proj(params: Dict, cfg: ArchConfig, x: torch.Tensor,
             conv_state: torch.Tensor):
    """in_proj, the causal conv over [x | B | C], softplus(dt + bias) and
    A = -exp(A_log): (z, xs, B, C, dt, A, new conv carry)."""
    di, N = d_inner(cfg), cfg.ssm_state
    proj = matmul(x, params["w_in"])
    z, xs, Bmat, Cmat, dt = _split_in(proj, cfg)
    conv_in = torch.cat([xs, Bmat, Cmat], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"],
                                      params["conv_b"], conv_state)
    xs = conv_out[..., :di]
    Bmat = conv_out[..., di:di + N]
    Cmat = conv_out[..., di + N:]
    dt = F.softplus(dt + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    return z, xs, Bmat, Cmat, dt, A, new_conv


def _out_proj(params: Dict, cfg: ArchConfig, y: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return matmul(y, params["w_out"])


def mamba_forward(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block. x: (B, S, d); conv_state:
    (B, K-1, conv_dim); ssm_state: (B, H, P, N).  Returns (out, new conv
    state, new ssm state)."""
    Bt, S, _ = x.shape
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim
    z, xs, Bmat, Cmat, dt, A, new_conv = _in_proj(params, cfg, x, conv_state)
    y, new_ssm = ssd_chunked(xs.reshape(Bt, S, H, P), dt, A, Bmat, Cmat,
                             params["D"], ssm_state)
    y = y.reshape(Bt, S, d_inner(cfg)).to(x.dtype)
    return _out_proj(params, cfg, y, z), new_conv, new_ssm.to(ssm_state.dtype)


def mamba_decode_step(params: Dict, cfg: ArchConfig, x: torch.Tensor,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token state update. x: (B, 1, d)."""
    Bt = x.shape[0]
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim
    z, xs, Bv, Cv, dt, A, new_conv = _in_proj(params, cfg, x, conv_state)
    xs = xs[:, 0].reshape(Bt, H, P)
    Bv, Cv, dtv = Bv[:, 0], Cv[:, 0], dt[:, 0]                 # (B,N) (B,H)
    a = torch.exp(dtv * A)                                      # (B,H)
    upd = (dtv[..., None] * xs)[..., None] * Bv[:, None, None, :]
    new_ssm = (a[..., None, None] * ssm_state + upd).to(ssm_state.dtype)
    y = einsum("bhpn,bn->bhp", new_ssm, Cv)
    y = y + params["D"][None, :, None] * xs
    y = y.reshape(Bt, 1, d_inner(cfg)).to(x.dtype)
    return _out_proj(params, cfg, y, z), new_conv, new_ssm


def init_mamba_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (conv (B, K-1, conv_dim), ssm (B, H, P, N)) states."""
    H, P, N = n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    return (torch.zeros((batch, cfg.ssm_conv - 1, _conv_dim(cfg)),
                        dtype=dtype, device=device),
            torch.zeros((batch, H, P, N), dtype=dtype, device=device))
