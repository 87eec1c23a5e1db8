"""Plain PyTorch versions of the megastep kernels (port of
``repro/kernels/megastep/ref.py`` and of ``eps_exact`` / ``eps_flash`` in
its ``kernel.py``).

The CPU path of ``kernel.megastep_call`` / ``kernel.megastep_rows_call``
and the yardstick the CUDA kernels (``csrc/megastep.cu``) are held against
on the card: per fused step, the eps trunk on the natural (batch, seq_len,
latent) view of the tile state, then the sampler step body
``sampler_step/ref.update`` (scalar coefficients for B3, one coefficient
row per tile row for B4).

  * 'exact' is ``diffusion_lm.eps_forward`` itself, so on the CPU a mega
    run equals the 'tile_resident' loop bit for bit (same eps, same update
    on the same float32 coefficients).
  * 'flash' assembles the same trunk from the plain versions of the
    kernels' bodies (rmsnorm ``rms_norm_body``, flash_attention
    ``streaming_attention_body``), as the JAX ``eps_flash`` does: equal in
    exact arithmetic, not bitwise (it divides after the PV product).

``tf32x3_matmul`` is the plain version of the kernels' 3xTF32 product
(each float32 operand split into a TF32 big part and a TF32 remainder);
the tests use it to hold the split against float64 and against the
float32 trunk.  The plain versions above keep float32 products.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.diffusion_lm.model import eps_forward
from repro_torch.kernels.flash_attention.ref import streaming_attention_body
from repro_torch.kernels.rmsnorm.ref import rms_norm_body
from repro_torch.kernels.sampler_step.ref import update
from repro_torch.models.common import (apply_rope, matmul, rope_freqs,
                                       sinusoidal_time_embedding, swiglu)


def _t_vec(t, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.int32,
                           device=device).reshape(-1).expand(batch)


def eps_exact(params, cfg, batch: int, seq_len: int, x2, t):
    """The diffusion-LM eps on the tile view (make_tile_eps_fn's body)."""
    e = eps_forward(params, cfg, x2.reshape(batch, seq_len, cfg.latent_dim),
                    _t_vec(t, batch, x2.device))
    return e.reshape(x2.shape)


def eps_flash(params, cfg, batch: int, seq_len: int, x2, t):
    """The same dense trunk from the kernels' plain bodies."""
    a = cfg.arch
    B, S = batch, seq_len
    H, Hkv, D = a.n_heads, a.n_kv_heads, a.hd()
    x = x2.reshape(B, S, cfg.latent_dim)
    temb = sinusoidal_time_embedding(_t_vec(t, B, x2.device),
                                     cfg.time_dim).to(x.dtype)
    temb = matmul(F.silu(matmul(temb, params["time_w1"])),
                  params["time_w2"])
    h = matmul(x, params["w_in"]) + temb[:, None, :]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    cos, sin = rope_freqs(positions, D, a.rope_theta)
    lay = params["layers"]
    for i in range(a.n_layers):
        ap = {k: v[i] for k, v in lay["attn"].items()}
        xn = rms_norm_body(h, lay["attn_norm"][i], a.norm_eps)
        q = apply_rope(matmul(xn, ap["wq"]).reshape(B, S, H, D), cos, sin)
        k = apply_rope(matmul(xn, ap["wk"]).reshape(B, S, Hkv, D), cos, sin)
        v = matmul(xn, ap["wv"]).reshape(B, S, Hkv, D)
        if Hkv != H:                       # GQA: share each kv head
            k = torch.repeat_interleave(k, H // Hkv, dim=2)
            v = torch.repeat_interleave(v, H // Hkv, dim=2)
        qf, kf, vf = (z.transpose(1, 2).reshape(B * H, S, D).float()
                      for z in (q, k, v))
        out = streaming_attention_body(qf, kf, vf, scale=1.0 / math.sqrt(D),
                                       causal=False).to(h.dtype)
        out = out.reshape(B, H, S, D).transpose(1, 2)
        h = h + matmul(out.reshape(B, S, H * D), ap["wo"])
        h = h + swiglu(rms_norm_body(h, lay["mlp_norm"][i], a.norm_eps),
                       lay["w_gate"][i], lay["w_up"][i], lay["w_down"][i])
    h = rms_norm_body(h, params["out_norm"], a.norm_eps)
    return matmul(h, params["w_out"]).reshape(x2.shape)


EPS_BODIES = {"exact": eps_exact, "flash": eps_flash}


def megastep_ref(x2: torch.Tensor, params, cfg, batch: int, seq_len: int,
                 coefs: torch.Tensor, ts: torch.Tensor, *, clip=None,
                 attn_impl: str = "exact") -> torch.Tensor:
    """K fused lockstep steps over the (R, C) tile view; coefs (K, 5+)
    rows [c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t], ts (K,) int."""
    eps_fn = EPS_BODIES[attn_impl]
    c = torch.as_tensor(coefs, dtype=torch.float32).to(x2.device)
    x = x2
    with torch.no_grad():
        for k in range(int(ts.shape[0])):
            e2 = eps_fn(params, cfg, batch, seq_len, x, ts[k])
            x = update(x.float(), e2.float(), c[k, 0], c[k, 1], c[k, 3],
                       c[k, 4], clip)[1].to(x.dtype)
    return x


def megastep_rows_ref(x2: torch.Tensor, params, cfg, batch: int,
                      seq_len: int, row_coefs: torch.Tensor,
                      slot_ts: torch.Tensor, *, clip=None,
                      attn_impl: str = "exact") -> torch.Tensor:
    """One fused scheduler tick over the (R, C) slot-tile view: the trunk
    at each slot's timestep ``slot_ts`` (batch,), then the per-row update
    with ``row_coefs`` (R, 8) — the arithmetic of the per-row sampler-step
    kernel's deterministic body without the x0 output."""
    c = torch.as_tensor(row_coefs, dtype=torch.float32).to(x2.device)
    with torch.no_grad():
        e2 = EPS_BODIES[attn_impl](params, cfg, batch, seq_len, x2, slot_ts)
        out = update(x2.float(), e2.float(), c[:, 0:1], c[:, 1:2],
                     c[:, 3:4], c[:, 4:5], clip)[1]
    return out.to(x2.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the float32 value of its TF32 rounding, as
    ``cvt.rna.tf32.f32`` gives it: keep sign, exponent and the top 10
    mantissa bits, round to nearest with ties away from zero (add half of
    the dropped 13 bits' range to the magnitude bits, then clear them)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 as the kernels' tensor-core products compute it:
    a = a_big + a_small, b = b_big + b_small (big = TF32 rounding, small =
    TF32 rounding of the remainder), then small.big + big.small + big.big;
    the small.small term is dropped."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big
