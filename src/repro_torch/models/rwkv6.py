"""RWKV6 "Finch" (arXiv:2404.05892; port of ``repro/models/rwkv6.py``):
attention-free, with a data-dependent decay.

Per layer: a time-mixing block (the WKV linear-attention recurrence with
a per-channel dynamic decay w_t from a LoRA of the shifted input) and a
channel-mixing block (squared-ReLU FFN with token shift).  The decode
state is O(1) in sequence length: a (head, K, K) matrix per layer plus
the last normalised token of each block for the shifts.

WKV recurrence per head (d_k = d_v = head size K):
  out_t = r_t . (S + u (*) k_t v_t^T)
  S     = diag(w_t) S + k_t v_t^T

The recurrence is sequential in w_t: JAX scans it over time, and here it
is a Python loop over the sequence in each layer (prefill of S tokens
issues a few device ops per token and layer; a chunked WKV is later
work).  The state dict is the rwkv "cache" and is written in place by
``prefill`` and ``decode_step``, as the dense cache is.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.device import DeviceLike, resolve_device

from .common import (ArchConfig, KeyGen, dense_init, embed_init, matmul,
                     rms_norm, stack_layer_params, stacked)
from .dense import unstack_layers
from .runtime_flags import constrain_residual

Params = Dict
LORA_R = 32          # decay / mix LoRA rank
MIX_KEYS = ("r", "k", "v", "w", "g")


def head_size(cfg: ArchConfig) -> int:
    return cfg.hd()


def n_rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // head_size(cfg)


def _uniform(kg: KeyGen, d: int, dtype) -> torch.Tensor:
    """``jax.random.uniform(key, (d,), float32).astype(dtype)``."""
    return prng.uniform(kg(), (d,)).to(dtype)


def init_time_mix(kg: KeyGen, cfg: ArchConfig, dtype=torch.float32) -> Dict:
    d = cfg.d_model
    H, K = n_rwkv_heads(cfg), head_size(cfg)
    p = {"mu_base": _uniform(kg, d, dtype)}
    p["w0"] = torch.zeros((d,), dtype=dtype, device=p["mu_base"].device)
    p["w_lora_a"] = dense_init(kg(), (d, LORA_R * 2), dtype)
    p["w_lora_b"] = dense_init(kg(), (LORA_R * 2, d), dtype, scale=0.01)
    p["u"] = dense_init(kg(), (H, K), torch.float32).to(dtype)   # bonus
    for w in ("wr", "wk", "wv", "wg", "wo"):
        p[w] = dense_init(kg(), (d, d), dtype)
    p["ln_scale"] = torch.ones((d,), dtype=dtype, device=p["w0"].device)
    for name in MIX_KEYS:
        p[f"mu_{name}"] = _uniform(kg, d, dtype)
        p[f"mix_a_{name}"] = dense_init(kg(), (d, LORA_R), dtype)
        p[f"mix_b_{name}"] = dense_init(kg(), (LORA_R, d), dtype, scale=0.01)
    return p


def init_channel_mix(kg: KeyGen, cfg: ArchConfig,
                     dtype=torch.float32) -> Dict:
    d = cfg.d_model
    return {
        "mu_k": _uniform(kg, d, dtype),
        "mu_r": _uniform(kg, d, dtype),
        "wk": dense_init(kg(), (d, cfg.d_ff), dtype),
        "wv": dense_init(kg(), (cfg.d_ff, d), dtype),
        "wr": dense_init(kg(), (d, d), dtype),
    }


def layer_shapes(cfg: ArchConfig) -> Dict:
    """One layer's leaves (``init_layer``) as nested dicts of shapes."""
    d, f = cfg.d_model, cfg.d_ff
    tm = {"mu_base": (d,), "w0": (d,), "w_lora_a": (d, 2 * LORA_R),
          "w_lora_b": (2 * LORA_R, d),
          "u": (n_rwkv_heads(cfg), head_size(cfg)), "ln_scale": (d,)}
    tm.update({w: (d, d) for w in ("wr", "wk", "wv", "wg", "wo")})
    for name in MIX_KEYS:
        tm.update({f"mu_{name}": (d,), f"mix_a_{name}": (d, LORA_R),
                   f"mix_b_{name}": (LORA_R, d)})
    cm = {"mu_k": (d,), "mu_r": (d,), "wk": (d, f), "wv": (f, d),
          "wr": (d, d)}
    return {"ln1": (d,), "ln2": (d,), "tm": tm, "cm": cm}


def param_shapes(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    return {"embed": (cfg.vocab, d), "ln_in": (d,),
            "layers": stacked(layer_shapes(cfg), cfg.n_layers),
            "final_norm": (d,), "unembed": (d, cfg.vocab)}


def _ddlerp(p: Dict, name: str, x: torch.Tensor,
            x_prev: torch.Tensor) -> torch.Tensor:
    """RWKV6 data-dependent lerp between x and the shifted x_prev."""
    dx = x_prev - x
    xx = x + dx * p["mu_base"]
    lora = matmul(torch.tanh(matmul(xx, p[f"mix_a_{name}"])),
                  p[f"mix_b_{name}"])
    return x + dx * (p[f"mu_{name}"] + lora)


def _shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Token shift: the previous token's activation ((B,S,d), carry
    (B,d))."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def time_mix(p: Dict, cfg: ArchConfig, x: torch.Tensor, last: torch.Tensor,
             wkv_state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,d), last: (B,d) previous token, wkv_state: (B,H,K,K).
    Returns (out, new last, new wkv_state)."""
    B, S, d = x.shape
    H, K = n_rwkv_heads(cfg), head_size(cfg)
    xp = _shift(x, last)
    r = matmul(_ddlerp(p, "r", x, xp), p["wr"])
    k = matmul(_ddlerp(p, "k", x, xp), p["wk"])
    v = matmul(_ddlerp(p, "v", x, xp), p["wv"])
    g = matmul(_ddlerp(p, "g", x, xp), p["wg"])
    # dynamic decay: w_t = exp(-exp(w0 + lora_w)) in (0, 1), per channel
    wl = matmul(torch.tanh(matmul(_ddlerp(p, "w", x, xp),
                                  p["w_lora_a"][:, :LORA_R])),
                p["w_lora_b"][:LORA_R])
    logw = -torch.exp(torch.clamp(p["w0"] + wl, -10.0, 5.0))
    w = torch.exp(logw)                                    # (B,S,d)

    rh = r.reshape(B, S, H, 1, K)
    kh = k.reshape(B, S, H, K, 1)
    vh = v.reshape(B, S, H, 1, K)
    wh = w.reshape(B, S, H, K, 1)
    u = p["u"][..., None]                                  # (H,K,1)
    state = wkv_state
    outs = []
    for t in range(S):
        kv = kh[:, t] * vh[:, t]                           # (B,H,K,K)
        outs.append(matmul(rh[:, t], state + u * kv))     # (B,H,1,K)
        state = wh[:, t] * state + kv
    out = torch.stack(outs, dim=1).reshape(B, S, d)
    out = rms_norm(out, p["ln_scale"], cfg.norm_eps)       # per-head GN approx
    out = out * F.silu(g)
    return matmul(out, p["wo"]), x[:, -1], state


def channel_mix(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xp = _shift(x, last)
    xk = x + (xp - x) * p["mu_k"]
    xr = x + (xp - x) * p["mu_r"]
    k = torch.square(F.relu(matmul(xk, p["wk"])))
    return (torch.sigmoid(matmul(xr, p["wr"])) * matmul(k, p["wv"]),
            x[:, -1])


def init_layer(key: torch.Tensor, cfg: ArchConfig,
               dtype=torch.float32) -> Dict:
    kg = KeyGen(key)
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=key.device)
    return {"ln1": ones, "ln2": ones.clone(),
            "tm": init_time_mix(kg, cfg, dtype),
            "cm": init_channel_mix(kg, cfg, dtype)}


def init_params(key: torch.Tensor, cfg: ArchConfig,
                device: DeviceLike = None, dtype=torch.float32) -> Params:
    """JAX's ``init_params(key, cfg, dtype)`` numbers for a threefry key
    on ``device`` (CUDA unless named): embed, the ``n_layers`` stacked
    layers, unembed, in its key order."""
    dev = resolve_device(device)
    kg = KeyGen(key.to(dev))
    d = cfg.d_model
    return {
        "embed": embed_init(kg(), (cfg.vocab, d), dtype),
        "ln_in": torch.ones((d,), dtype=dtype, device=dev),
        "layers": stack_layer_params(lambda k: init_layer(k, cfg, dtype),
                                     cfg.n_layers, kg),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "unembed": dense_init(kg(), (d, cfg.vocab), dtype),
    }


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None) -> Dict[str, torch.Tensor]:
    """The recurrent state of every layer (the rwkv 'cache'), zero."""
    H, K = n_rwkv_heads(cfg), head_size(cfg)
    L, d = cfg.n_layers, cfg.d_model
    return {
        "tm_last": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "cm_last": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((L, batch, H, K, K), dtype=dtype, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def _run(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
         state: Dict, write: bool = True) -> torch.Tensor:
    """The layers over tokens (B, S) from ``state``.  With ``write`` the
    state is advanced in place: ``tm_last`` / ``cm_last`` take the
    *normalised* last activation of each block (``ln1[:, -1]``,
    ``ln2[:, -1]``: what the shift reads), ``wkv`` the new matrices,
    ``idx`` += S.  Returns the hidden states (B, S, d) before the final
    norm."""
    h = rms_norm(params["embed"][tokens], params["ln_in"], cfg.norm_eps)
    for i, layer in enumerate(unstack_layers(params["layers"],
                                             cfg.n_layers)):
        ln1 = rms_norm(h, layer["ln1"], cfg.norm_eps)
        a, _, new_wkv = time_mix(layer["tm"], cfg, ln1, state["tm_last"][i],
                                 state["wkv"][i])
        h = h + a
        ln2 = rms_norm(h, layer["ln2"], cfg.norm_eps)
        b, _ = channel_mix(layer["cm"], cfg, ln2, state["cm_last"][i])
        h = constrain_residual(h + b)
        if write:
            state["tm_last"][i].copy_(ln1[:, -1])
            state["cm_last"][i].copy_(ln2[:, -1])
            state["wkv"][i].copy_(new_wkv)
    if write:
        state["idx"].add_(tokens.shape[1])
    return h


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return matmul(rms_norm(h, params["final_norm"], cfg.norm_eps),
                  params["unembed"])


def forward_with_state(params: Params, cfg: ArchConfig,
                       tokens: torch.Tensor, state: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward threading the recurrent state (advanced in
    place).  Returns (logits (B, S, vocab), state)."""
    return _logits(params, cfg, _run(params, cfg, tokens, state)), state


def forward(params: Params, cfg: ArchConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, vocab) from a zero state (nothing written in place,
    so autograd runs through it)."""
    state = init_state(cfg, tokens.shape[0], params["embed"].dtype,
                       tokens.device)
    return _logits(params, cfg, _run(params, cfg, tokens, state,
                                     write=False))


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            state: Dict) -> Tuple[torch.Tensor, Dict]:
    """(last-position logits (B, vocab), state advanced in place)."""
    h = _run(params, cfg, tokens, state)
    return _logits(params, cfg, h[:, -1:])[:, 0], state


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: Dict) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, 1) -> (logits (B, vocab), state advanced in place)."""
    return prefill(params, cfg, tokens, state)


def layer_fwd(layer: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """One layer from a fresh zero state (the diffusion-LM trunk's rwkv6
    layer, ``diffusion_lm/model.py:105-114``)."""
    B, d = x.shape[0], cfg.d_model
    H, K = n_rwkv_heads(cfg), head_size(cfg)
    zero = x.new_zeros((B, d))
    ln1 = rms_norm(x, layer["ln1"], cfg.norm_eps)
    out, _, _ = time_mix(layer["tm"], cfg, ln1, zero,
                         x.new_zeros((B, H, K, K)))
    x = x + out
    ln2 = rms_norm(x, layer["ln2"], cfg.norm_eps)
    out, _ = channel_mix(layer["cm"], cfg, ln2, zero)
    return x + out

