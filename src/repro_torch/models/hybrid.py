"""Zamba2-style hybrid (arXiv:2411.15242; port of
``repro/models/hybrid.py``): a Mamba2 backbone with one weight-SHARED
attention block applied every ``attn_every`` layers.

The shared block reads concat(hidden, original embedding) through a
2d -> d input projection, so late applications still see the raw token
signal.  Its KV cache is per APPLICATION (n_apps = n_layers //
attn_every), since each application sees other activations: the cache's
K / V are (n_apps, B, M, Hkv, D), indexed by application.  The Mamba2
layers are stacked (n_apps, attn_every, ...), as JAX reshapes them for
its grouped scan; here a group is a Python loop over views.

The cache is written in place, as in ``models/dense.py``: prefill and
decode write the K / V rows and every layer's conv and SSM states into
the cache's tensors and advance ``idx``.  The shared block's attention is
plain GQA (head dim 80 at zamba2 width), as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from .attention import (decode_attend, decode_tables, gqa_forward,
                        gqa_prefill, gqa_shapes, init_gqa_params)
from .common import (ArchConfig, KeyGen, dense_init, embed_init, matmul,
                     rms_norm, stack_layer_params, stacked, swiglu)
from .dense import _embed, _positions, layer_params
from .mamba2 import (init_mamba_params, init_mamba_state, mamba_decode_step,
                     mamba_forward, mamba_shapes)
from .runtime_flags import constrain_residual

Params = Dict


def n_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def init_mamba_layer(key: torch.Tensor, cfg: ArchConfig,
                     dtype=torch.float32) -> Dict:
    kg = KeyGen(key)
    return {
        "norm": torch.ones((cfg.d_model,), dtype=dtype, device=key.device),
        "mamba": init_mamba_params(kg, cfg, dtype),
    }


def mamba_layer_shapes(cfg: ArchConfig) -> Dict:
    return {"norm": (cfg.d_model,), "mamba": mamba_shapes(cfg)}


def _shared_shapes(cfg: ArchConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_in": (2 * d, d), "attn_norm": (d,), "attn": gqa_shapes(cfg),
            "mlp_norm": (d,), "w_gate": (d, f), "w_up": (d, f),
            "w_down": (f, d)}


def param_shapes(cfg: ArchConfig) -> Dict:
    """The parameter tree as nested dicts of shapes, as the JAX
    ``init_params`` builds it (layers grouped (n_apps, attn_every, ...))."""
    d = cfg.d_model
    layers = stacked(stacked(mamba_layer_shapes(cfg), cfg.attn_every),
                     n_apps(cfg))
    return {"embed": (cfg.vocab, d), "layers": layers,
            "shared": _shared_shapes(cfg), "final_norm": (d,),
            "unembed": (d, cfg.vocab)}


def init_params(key: torch.Tensor, cfg: ArchConfig,
                device: DeviceLike = None, dtype=torch.float32) -> Params:
    """JAX's ``init_params(key, cfg, dtype)`` numbers for a threefry key
    on ``device`` (CUDA unless named): the shared block, the
    ``n_layers`` Mamba2 layers (then grouped), embed, unembed, in JAX's
    key order."""
    assert cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0
    dev = resolve_device(device)
    kg = KeyGen(key.to(dev))
    d = cfg.d_model

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    shared = {"w_in": dense_init(kg(), (2 * d, d), dtype),
              "attn_norm": ones(d)}
    shared["attn"] = init_gqa_params(kg, cfg, dtype)
    shared["mlp_norm"] = ones(d)
    shared["w_gate"] = dense_init(kg(), (d, cfg.d_ff), dtype)
    shared["w_up"] = dense_init(kg(), (d, cfg.d_ff), dtype)
    shared["w_down"] = dense_init(kg(), (cfg.d_ff, d), dtype)
    layers = stack_layer_params(lambda k: init_mamba_layer(k, cfg, dtype),
                                cfg.n_layers, kg)
    grouped = (n_apps(cfg), cfg.attn_every)

    def group(t):
        if isinstance(t, dict):
            return {k: group(v) for k, v in t.items()}
        return t.reshape(grouped + tuple(t.shape[1:]))

    return {
        "embed": embed_init(kg(), (cfg.vocab, d), dtype),
        "layers": group(layers),
        "shared": shared,
        "final_norm": ones(d),
        "unembed": dense_init(kg(), (d, cfg.vocab), dtype),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """conv (n_apps, attn_every, B, K-1, conv_dim), ssm (n_apps,
    attn_every, B, H, P, N), per-application k / v (n_apps, B, M, Hkv, D)
    and idx, all zero."""
    conv, ssm = init_mamba_state(cfg, batch, dtype, device)
    A, E = n_apps(cfg), cfg.attn_every
    M = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
    kv = (A, batch, M, cfg.n_kv_heads, cfg.hd())
    return {
        "conv": conv.new_zeros((A, E) + tuple(conv.shape)),
        "ssm": ssm.new_zeros((A, E) + tuple(ssm.shape)),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def _mamba_group_fwd(group: Dict, cfg: ArchConfig, h: torch.Tensor,
                     conv_g: torch.Tensor, ssm_g: torch.Tensor,
                     write: bool) -> torch.Tensor:
    """The ``attn_every`` Mamba2 layers of one group, each over its own
    (conv, ssm) state of ``conv_g`` / ``ssm_g``; with ``write`` the new
    states go back into them in place."""
    for e in range(cfg.attn_every):
        layer = layer_params(group, e)
        y, nconv, nssm = mamba_forward(
            layer["mamba"], cfg, rms_norm(h, layer["norm"], cfg.norm_eps),
            conv_g[e], ssm_g[e])
        h = constrain_residual(h + y)
        if write:
            conv_g[e].copy_(nconv)
            ssm_g[e].copy_(nssm)
    return h


def _shared_in(params: Params, h: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    return matmul(torch.cat([h, h0], dim=-1), params["shared"]["w_in"])


def _shared_out(params: Params, cfg: ArchConfig, h: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """The shared block's SwiGLU on x (after attention), then h + x."""
    sh = params["shared"]
    x = x + swiglu(rms_norm(x, sh["mlp_norm"], cfg.norm_eps),
                   sh["w_gate"], sh["w_up"], sh["w_down"])
    return h + x


def _attn_in(params: Params, cfg: ArchConfig, x: torch.Tensor):
    return rms_norm(x, params["shared"]["attn_norm"], cfg.norm_eps)


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return matmul(rms_norm(h, params["final_norm"], cfg.norm_eps),
                  params["unembed"])


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward from zero states -> logits (B, S, vocab)."""
    h = _embed(params, tokens, embeds)
    B, S, _ = h.shape
    h0 = h
    positions = _positions(B, S, h.device)
    conv, ssm = init_mamba_state(cfg, B, h.dtype, h.device)
    E = cfg.attn_every
    conv_g = conv.expand((E,) + tuple(conv.shape))
    ssm_g = ssm.expand((E,) + tuple(ssm.shape))
    for g in range(n_apps(cfg)):
        h = _mamba_group_fwd(layer_params(params["layers"], g), cfg, h,
                             conv_g, ssm_g, write=False)
        x = _shared_in(params, h, h0)
        x = x + gqa_forward(params["shared"]["attn"], cfg,
                            _attn_in(params, cfg, x), positions)
        h = _shared_out(params, cfg, h, x)
    return _logits(params, cfg, h)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, writing every layer's conv / ssm state and every
    application's K / V rows into the cache in place.  Returns
    (last-position logits (B, vocab), cache)."""
    h = _embed(params, tokens, embeds)
    B, S, _ = h.shape
    h0 = h
    positions = _positions(B, S, h.device)
    for g in range(n_apps(cfg)):
        h = _mamba_group_fwd(layer_params(params["layers"], g), cfg, h,
                             cache["conv"][g], cache["ssm"][g], write=True)
        x = _shared_in(params, h, h0)
        attn_out, _, _ = gqa_prefill(
            cache["k"][g], cache["v"][g], params["shared"]["attn"], cfg,
            _attn_in(params, cfg, x), positions)
        h = _shared_out(params, cfg, h, x + attn_out)
    cache["idx"].fill_(S)
    return _logits(params, cfg, h[:, -1:])[:, 0], cache


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One AR step. tokens: (B, 1) -> logits (B, vocab): each Mamba2
    layer's single-token recurrence and each application's attention,
    the cache written in place and ``idx`` advanced."""
    h = params["embed"][tokens]
    h0 = h
    K, V = cache["k"], cache["v"]                  # (A, B, M, Hkv, D)
    tables = decode_tables(cache["idx"], h.shape[0], K.shape[2], cfg.hd(),
                           cfg.rope_theta)
    for g in range(n_apps(cfg)):
        group = layer_params(params["layers"], g)
        conv_g, ssm_g = cache["conv"][g], cache["ssm"][g]
        for e in range(cfg.attn_every):
            layer = layer_params(group, e)
            y, nconv, nssm = mamba_decode_step(
                layer["mamba"], cfg,
                rms_norm(h, layer["norm"], cfg.norm_eps), conv_g[e], ssm_g[e])
            h = h + y
            conv_g[e].copy_(nconv)
            ssm_g[e].copy_(nssm)
        x = _shared_in(params, h, h0)
        attn_out = decode_attend(K[g], V[g], tables, params["shared"]["attn"],
                                 cfg, _attn_in(params, cfg, x))
        h = _shared_out(params, cfg, h, x + attn_out)
    cache["idx"].add_(1)
    return _logits(params, cfg, h)[:, 0], cache
