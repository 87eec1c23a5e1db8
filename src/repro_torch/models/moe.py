"""Mixture-of-Experts models (port of ``repro/models/moe.py``): kimi-k2
(GQA attention, 384 routed experts top-8) and deepseek-v2 (MLA attention,
2 shared + 160 routed experts top-6).

Dispatch is the GShard / Switch grouped-capacity formulation: tokens are
split into groups of ``FLAGS.moe_group`` (``MOE_GROUP``), padded with zero
tokens to a whole group, and routed with a per-group capacity
``C = ceil(top_k * group * capacity_factor / E)``.  The (G, S, E, C)
dispatch / combine one-hots contract against the token activations; the
expert products are plain batched products (``torch.einsum``), as JAX
left them to XLA.  A token's slot is a cumulative sum over its group in
token order, carried across the K choices; overflow tokens are dropped
(combine weight 0, the residual carries them).  The router runs in
float32 whatever the dtype.  Top-k takes a stable descending sort, so
equal probabilities pick the lower expert first, as ``jax.lax.top_k``
does (zero padding tokens route with exact ties).

Layer 0 has a dense FFN (both source models: "first_k_dense=1"); the
other ``n_layers - 1`` layers are stacked MoE layers.  The caches are
written in place, as in ``models/dense.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

from .attention import (decode_attend, decode_tables, gqa_forward,
                        gqa_prefill, gqa_shapes, init_gqa_params,
                        init_kv_cache,
                        init_mla_cache, init_mla_params, mla_decode_attend,
                        mla_decode_tables, mla_forward, mla_prefill)
from .common import (ArchConfig, KeyGen, dense_init, einsum, embed_init,
                     matmul, rms_norm, stack_layer_params, stacked, swiglu)
from .dense import layer_params, unstack_layers
from .runtime_flags import FLAGS, constrain, constrain_residual

Params = Dict
MOE_GROUP = 512  # tokens per routing group (GShard's G axis)


# ------------------------------------------------------------------ routing
def _capacity(cfg: ArchConfig, group: int) -> int:
    return max(1, math.ceil(cfg.top_k * group * cfg.capacity_factor /
                            cfg.n_experts))


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: ArchConfig,
          capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch / combine tensors for grouped tokens.

    x: (G, S, d).  Returns (dispatch (G,S,E,C) in x.dtype, combine the
    same, the Switch load-balance aux loss, a float32 scalar)."""
    G, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = einsum("gsd,de->gse", x, router_w.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :K], topi[..., :K]                  # (G,S,K)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)        # renormalize

    # Switch-style load-balance auxiliary loss: E * sum_e f_e * P_e
    me = torch.mean(probs, dim=(0, 1))                         # (E,)
    ce = torch.mean(F.one_hot(topi[..., 0], E).float(), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    dispatch = torch.zeros((G, S, E, capacity), dtype=x.dtype,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    # occupancy counter per expert, accumulated across the K choices
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    for j in range(K):
        onehot = F.one_hot(topi[..., j], E)                    # (G,S,E)
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        keep = (pos < capacity) & (onehot > 0)
        # a dropped choice indexes column C, which is cut off (all zeros)
        pos_oh = F.one_hot(torch.where(keep, pos, capacity),
                           capacity + 1)[..., :capacity].to(x.dtype)
        sel = (onehot * keep).to(x.dtype)[..., None] * pos_oh
        dispatch = dispatch + sel
        combine = combine + sel * topw[..., j, None, None].to(x.dtype)
        counts = counts + torch.sum(onehot * keep, dim=1)
    return dispatch, combine, aux


def moe_ffn(block: Dict, cfg: ArchConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over (B, S, d) activations.  Returns (out, aux)."""
    B, S, d = x.shape
    N = B * S
    group = min(FLAGS.moe_group or MOE_GROUP, N)
    G = N // group
    rem = N - G * group          # pad to a multiple of the group size
    xt = x.reshape(N, d)
    if rem:
        xt = F.pad(xt, (0, 0, 0, group - rem))
        G += 1
    xg = xt.reshape(G, group, d)
    C = _capacity(cfg, group)
    dispatch, combine, aux = route(block["router"], xg, cfg, C)
    dispatch = constrain(dispatch, FLAGS.dispatch_spec)
    combine = constrain(combine, FLAGS.dispatch_spec)
    exp_in = constrain(einsum("gsec,gsd->egcd", dispatch, xg),
                       FLAGS.exp_in_spec)
    h = einsum("egcd,edf->egcf", exp_in, block["w_gate"])
    u = einsum("egcd,edf->egcf", exp_in, block["w_up"])
    h = F.silu(h) * u
    exp_out = einsum("egcf,efd->egcd", h, block["w_down"])
    y = einsum("gsec,egcd->gsd", combine, exp_out)
    y = y.reshape(-1, d)[:N].reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + swiglu(x, block["sw_gate"], block["sw_up"], block["sw_down"])
    return y, aux


# ------------------------------------------------------------------- params
def init_moe_block(kg: KeyGen, cfg: ArchConfig,
                   dtype=torch.float32) -> Dict:
    d, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    block = {
        "router": dense_init(kg(), (d, E), torch.float32),  # router in f32
        "w_gate": dense_init(kg(), (E, d, Fe), dtype),
        "w_up": dense_init(kg(), (E, d, Fe), dtype),
        "w_down": dense_init(kg(), (E, Fe, d), dtype,
                             scale=Fe ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.n_shared_experts:
        Fs = cfg.d_ff_expert * cfg.n_shared_experts
        block["sw_gate"] = dense_init(kg(), (d, Fs), dtype)
        block["sw_up"] = dense_init(kg(), (d, Fs), dtype)
        block["sw_down"] = dense_init(kg(), (Fs, d), dtype)
    return block


def _init_attn(kg: KeyGen, cfg: ArchConfig, dtype) -> Dict:
    if cfg.use_mla:
        return init_mla_params(kg, cfg, dtype)
    return init_gqa_params(kg, cfg, dtype)


def _ones(cfg: ArchConfig, dtype, device) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=dtype, device=device)


def init_layer(key: torch.Tensor, cfg: ArchConfig,
               dtype=torch.float32) -> Dict:
    """One MoE layer from one threefry key (JAX's numbers)."""
    kg = KeyGen(key)
    return {
        "attn": _init_attn(kg, cfg, dtype),
        "attn_norm": _ones(cfg, dtype, key.device),
        "mlp_norm": _ones(cfg, dtype, key.device),
        "moe": init_moe_block(kg, cfg, dtype),
    }


def init_params(key: torch.Tensor, cfg: ArchConfig,
                device: DeviceLike = None, dtype=torch.float32) -> Params:
    """JAX's ``init_params(key, cfg, dtype)`` numbers, drawn and stored on
    ``device`` (CUDA unless named): layer 0 with a dense FFN, the embed,
    ``n_layers - 1`` stacked MoE layers, the unembed, in its key order."""
    cfg.validate()
    dev = resolve_device(device)
    kg = KeyGen(key.to(dev))
    dense0 = {
        "attn": _init_attn(kg, cfg, dtype),
        "attn_norm": _ones(cfg, dtype, dev),
        "mlp_norm": _ones(cfg, dtype, dev),
        "w_gate": dense_init(kg(), (cfg.d_model, cfg.d_ff), dtype),
        "w_up": dense_init(kg(), (cfg.d_model, cfg.d_ff), dtype),
        "w_down": dense_init(kg(), (cfg.d_ff, cfg.d_model), dtype),
    }
    return {
        "embed": embed_init(kg(), (cfg.vocab, cfg.d_model), dtype),
        "layer0": dense0,
        "layers": stack_layer_params(lambda k: init_layer(k, cfg, dtype),
                                     cfg.n_layers - 1, kg),
        "final_norm": _ones(cfg, dtype, dev),
        "unembed": dense_init(kg(), (cfg.d_model, cfg.vocab), dtype),
    }


def _attn_shapes(cfg: ArchConfig) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    if not cfg.use_mla:
        return gqa_shapes(cfg)
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    shapes = {"w_dkv": (d, cfg.kv_lora), "w_krope": (d, cfg.qk_rope_dim),
              "kv_norm": (cfg.kv_lora,),
              "w_uk": (cfg.kv_lora, H * cfg.qk_nope_dim),
              "w_uv": (cfg.kv_lora, H * cfg.v_head_dim),
              "wo": (H * cfg.v_head_dim, d)}
    if cfg.q_lora:
        shapes.update(w_dq=(d, cfg.q_lora), q_norm=(cfg.q_lora,),
                      w_uq=(cfg.q_lora, H * qd))
    else:
        shapes["wq"] = (d, H * qd)
    return shapes


def layer_shapes(cfg: ArchConfig) -> Dict:
    """One MoE layer's leaves as nested dicts of shapes (``init_layer``)."""
    d, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    block = {"router": (d, E), "w_gate": (E, d, Fe), "w_up": (E, d, Fe),
             "w_down": (E, Fe, d)}
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        block.update(sw_gate=(d, Fs), sw_up=(d, Fs), sw_down=(Fs, d))
    return {"attn": _attn_shapes(cfg), "attn_norm": (d,), "mlp_norm": (d,),
            "moe": block}


def param_shapes(cfg: ArchConfig) -> Dict:
    """The parameter tree as nested dicts of shapes, as the JAX
    ``init_params`` builds it (the router is float32 in any dtype)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "embed": (cfg.vocab, d),
        "layer0": {"attn": _attn_shapes(cfg), "attn_norm": (d,),
                   "mlp_norm": (d,), "w_gate": (d, f), "w_up": (d, f),
                   "w_down": (f, d)},
        "layers": stacked(layer_shapes(cfg), cfg.n_layers - 1),
        "final_norm": (d,),
        "unembed": (d, cfg.vocab),
    }


# ------------------------------------------------------------------ forward
def _attn_fwd(layer: Dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    xn = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    if cfg.use_mla:
        return mla_forward(layer["attn"], cfg, xn, positions)
    return gqa_forward(layer["attn"], cfg, xn, positions)


def _dense_mlp(l0: Dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return h + swiglu(rms_norm(h, l0["mlp_norm"], cfg.norm_eps),
                      l0["w_gate"], l0["w_up"], l0["w_down"])


def _moe_mlp(layer: Dict, cfg: ArchConfig, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    y, aux = moe_ffn(layer["moe"], cfg,
                     rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    return x + y, aux


def _embed(params: Params, tokens: torch.Tensor,
           embeds: Optional[torch.Tensor]):
    h = params["embed"][tokens]
    if embeds is not None:
        h = torch.cat([embeds.to(h.dtype), h], dim=1)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    return h, positions


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return matmul(rms_norm(h, params["final_norm"], cfg.norm_eps),
                  params["unembed"])


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,vocab), the mean aux
    loss over the MoE layers)."""
    h, positions = _embed(params, tokens, embeds)
    l0 = params["layer0"]
    h = _dense_mlp(l0, cfg, h + _attn_fwd(l0, cfg, h, positions))
    auxes = []
    for layer in unstack_layers(params["layers"], cfg.n_layers - 1):
        h, aux = _moe_mlp(layer, cfg, h + _attn_fwd(layer, cfg, h,
                                                     positions))
        h = constrain_residual(h)
        auxes.append(aux)
    return _logits(params, cfg, h), torch.mean(torch.stack(auxes))


# ------------------------------------------------------------------ serving
def _cache_names(cfg: ArchConfig) -> Tuple[str, str]:
    return ("ckv", "krope") if cfg.use_mla else ("k", "v")


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    if cfg.use_mla:
        return init_mla_cache(cfg, batch, max_len, cfg.n_layers, dtype,
                              device)
    return init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype, device)


def _layers(params: Params, cfg: ArchConfig):
    """(layer, is_moe) for layer 0 and every stacked MoE layer."""
    yield params["layer0"], False
    for i in range(cfg.n_layers - 1):
        yield layer_params(params["layers"], i), True


def _mlp(layer: Dict, cfg: ArchConfig, h: torch.Tensor,
         is_moe: bool) -> torch.Tensor:
    return _moe_mlp(layer, cfg, h)[0] if is_moe else _dense_mlp(layer, cfg,
                                                                h)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt through the model, filling the cache in place.
    Returns (last-position logits (B, vocab), cache)."""
    h, positions = _embed(params, tokens, embeds)
    a, b = _cache_names(cfg)
    step = mla_prefill if cfg.use_mla else gqa_prefill
    for i, (layer, is_moe) in enumerate(_layers(params, cfg)):
        attn_out, _, _ = step(cache[a][i], cache[b][i], layer["attn"], cfg,
                              rms_norm(h, layer["attn_norm"], cfg.norm_eps),
                              positions)
        h = _mlp(layer, cfg, h + attn_out, is_moe)
    cache["idx"].fill_(h.shape[1])
    return _logits(params, cfg, h[:, -1:])[:, 0], cache


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One AR decode step.  tokens (B, 1) -> logits (B, vocab); each layer
    writes the token's cache rows at slot ``idx mod M`` before attending,
    and ``idx`` advances."""
    h = params["embed"][tokens]
    a, b = _cache_names(cfg)
    B, M = h.shape[0], cache[a].shape[2]
    if cfg.use_mla:
        tables = mla_decode_tables(cache["idx"], B, M, cfg)
        attend = mla_decode_attend
    else:
        tables = decode_tables(cache["idx"], B, M, cfg.hd(), cfg.rope_theta)
        attend = decode_attend
    for i, (layer, is_moe) in enumerate(_layers(params, cfg)):
        attn_out = attend(cache[a][i], cache[b][i], tables, layer["attn"],
                          cfg, rms_norm(h, layer["attn_norm"], cfg.norm_eps))
        h = _mlp(layer, cfg, h + attn_out, is_moe)
    cache["idx"].add_(1)
    return _logits(params, cfg, h)[:, 0], cache
