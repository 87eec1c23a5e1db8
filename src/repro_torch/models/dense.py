"""Decoder-only dense transformer, llama family (port of
``repro/models/dense.py``): the layer, the parameters, the full-sequence
forward and the KV-cache serving path (``init_cache``, ``prefill``,
``decode_step``, ``decode_step_inplace``).

Parameters are the JAX pytree as nested dicts of tensors in its (in, out)
layouts, with every layer leaf stacked along a leading ``n_layers`` axis
(``param_shapes``), so ``x @ w`` reads them as the JAX model does and
``repro_torch.interop`` carries them across unchanged.  The JAX scan over
layers is a Python loop over views of the stacked leaves.

The cache is updated in place, the counterpart of the JAX decode step's
donated cache: ``prefill`` and ``decode_step`` write the new rows into
``cache["k"]`` / ``cache["v"]``, advance ``cache["idx"]`` on its device
and return the same dict.  A caller that needs the old state clones it
first.  JAX has two decode bodies, one restacking each layer's cache as
scan outputs and ``decode_step_inplace`` carrying it; both write in place
here, so the port has one body (the slot, rotary tables and mask computed
once per step) and ``decode_step_inplace`` is ``decode_step``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from .attention import (decode_attend, decode_tables, gqa_forward,
                        gqa_prefill, gqa_shapes, init_gqa_params,
                        init_kv_cache)
from .common import (ArchConfig, KeyGen, dense_init, embed_init, matmul,
                     rms_norm, stack_layer_params, stacked, swiglu)
from .runtime_flags import constrain_residual

Params = Dict


def init_layer(key: torch.Tensor, cfg: ArchConfig,
               dtype=torch.float32) -> Dict:
    """One layer from one threefry key, JAX's ``init_layer`` numbers (the
    draws run where the key lies)."""
    kg = KeyGen(key)
    dev = key.device
    return {
        "attn": init_gqa_params(kg, cfg, dtype),
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "w_gate": dense_init(kg(), (cfg.d_model, cfg.d_ff), dtype),
        "w_up": dense_init(kg(), (cfg.d_model, cfg.d_ff), dtype),
        "w_down": dense_init(
            kg(), (cfg.d_ff, cfg.d_model), dtype,
            scale=cfg.d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }


def layer_shapes(cfg: ArchConfig) -> Dict[str, object]:
    """One layer's leaves (``init_layer``) as nested dicts of shapes."""
    d, f = cfg.d_model, cfg.d_ff
    return {"attn": gqa_shapes(cfg), "attn_norm": (d,), "mlp_norm": (d,),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def param_shapes(cfg: ArchConfig) -> Dict[str, object]:
    """The parameter tree as nested dicts of shapes (stacked layer leaves
    lead with n_layers), as the JAX ``init_params`` builds it."""
    d = cfg.d_model
    shapes = {
        "embed": (cfg.vocab, d),
        "final_norm": (d,),
        "layers": stacked(layer_shapes(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab)
    return shapes


def init_params(key: torch.Tensor, cfg: ArchConfig,
                device: DeviceLike = None, dtype=torch.float32) -> Params:
    """JAX's ``init_params(key, cfg, dtype)`` numbers for a threefry key:
    embed, the ``n_layers`` stacked layers, unembed, in its key order,
    drawn and stored on ``device`` (CUDA unless named).  The stacked
    leaves are filled layer by layer, so the peak is the parameters plus
    one layer."""
    cfg.validate()
    dev = resolve_device(device)
    kg = KeyGen(key.to(dev))
    params = {
        "embed": embed_init(kg(), (cfg.vocab, cfg.d_model), dtype),
        "layers": stack_layer_params(
            lambda k: init_layer(k, cfg, dtype), cfg.n_layers, kg),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(kg(), (cfg.d_model, cfg.vocab), dtype)
    return params


def layer_params(layers: Dict, i: int) -> Dict:
    """Layer ``i`` of the stacked layer leaves (views, no copies)."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def unstack_layers(layers: Dict, n_layers: int) -> List[Dict]:
    """Every layer of the stacked leaves, each leaf cut once by
    ``unbind`` (views, no copies).  Under autograd the layers' gradients
    then stack back in one op per leaf, where indexing layer by layer
    would add each one into a zero gradient of the whole stack."""
    def cut(node):
        if isinstance(node, dict):
            parts = {k: cut(v) for k, v in node.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n_layers)]
        return node.unbind(0)
    return cut(layers)


def layer_fwd(layer: Dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    h = x + gqa_forward(layer["attn"], cfg,
                        rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                        positions, causal=causal)
    h = h + swiglu(rms_norm(h, layer["mlp_norm"], cfg.norm_eps),
                   layer["w_gate"], layer["w_up"], layer["w_down"])
    return h


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return matmul(h, params["embed"].T)
    return matmul(h, params["unembed"])


def _embed(params: Params, tokens: torch.Tensor,
           embeds: Optional[torch.Tensor]) -> torch.Tensor:
    h = params["embed"][tokens]
    if embeds is not None:
        h = torch.cat([embeds.to(h.dtype), h], dim=1)
    return h


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab).

    embeds: optional (B, S_ctx, d) prefix embeddings prepended before the
    token embeddings.
    """
    h = _embed(params, tokens, embeds)
    B, S, _ = h.shape
    positions = _positions(B, S, h.device)
    for layer in unstack_layers(params["layers"], cfg.n_layers):
        h = constrain_residual(layer_fwd(layer, cfg, h, positions))
    return _logits(params, cfg, h)


# ------------------------------------------------------------------ serving
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype, device)


def _mlp(layer: Dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return h + swiglu(rms_norm(h, layer["mlp_norm"], cfg.norm_eps),
                      layer["w_gate"], layer["w_up"], layer["w_down"])


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt through the model, filling the cache in place.

    Returns (last-position logits (B, vocab), cache); ``cache["idx"]``
    becomes the (padded) prompt length S, shared by every row."""
    h = _embed(params, tokens, embeds)
    B, S, _ = h.shape
    positions = _positions(B, S, h.device)
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        attn_out, _, _ = gqa_prefill(
            cache["k"][i], cache["v"][i], layer["attn"], cfg,
            rms_norm(h, layer["attn_norm"], cfg.norm_eps), positions)
        h = _mlp(layer, cfg, h + attn_out)
    cache["idx"].fill_(S)
    return _logits(params, cfg, h[:, -1:])[:, 0], cache


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One AR decode step. tokens: (B, 1) -> logits (B, vocab); each
    layer writes the token's k / v into the cache at slot ``idx mod M``
    before attending, and ``idx`` advances."""
    h = params["embed"][tokens]
    K, V = cache["k"], cache["v"]              # (L, B, M, Hkv, D)
    tables = decode_tables(cache["idx"], h.shape[0], K.shape[2], cfg.hd(),
                           cfg.rope_theta)
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        attn_out = decode_attend(
            K[i], V[i], tables, layer["attn"], cfg,
            rms_norm(h, layer["attn_norm"], cfg.norm_eps))
        h = _mlp(layer, cfg, h + attn_out)
    cache["idx"].add_(1)
    return _logits(params, cfg, h)[:, 0], cache


# JAX's carried-cache variant; the port's one body already is that.
decode_step_inplace = decode_step
