"""Encoder-decoder transformer backbone (seamless-m4t-large-v2, audio;
port of ``repro/models/encdec.py``).

The modality frontend (mel spectrogram + conformer feature extractor) is
a stub, as in JAX: the model reads precomputed frame embeddings
(B, frames, d_model).  The backbone is whole: a bidirectional encoder, a
causal decoder with cross-attention, the text unembedding.

Serving: ``prefill`` runs the encoder once, computes each decoder
layer's cross K / V once (static for the whole generation) into the
cache's ``xk`` / ``xv``, and fills the decoder's self K / V;
``decode_step`` is one decoder token against both.  The cache is written
in place, as in ``models/dense.py``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from .attention import (cross_attend, cross_kv, decode_attend, decode_tables,
                        gqa_cross_forward, gqa_forward, gqa_prefill,
                        gqa_shapes, init_gqa_params)
from .common import (ArchConfig, KeyGen, dense_init, embed_init, matmul,
                     rms_norm, stack_layer_params, stacked, swiglu)
from .dense import _positions, layer_params, unstack_layers

Params = Dict


def _init_ffn(kg: KeyGen, cfg: ArchConfig, dtype) -> Dict:
    return {
        "w_gate": dense_init(kg(), (cfg.d_model, cfg.d_ff), dtype),
        "w_up": dense_init(kg(), (cfg.d_model, cfg.d_ff), dtype),
        "w_down": dense_init(kg(), (cfg.d_ff, cfg.d_model), dtype),
    }


def init_enc_layer(key: torch.Tensor, cfg: ArchConfig,
                   dtype=torch.float32) -> Dict:
    kg = KeyGen(key)
    layer = {"attn": init_gqa_params(kg, cfg, dtype)}
    layer["attn_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                    device=key.device)
    layer["mlp_norm"] = layer["attn_norm"].clone()
    layer.update(_init_ffn(kg, cfg, dtype))
    return layer


def init_dec_layer(key: torch.Tensor, cfg: ArchConfig,
                   dtype=torch.float32) -> Dict:
    kg = KeyGen(key)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=key.device)

    layer = {"self_attn": init_gqa_params(kg, cfg, dtype),
             "self_norm": ones()}
    layer["cross_attn"] = init_gqa_params(kg, cfg, dtype)
    layer.update(cross_norm=ones(), mlp_norm=ones())
    layer.update(_init_ffn(kg, cfg, dtype))
    return layer


def _ffn_shapes(cfg: ArchConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def param_shapes(cfg: ArchConfig) -> Dict:
    """The parameter tree as nested dicts of shapes (``init_params``)."""
    d = cfg.d_model
    enc = {"attn": gqa_shapes(cfg), "attn_norm": (d,), "mlp_norm": (d,),
           **_ffn_shapes(cfg)}
    dec = {"self_attn": gqa_shapes(cfg), "self_norm": (d,),
           "cross_attn": gqa_shapes(cfg), "cross_norm": (d,),
           "mlp_norm": (d,), **_ffn_shapes(cfg)}
    return {"embed": (cfg.vocab, d),
            "enc_layers": stacked(enc, cfg.enc_layers), "enc_norm": (d,),
            "dec_layers": stacked(dec, cfg.dec_layers), "final_norm": (d,),
            "unembed": (d, cfg.vocab)}


def init_params(key: torch.Tensor, cfg: ArchConfig,
                device: DeviceLike = None, dtype=torch.float32) -> Params:
    """JAX's ``init_params(key, cfg, dtype)`` numbers for a threefry key
    on ``device`` (CUDA unless named): embed, the encoder layers, the
    decoder layers, unembed, in its key order."""
    dev = resolve_device(device)
    kg = KeyGen(key.to(dev))
    d = cfg.d_model
    return {
        "embed": embed_init(kg(), (cfg.vocab, d), dtype),
        "enc_layers": stack_layer_params(
            lambda k: init_enc_layer(k, cfg, dtype), cfg.enc_layers, kg),
        "enc_norm": torch.ones((d,), dtype=dtype, device=dev),
        "dec_layers": stack_layer_params(
            lambda k: init_dec_layer(k, cfg, dtype), cfg.dec_layers, kg),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "unembed": dense_init(kg(), (d, cfg.vocab), dtype),
    }


def _mlp(layer: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return x + swiglu(rms_norm(x, layer["mlp_norm"], cfg.norm_eps),
                      layer["w_gate"], layer["w_up"], layer["w_down"])


def encode(params: Params, cfg: ArchConfig,
           frame_embeds: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings (B, F, d)."""
    B, F, _ = frame_embeds.shape
    positions = _positions(B, F, frame_embeds.device)
    x = frame_embeds
    for layer in unstack_layers(params["enc_layers"], cfg.enc_layers):
        x = x + gqa_forward(layer["attn"], cfg,
                            rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                            positions, causal=False)
        x = _mlp(layer, cfg, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer_fwd(layer: Dict, cfg: ArchConfig, x: torch.Tensor,
                   enc_out: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    x = x + gqa_forward(layer["self_attn"], cfg,
                        rms_norm(x, layer["self_norm"], cfg.norm_eps),
                        positions)
    x = x + gqa_cross_forward(layer["cross_attn"], cfg,
                              rms_norm(x, layer["cross_norm"], cfg.norm_eps),
                              enc_out)
    return _mlp(layer, cfg, x)


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return matmul(rms_norm(h, params["final_norm"], cfg.norm_eps),
                  params["unembed"])


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            embeds: torch.Tensor) -> torch.Tensor:
    """Training forward: embeds = frame embeddings (B, F, d); tokens =
    decoder text tokens (B, S).  Returns decoder logits (B, S, vocab)."""
    enc_out = encode(params, cfg, embeds)
    h = params["embed"][tokens]
    B, S, _ = h.shape
    positions = _positions(B, S, h.device)
    for layer in unstack_layers(params["dec_layers"], cfg.dec_layers):
        h = _dec_layer_fwd(layer, cfg, h, enc_out, positions)
    return _logits(params, cfg, h)


# ------------------------------------------------------------------ serving
def init_cache(cfg: ArchConfig, batch: int, max_len: int, n_frames: int,
               dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Self k / v (L, B, M, Hkv, D), cross xk / xv (L, B, n_frames, Hkv,
    D) and idx, all zero (L = dec_layers)."""
    Hkv, D, L = cfg.n_kv_heads, cfg.hd(), cfg.dec_layers
    M = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len

    def zeros(n):
        return torch.zeros((L, batch, n, Hkv, D), dtype=dtype, device=device)

    return {"k": zeros(M), "v": zeros(M), "xk": zeros(n_frames),
            "xv": zeros(n_frames),
            "idx": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict, embeds: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Encode the frames, run the decoder prompt and fill the self and
    cross caches in place.  Returns (last-position logits (B, vocab),
    cache)."""
    enc_out = encode(params, cfg, embeds)
    h = params["embed"][tokens]
    B, S, _ = h.shape
    positions = _positions(B, S, h.device)
    zero = torch.zeros((S, enc_out.shape[1]), dtype=torch.float32,
                       device=h.device)
    for i in range(cfg.dec_layers):
        layer = layer_params(params["dec_layers"], i)
        attn_out, _, _ = gqa_prefill(
            cache["k"][i], cache["v"][i], layer["self_attn"], cfg,
            rms_norm(h, layer["self_norm"], cfg.norm_eps), positions)
        h = h + attn_out
        xk, xv = cross_kv(layer["cross_attn"], cfg, enc_out)
        cache["xk"][i].copy_(xk)
        cache["xv"][i].copy_(xv)
        h = h + cross_attend(layer["cross_attn"], cfg,
                             rms_norm(h, layer["cross_norm"], cfg.norm_eps),
                             xk, xv, zero)
        h = _mlp(layer, cfg, h)
    cache["idx"].fill_(S)
    return _logits(params, cfg, h[:, -1:])[:, 0], cache


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decoder token (B, 1) against the self cache (written in place
    at slot ``idx mod M``) and the cached cross K / V (a scalar zero
    mask, as JAX's).  Returns (logits (B, vocab), cache)."""
    h = params["embed"][tokens]
    K, V = cache["k"], cache["v"]
    tables = decode_tables(cache["idx"], h.shape[0], K.shape[2], cfg.hd(),
                           cfg.rope_theta)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.dec_layers):
        layer = layer_params(params["dec_layers"], i)
        h = h + decode_attend(K[i], V[i], tables, layer["self_attn"], cfg,
                              rms_norm(h, layer["self_norm"], cfg.norm_eps))
        h = h + cross_attend(layer["cross_attn"], cfg,
                             rms_norm(h, layer["cross_norm"], cfg.norm_eps),
                             cache["xk"][i], cache["xv"][i], zero)
        h = _mlp(layer, cfg, h)
    cache["idx"].add_(1)
    return _logits(params, cfg, h)[:, 0], cache
