"""Uniform model API over the architecture families (port of
``repro/models/registry.py``).

Each family adapter exposes:
  init_params(key, cfg, device=None, dtype)        -> params
  forward(params, cfg, tokens, embeds=None)        -> (logits, aux_loss)
  init_cache(cfg, batch, max_len, dtype, device)   -> cache dict
  prefill(params, cfg, tokens, cache, embeds=None) -> (last logits, cache)
  decode_step(params, cfg, tokens, cache)          -> (logits, cache)

``embeds`` carries the stub frontend's context (VLM patches, audio
frames): ``needs_embeds`` says the family expects it.  Every family of
the JAX registry is here: dense, moe, ssm (rwkv6), hybrid (Mamba2 +
shared attention), audio (enc-dec) and vlm.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from . import dense, encdec, hybrid, moe, rwkv6, vlm
from .common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable
    forward: Callable          # -> (logits, aux)
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    needs_embeds: bool = False  # stub frontend supplies `embeds`


def _wrap_no_aux(fwd):
    def f(params, cfg, tokens, embeds=None):
        logits = fwd(params, cfg, tokens, embeds=embeds)
        return logits, _zero_aux(logits)
    return f


def _zero_aux(logits: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=logits.device)


def _rwkv_forward(params, cfg, tokens, embeds=None):
    assert embeds is None
    logits = rwkv6.forward(params, cfg, tokens)
    return logits, _zero_aux(logits)


def _rwkv_cache(cfg, batch, max_len, dtype=torch.float32, device=None):
    del max_len  # O(1) state: the point of rwkv at long context
    return rwkv6.init_state(cfg, batch, dtype, device)


def _rwkv_prefill(params, cfg, tokens, cache, embeds=None):
    assert embeds is None
    return rwkv6.prefill(params, cfg, tokens, cache)


def _encdec_forward(params, cfg, tokens, embeds=None):
    assert embeds is not None, "audio arch needs frame embeddings"
    logits = encdec.forward(params, cfg, tokens, embeds)
    return logits, _zero_aux(logits)


def _encdec_cache(cfg, batch, max_len, dtype=torch.float32, device=None):
    return encdec.init_cache(cfg, batch, max_len, cfg.n_ctx_embeds, dtype,
                             device)


FAMILIES: Dict[str, ModelApi] = {
    "dense": ModelApi(dense.init_params, _wrap_no_aux(dense.forward),
                      dense.init_cache, dense.prefill, dense.decode_step),
    "moe": ModelApi(moe.init_params, moe.forward, moe.init_cache,
                    moe.prefill, moe.decode_step),
    "ssm": ModelApi(rwkv6.init_params, _rwkv_forward, _rwkv_cache,
                    _rwkv_prefill, rwkv6.decode_step),
    "hybrid": ModelApi(hybrid.init_params, _wrap_no_aux(hybrid.forward),
                       hybrid.init_cache, hybrid.prefill,
                       hybrid.decode_step),
    "audio": ModelApi(encdec.init_params, _encdec_forward, _encdec_cache,
                      encdec.prefill, encdec.decode_step,
                      needs_embeds=True),
    "vlm": ModelApi(vlm.init_params, _wrap_no_aux(vlm.forward),
                    vlm.init_cache, vlm.prefill, vlm.decode_step,
                    needs_embeds=True),
}


def get_api(cfg: ArchConfig) -> ModelApi:
    try:
        return FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")
