"""Uniform model API over the architecture families (port of
``repro/models/registry.py``).

Each family adapter exposes:
  init_params(key, cfg, device=None, dtype)        -> params
  forward(params, cfg, tokens, embeds=None)        -> (logits, aux_loss)
  init_cache(cfg, batch, max_len, dtype, device)   -> cache dict
  prefill(params, cfg, tokens, cache, embeds=None) -> (last logits, cache)
  decode_step(params, cfg, tokens, cache)          -> (logits, cache)

``embeds`` carries the stub frontend's context (VLM patches):
``needs_embeds`` says the family expects it.  The dense, moe and vlm
families are ported; ssm, hybrid and audio raise NotImplementedError
naming the JAX module that holds them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from . import dense, moe, vlm
from .common import ArchConfig

# family -> the JAX module that implements it
UNPORTED_FAMILIES: Dict[str, str] = {
    "ssm": "repro/models/rwkv6.py",
    "hybrid": "repro/models/hybrid.py",
    "audio": "repro/models/encdec.py",
}


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
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)
    return f


FAMILIES: Dict[str, ModelApi] = {
    "dense": ModelApi(dense.init_params, _wrap_no_aux(dense.forward),
                      dense.init_cache, dense.prefill, dense.decode_step),
    "moe": ModelApi(moe.init_params, moe.forward, moe.init_cache,
                    moe.prefill, moe.decode_step),
    "vlm": ModelApi(vlm.init_params, _wrap_no_aux(vlm.forward),
                    vlm.init_cache, vlm.prefill, vlm.decode_step,
                    needs_embeds=True),
}


def refuse_unported(family: str, what: str) -> None:
    """Raise NotImplementedError for a family the port does not have."""
    raise NotImplementedError(
        f"{what}: the {family!r} family is not ported yet (JAX: "
        f"{UNPORTED_FAMILIES[family]}); the port serves the "
        f"{sorted(FAMILIES)} families")


def get_api(cfg: ArchConfig) -> ModelApi:
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    if cfg.family in UNPORTED_FAMILIES:
        refuse_unported(cfg.family, cfg.name)
    raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")
