"""Uniform model API over the architecture families (port of
``repro/models/registry.py``).

Each family adapter exposes:
  init_params(cfg, generator, device=None, dtype)  -> params
  forward(params, cfg, tokens, embeds=None)        -> (logits, aux_loss)
  init_cache(cfg, batch, max_len, dtype, device)   -> cache dict
  prefill(params, cfg, tokens, cache, embeds=None) -> (last logits, cache)
  decode_step(params, cfg, tokens, cache)          -> (logits, cache)

Only the dense family is ported.  The others raise NotImplementedError
naming the JAX module that holds them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from . import dense
from .common import ArchConfig

# family -> the JAX module that implements it
UNPORTED_FAMILIES: Dict[str, str] = {
    "moe": "repro/models/moe.py",
    "ssm": "repro/models/rwkv6.py",
    "hybrid": "repro/models/hybrid.py",
    "audio": "repro/models/encdec.py",
    "vlm": "repro/models/vlm.py",
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable
    forward: Callable          # -> (logits, aux)
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def _wrap_no_aux(fwd):
    def f(params, cfg, tokens, embeds=None):
        logits = fwd(params, cfg, tokens, embeds=embeds)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)
    return f


FAMILIES: Dict[str, ModelApi] = {
    "dense": ModelApi(dense.init_params, _wrap_no_aux(dense.forward),
                      dense.init_cache, dense.prefill, dense.decode_step),
}


def refuse_unported(family: str, what: str) -> None:
    """Raise NotImplementedError for a family the port does not have."""
    raise NotImplementedError(
        f"{what}: the {family!r} family is not ported yet (JAX: "
        f"{UNPORTED_FAMILIES[family]}); the port serves the 'dense' family")


def get_api(cfg: ArchConfig) -> ModelApi:
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    if cfg.family in UNPORTED_FAMILIES:
        refuse_unported(cfg.family, cfg.name)
    raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")
