"""LLaVA-NeXT-style VLM (port of ``repro/models/vlm.py``;
llava-hf/llava-v1.6-mistral-7b-hf).

The vision tower (SigLIP / CLIP ViT + anyres tiling + 2-layer MLP
projector) is a stub, as in JAX: the caller supplies already-projected
patch embeddings (B, n_img_tokens, d_model).  The language backbone is the
Mistral-7B dense transformer over [image tokens ; text tokens], so every
function delegates to ``models.dense`` with an ``embeds`` prefix; decode
is plain LM decode (the image tokens live in the prefill).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import prng
from repro_torch.device import DeviceLike

from . import dense
from .common import ArchConfig

Params = Dict


def init_params(key: torch.Tensor, cfg: ArchConfig,
                device: DeviceLike = None, dtype=torch.float32) -> Params:
    return dense.init_params(key, cfg, device=device, dtype=dtype)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: (B, S_text); embeds: (B, n_img_tokens, d) projected
    patches."""
    return dense.forward(params, cfg, tokens, embeds=embeds)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return dense.init_cache(cfg, batch, max_len, dtype, device)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict, embeds: Optional[torch.Tensor] = None):
    return dense.prefill(params, cfg, tokens, cache, embeds=embeds)


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Dict):
    return dense.decode_step(params, cfg, tokens, cache)


def stub_embeds(cfg: ArchConfig, batch: int, device) -> Optional[torch.Tensor]:
    """The launch scripts' stub frontend for a vlm (JAX's
    ``launch/serve.py:127``): normal(PRNGKey(9), (batch, n_ctx_embeds,
    d_model)) * 0.02 on ``device``; None for a family whose registry
    entry does not set ``needs_embeds``."""
    from .registry import get_api   # registry imports this module
    if not get_api(cfg).needs_embeds:
        return None
    return prng.normal(prng.PRNGKey(9, device),
                       (batch, cfg.n_ctx_embeds, cfg.d_model)) * 0.02
