"""The llama-family dense layer (port of ``repro/models/dense.py:24-59``):
pre-norm GQA attention and a pre-norm SwiGLU FFN, both residual.

Parameters are plain dicts of tensors in the JAX pytree's (in, out)
layouts, so ``x @ w`` reads them as the JAX model does.
"""
from __future__ import annotations

from typing import Dict

import torch

from .attention import gqa_forward, init_gqa_params
from .common import ArchConfig, dense_init, rms_norm, swiglu


def init_layer(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32) -> Dict:
    """One layer, the JAX init's distributions drawn from ``generator`` on
    its device (not the JAX numbers)."""
    dev = generator.device
    return {
        "attn": init_gqa_params(generator, cfg, dtype),
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "w_gate": dense_init(generator, (cfg.d_model, cfg.d_ff), dtype),
        "w_up": dense_init(generator, (cfg.d_model, cfg.d_ff), dtype),
        "w_down": dense_init(
            generator, (cfg.d_ff, cfg.d_model), dtype,
            scale=cfg.d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }


def layer_fwd(layer: Dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    h = x + gqa_forward(layer["attn"], cfg,
                        rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                        positions, causal=causal)
    h = h + swiglu(rms_norm(h, layer["mlp_norm"], cfg.norm_eps),
                   layer["w_gate"], layer["w_up"], layer["w_down"])
    return h
