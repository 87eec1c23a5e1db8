"""Diffusion-LM over a dense transformer trunk (port of
``repro.diffusion_lm``)."""
from .model import (DiffusionLMConfig, embed_tokens, eps_forward, generate,
                    init_params, make_eps_fn, make_tile_eps_fn,
                    round_to_tokens, training_loss)

__all__ = ["DiffusionLMConfig", "embed_tokens", "eps_forward", "generate",
           "init_params", "make_eps_fn", "make_tile_eps_fn",
           "round_to_tokens", "training_loss"]
