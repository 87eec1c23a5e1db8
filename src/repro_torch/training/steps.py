"""Train and serve step builders (port of ``repro/training/steps.py``).

Two kinds of train step:
  * the LM next-token step (cross-entropy + the family's aux loss, then
    the optimizer), with optional gradient accumulation over microbatches;
  * the diffusion step (the paper's own training, Eq. 5 with gamma = 1)
    for the U-Net and the diffusion-LM trunks.

A step is a plain function ``train_step(state, batch) -> (state,
metrics)`` over a ``TrainState`` of (params, optimizer state, threefry
key); params are a tree of tensors (nested dicts), so are the gradients
and the optimizer state, as in JAX.  A module's parameters enter as the
flat dict of its names; the loss then runs the module through
``torch.func.functional_call``.  The gradient is ``torch.autograd.grad``
of the loss with respect to every leaf (a leaf the loss does not reach
gets zeros, as ``jax.grad`` gives).  The key advances as JAX's does:
``rng, sub = split(state.rng)`` and the loss draws from ``sub``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import get_api

from .optim import (AdafactorConfig, AdamWConfig, adafactor_init,
                    adafactor_update, adamw_init, adamw_update,
                    tree_from_leaves, tree_leaves, tree_map)

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Tree
    opt: Any
    rng: torch.Tensor


def _opt_fns(opt_cfg):
    if isinstance(opt_cfg, AdafactorConfig):
        return adafactor_init, functools.partial(adafactor_update, opt_cfg)
    return adamw_init, functools.partial(adamw_update, opt_cfg)


def value_and_grad(loss_fn: Callable, params: Tree, *args
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Tree]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    ((loss, aux), grads) with grads a tree like params."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = loss_fn(live, *args)
        grads = torch.autograd.grad(loss, list(tree_leaves(live)),
                                    allow_unused=True,
                                    materialize_grads=True)
    aux = tree_map(lambda a: a.detach() if torch.is_tensor(a) else a, aux)
    return (loss.detach(), aux), tree_from_leaves(params, grads)


def lm_loss_fn(api, cfg: ArchConfig, params: Tree, tokens: torch.Tensor,
               embeds: Optional[torch.Tensor], aux_weight: float = 0.01
               ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy (float32) + aux_weight * the family's
    aux loss."""
    logits, aux = api.forward(params, cfg, tokens, embeds=embeds)
    S = tokens.shape[1]
    logits = logits[:, -S:]                      # drop ctx-embed positions
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, tokens[:, 1:, None].long())
    loss = torch.mean(nll)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def make_lm_train_step(cfg: ArchConfig, opt_cfg, aux_weight: float = 0.01,
                       accum_steps: int = 1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens": (B, S) int32, optional "embeds": (B, F, d)}.
    ``accum_steps > 1`` splits the batch into microbatches: their
    gradients are summed into float32 zeros in order and divided by
    ``accum_steps`` (JAX's scan), and the metrics are microbatch means.
    Activation memory then scales with B / accum_steps.
    """
    api = get_api(cfg)
    _, opt_update = _opt_fns(opt_cfg)

    def grads_of(p, batch):
        def loss_fn(p):
            return lm_loss_fn(api, cfg, p, batch["tokens"],
                              batch.get("embeds"), aux_weight)
        return value_and_grad(loss_fn, p)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if accum_steps == 1:
            (_, metrics), grads = grads_of(state.params, batch)
        else:
            B = batch["tokens"].shape[0]
            assert B % accum_steps == 0
            mb = B // accum_steps
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            stack = []
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                (_, m), g = grads_of(state.params, micro)
                grads = tree_map(torch.add, grads, g)
                stack.append(m)
            grads = tree_map(lambda g: g / accum_steps, grads)
            metrics = {k: torch.mean(torch.stack([m[k] for m in stack]))
                       for k in stack[0]}
        new_params, new_opt, opt_metrics = opt_update(
            grads, state.opt, state.params)
        rng, _ = prng.split(state.rng)
        return (TrainState(new_params, new_opt, rng),
                {**metrics, **opt_metrics})

    return train_step


def make_diffusion_train_step(loss_fn: Callable, opt_cfg) -> Callable:
    """Generic diffusion train step; ``loss_fn(params, batch, rng) ->
    (loss, metrics)``."""
    _, opt_update = _opt_fns(opt_cfg)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        rng, sub = prng.split(state.rng)
        (loss, metrics), grads = value_and_grad(loss_fn, state.params,
                                                batch, sub)
        new_params, new_opt, opt_metrics = opt_update(
            grads, state.opt, state.params)
        return (TrainState(new_params, new_opt, rng),
                {"loss": loss, **metrics, **opt_metrics})

    return train_step


def init_train_state(params: Tree, rng: torch.Tensor,
                     opt_cfg=None) -> TrainState:
    opt_init, _ = _opt_fns(opt_cfg if opt_cfg is not None else AdamWConfig())
    params = tree_map(lambda p: p.detach(), params)
    return TrainState(params=params, opt=opt_init(params), rng=rng)


def module_loss(module: torch.nn.Module, loss: Callable) -> Callable:
    """A diffusion ``loss_fn(params, batch, rng)`` over a module's flat
    parameter dict: ``loss(eps_fn, batch, rng)`` gets the module run
    through ``torch.func.functional_call`` with those parameters."""
    def loss_fn(params, batch, rng):
        def eps_fn(x, t):
            return torch.func.functional_call(module, params, (x, t))
        return loss(eps_fn, batch, rng)
    return loss_fn


# ------------------------------------------------------------ serve steps
def make_prefill_step(cfg: ArchConfig) -> Callable:
    api = get_api(cfg)

    def prefill_step(params, tokens, cache, embeds=None):
        return api.prefill(params, cfg, tokens, cache, embeds=embeds)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    api = get_api(cfg)

    def decode_step(params, tokens, cache):
        return api.decode_step(params, cfg, tokens, cache)

    return decode_step
