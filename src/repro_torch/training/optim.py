"""Optimizers written out in plain tensor ops (port of
``repro/training/optim.py``): AdamW with decoupled weight decay and
global-norm clipping, Adafactor (factored second moments, RMS update
clipping), an EMA of the parameters (the DDPM/DDIM papers sample from the
EMA model) and the LR schedules.

Parameters, gradients and every optimizer state are trees: nested dicts of
tensors (a U-Net's parameters are one flat dict of names).  The state
mirrors the parameter tree.  Leaves are visited in the JAX package's
flatten order, dict keys sorted, so ``global_norm`` sums them in JAX's
order wherever the key names are JAX's (the dense and diffusion-LM trees).
The arithmetic is JAX's op for op in float32: the step count and the
schedule are float32 tensors, and ``b1 ** step`` is a float32 power.
AdamW and the EMA run each op over every leaf at once (``torch._foreach_*``:
a few launches per op on the card, not one per leaf), bitwise the
per-leaf loop; Adafactor keeps the loop (its leaves differ in shape
class).  Nothing here is differentiated; it runs under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple)

import torch

Tree = Any


def tree_leaves(tree: Tree) -> Iterator[torch.Tensor]:
    """The leaves in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_from_leaves(like: Tree, leaves) -> Tree:
    """A tree like ``like`` from leaves in ``tree_leaves`` order (keys in
    ``like``'s own order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)
    return build(like)


def _split(out: Tree, i: int) -> Tree:
    if isinstance(out, dict):
        return {k: _split(v, i) for k, v in out.items()}
    return out[i]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0       # 0 disables clipping
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def adamw_init(params: Tree) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    first = next(tree_leaves(params))
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      mu=zeros, nu=tree_map(torch.clone, zeros))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in JAX's order) of each leaf's float32
    sum of squares."""
    gs = [g.float() for g in tree_leaves(tree)]
    total = 0
    for sq in torch._foreach_mul(gs, gs):
        total = total + torch.sum(sq)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    leaves = list(tree_leaves(grads))
    return tree_from_leaves(grads, torch._foreach_mul(
        leaves, scale.to(leaves[0].dtype))), gnorm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree) -> Tuple[Tree, AdamWState, Dict]:
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
    s = step.float()
    b1c = 1.0 - torch.pow(_f32(cfg.b1, s), s)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, s), s)

    ps = list(tree_leaves(params))
    gs = [g.float() for g in tree_leaves(grads)]
    pf = [p.float() for p in ps]
    add, mul, div = torch._foreach_add, torch._foreach_mul, torch._foreach_div
    # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    m = add(mul(list(tree_leaves(state.mu)), cfg.b1), mul(gs, 1 - cfg.b1))
    v = add(mul(list(tree_leaves(state.nu)), cfg.b2),
            mul(mul(gs, gs), 1 - cfg.b2))
    # delta = (m / b1c) / (sqrt(v / b2c) + eps) [+ wd p];  p - lr delta
    delta = div(div(m, b1c),
                add(torch._foreach_sqrt(div(v, b2c)), cfg.eps))
    if cfg.weight_decay:
        delta = add(delta, mul(pf, cfg.weight_decay))
    new = torch._foreach_sub(pf, mul(delta, lr))
    new = [n.to(p.dtype) for n, p in zip(new, ps)]
    return (tree_from_leaves(params, new),
            AdamWState(step, tree_from_leaves(params, m),
                       tree_from_leaves(params, v)),
            {"grad_norm": gnorm, "lr": lr})


# -------------------------------------------------------------- Adafactor
class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Tree       # row-factored second moment (>= 2-D params)
    vc: Tree       # column-factored second moment
    v: Tree        # full second moment (< 2-D params)


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    """Factored second-moment optimizer (Shazeer & Stern 2018), without
    momentum: the state is ~2 x sqrt-size instead of 2 x full-size."""
    lr: float = 1e-3
    decay: float = 0.8           # beta2_t = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params: Tree) -> AdafactorState:
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vr_init(p):
        return zeros(p.shape[:-1] if _factored(p.shape) else (), p)

    def vc_init(p):
        return zeros(p.shape[:-2] + p.shape[-1:] if _factored(p.shape)
                     else (), p)

    def v_init(p):
        return zeros(() if _factored(p.shape) else p.shape, p)

    first = next(tree_leaves(params))
    return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                           device=first.device),
                          vr=tree_map(vr_init, params),
                          vc=tree_map(vc_init, params),
                          v=tree_map(v_init, params))


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, grads: Tree,
                     state: AdafactorState, params: Tree
                     ) -> Tuple[Tree, AdafactorState, Dict]:
    step = state.step + 1
    beta2 = 1.0 - torch.pow(step.float(), -cfg.decay)
    gnorm = global_norm(grads)

    def upd(p, g, vr, vc, v):
        gf = g.float()
        g2 = torch.square(gf) + cfg.eps
        if _factored(p.shape):
            vr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
            mean_r = torch.mean(vr, dim=-1, keepdim=True)
            u = gf * torch.rsqrt(
                (vr / torch.clamp(mean_r, min=cfg.eps))[..., None]
                * vc[..., None, :] + cfg.eps)
        else:
            v = beta2 * v + (1 - beta2) * g2
            u = gf * torch.rsqrt(v + cfg.eps)
        # update clipping by RMS (Shazeer & Stern eq. 6)
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        new_p = p.float() - cfg.lr * u
        if cfg.weight_decay:
            new_p = new_p - cfg.lr * cfg.weight_decay * p.float()
        return new_p.to(p.dtype), vr, vc, v

    out = tree_map(upd, params, grads, state.vr, state.vc, state.v)
    return _split(out, 0), AdafactorState(
        step, _split(out, 1), _split(out, 2), _split(out, 3)), {
            "grad_norm": gnorm}


# ------------------------------------------------------------------ EMA
def ema_init(params: Tree) -> Tree:
    return tree_map(lambda p: p.detach().clone(), params)


@torch.no_grad()
def ema_update(ema: Tree, params: Tree, decay: float = 0.9999) -> Tree:
    """decay * ema + (1 - decay) * params, leaf by leaf."""
    new = torch._foreach_add(
        torch._foreach_mul(list(tree_leaves(ema)), decay),
        torch._foreach_mul(list(tree_leaves(params)), 1.0 - decay))
    return tree_from_leaves(ema, new)


# ------------------------------------------------------------ LR schedules
def warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to 1 over ``warmup`` steps, then a cosine down to
    ``floor`` at ``total``; float32 tensor math on the step's device."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(1.0, warmup)
        prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return schedule


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)
