"""The executors behind ``SamplerPlan.run`` (port of
``repro/sampling/backends.py``).

All backends consume the same compiled coefficient table and the same
per-step float32 arithmetic (``kernel_update``, the plain version of the
kernel body), so an eta=0 plan gives bitwise-equal outputs on 'eager' and
on the kernel backends' CPU path:

  run_eager          plain PyTorch loop over the natural shape (the
                     counterpart of the JAX 'jnp' reference; its noise, for
                     stochastic plans, comes from torch.randn).
  run_tile_resident  the production hot path: one conversion into the
                     padded (R, 256) tile layout, the whole S-step loop
                     carried there, one sampler_step_2d launch per step.
  run_rows           the per-row kernel sampler_step_rows_2d driven in
                     lockstep over the slot-tile layout.
  run_mega           the megakernel megastep_call: eps trunk and update
                     fused, K plan steps per launch, for eligible
                     (eps model, plan) pairs; the tile-resident loop for
                     every other.

Randomness stays outside the step loops: the kernel backends draw their
per-step int32 seeds from the generator up front (``(S,)`` for the scalar
kernel, ``(S, B)`` per-slot seeds for the rows kernel), then run the inner
loops ``_loop_tiles`` / ``_loop_rows``, which tests can hand the very seeds
the JAX package drew.  Deterministic plans draw nothing and launch the
kernels' no-PRNG specializations.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.solver import mix_history
from repro_torch.kernels.sampler_step import ops as tile_ops
from repro_torch.kernels.sampler_step.ref import update

_INT32_MAX = np.iinfo(np.int32).max


def kernel_update(x32, eps32, c_x0, c_dir, sqrt_a_t, sqrt_1m_a_t, clip):
    """The kernel body's deterministic part (x_prev without noise)."""
    return update(x32, eps32, c_x0, c_dir, sqrt_a_t, sqrt_1m_a_t, clip)[1]


def _table(plan, device) -> Dict[str, torch.Tensor]:
    """The plan's table as tensors on ``device`` (one copy per run)."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in plan.steps().items()}


def _hist0(order: int, shape, device):
    if order == 1:
        return None
    return torch.zeros((order - 1,) + tuple(shape), dtype=torch.float32,
                       device=device)


def _timesteps(t: int, batch: int, device) -> torch.Tensor:
    return torch.full((batch,), int(t), dtype=torch.int32, device=device)


def _draw_seeds(generator: torch.Generator, size) -> torch.Tensor:
    """int32 seeds in [0, 2**31 - 1), as the JAX backends draw them."""
    return torch.randint(0, _INT32_MAX, size, generator=generator,
                         device=generator.device, dtype=torch.int32)


# ----------------------------------------------------------------- eager
def run_eager(plan, eps_fn, x_T: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    tab = _table(plan, x_T.device)
    ts = plan.steps()["t"]
    clip, order = plan.x0.clip, plan.order
    x, hist = x_T, _hist0(order, x_T.shape, x_T.device)
    for k in range(plan.S):
        e32 = eps_fn(x, _timesteps(ts[k], x.shape[0], x.device)).float()
        e32, hist = mix_history(e32, hist, tab["solver_w"][k], order)
        out = kernel_update(x.float(), e32, tab["c_x0"][k], tab["c_dir"][k],
                            tab["sqrt_a_t"][k], tab["sqrt_1m_a_t"][k], clip)
        if plan.stochastic:
            out = out + tab["c_noise"][k] * torch.randn(
                x.shape, generator=generator, dtype=torch.float32,
                device=generator.device).to(x.device)
        x = out.to(x_T.dtype)
    return x


# --------------------------------------------------------- tile_resident
def run_tile_resident(plan, eps_fn, x_T: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    seeds = _draw_seeds(generator, (plan.S,)) if plan.stochastic else None
    x2, n = tile_ops.to_tile_layout(x_T)              # conversion #1 (entry)
    x2 = _loop_tiles(plan, eps_fn, x2, seeds, n, x_T.shape)
    return tile_ops.from_tile_layout(x2, n, x_T.shape)  # conversion #2


def _loop_tiles(plan, eps_fn, x2: torch.Tensor, seeds, n: int, shape):
    """The S-step loop in the tile layout; ``seeds`` is (S,) int32 or None.
    """
    tab = plan.steps()
    cmat = np.stack([tab["c_x0"], tab["c_dir"], tab["c_noise"],
                     tab["sqrt_a_t"], tab["sqrt_1m_a_t"]], axis=1)  # (S, 5)
    seeds = (None if seeds is None
             else [int(s) for s in torch.as_tensor(seeds).tolist()])
    order, clip = plan.order, plan.x0.clip
    w = _table(plan, x2.device)["solver_w"] if order > 1 else None
    hist = _hist0(order, x2.shape, x2.device)
    batch = shape[0]
    tile_aware = getattr(eps_fn, "tile_aware", False)
    for k in range(plan.S):
        t = _timesteps(tab["t"][k], batch, x2.device)
        if tile_aware:                     # native (R, C) model
            eps2 = eps_fn(x2, t)
        else:
            x_view = tile_ops.from_tile_layout(x2, n, shape)
            eps2, _ = tile_ops.to_tile_layout(eps_fn(x_view, t))
        if order > 1:
            eps2, hist = mix_history(eps2.float(), hist, w[k], order)
        x2 = tile_ops.sampler_step_tiles(
            x2, eps2.contiguous(), cmat[k],
            None if seeds is None else seeds[k], clip=clip,
            stochastic=plan.stochastic)
    return x2


# ------------------------------------------------------------------ rows
def run_rows(plan, eps_fn, x_T: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    B = x_T.shape[0]
    seeds = _draw_seeds(generator, (plan.S, B)) if plan.stochastic else None
    x2, n = tile_ops.to_slot_tile_layout(x_T)
    x2 = _loop_rows(plan, eps_fn, x2, seeds, n, x_T.shape)
    return tile_ops.from_slot_tile_layout(x2, n, x_T.shape)


def _loop_rows(plan, eps_fn, x2: torch.Tensor, seeds, n: int, batch_shape):
    """The lockstep loop over the slot-tile layout; ``seeds`` is (S, B)
    int32 per-slot tick seeds or None.  The per-step row tables are built
    once, before the loop."""
    B = batch_shape[0]
    rps = x2.shape[0] // B
    device = x2.device
    tab = _table(plan, device)
    cmat = torch.stack([tab["c_x0"], tab["c_dir"], tab["c_noise"],
                        tab["sqrt_a_t"], tab["sqrt_1m_a_t"]], dim=1)  # (S,5)
    cmat = torch.nn.functional.pad(cmat, (0, tile_ops.COEF_COLS - 5))
    row_coefs_all = cmat.repeat_interleave(B * rps, dim=0).reshape(
        plan.S, B * rps, tile_ops.COEF_COLS)
    row_seeds_all = (None if seeds is None else torch.stack([
        tile_ops.derive_row_seeds(s, rps)
        for s in torch.as_tensor(seeds).to(device)]))            # (S, R)
    order, clip = plan.order, plan.x0.clip
    hist = _hist0(order, x2.shape, device)
    ts = plan.steps()["t"]
    for k in range(plan.S):
        x_nat = tile_ops.from_slot_tile_layout(x2, n, batch_shape)
        eps = eps_fn(x_nat, _timesteps(ts[k], B, device))
        eps2, _ = tile_ops.to_slot_tile_layout(eps)
        if order > 1:
            eps2, hist = mix_history(eps2.float(), hist, tab["solver_w"][k],
                                     order)
        x2 = tile_ops.sampler_step_rows(
            x2, eps2.contiguous(), row_coefs_all[k],
            None if row_seeds_all is None else row_seeds_all[k], clip=clip,
            stochastic=plan.stochastic)
    return x2


# ------------------------------------------------------------------ mega
def run_mega(plan, eps_fn, x_T: torch.Tensor,
             generator: Optional[torch.Generator],
             k_fuse: Optional[int] = None) -> torch.Tensor:
    """The megakernel path: trunk + update fused, K plan steps per launch.

    Eligibility is the JAX package's rule: a deterministic order-1 plan
    over an eps model whose ``mega_spec`` fits ``MEGA_BUDGET`` runs fused;
    everything else runs the tile-resident loop (the same arithmetic,
    unfused).  Why is kept in ``run_mega.last_reason`` ("ok" when fused).
    An S-step plan is exactly ceil(S / K) launches; the last chunk takes
    the S % K remainder as its own smaller K.
    """
    from repro_torch.kernels import megastep as mega_ops

    ok, why = mega_ops.eligible(getattr(eps_fn, "mega_spec", None), x_T)
    if ok and plan.stochastic:
        ok, why = False, "the plan is stochastic (mega plans take no noise)"
    if ok and plan.order > 1:
        ok, why = False, f"the plan has solver order {plan.order} > 1"
    run_mega.last_reason = why
    if not ok:
        return run_tile_resident(plan, eps_fn, x_T, generator)
    spec = eps_fn.mega_spec
    tab = plan.steps()
    S = plan.S
    K = mega_ops.DEFAULT_K_FUSE if k_fuse is None else int(k_fuse)
    K = max(1, min(K, S))
    coefs = torch.from_numpy(np.stack(
        [tab["c_x0"], tab["c_dir"], tab["c_noise"], tab["sqrt_a_t"],
         tab["sqrt_1m_a_t"]], axis=1)).to(x_T.device)          # (S, 5)
    ts = torch.from_numpy(np.array(tab["t"])).to(x_T.device)   # (S,)
    x2, n = tile_ops.to_tile_layout(x_T)              # conversion #1 (entry)
    for c0 in range(0, S, K):                         # ceil(S/K) launches
        x2 = mega_ops.megastep_tiles(x2, spec, coefs[c0:c0 + K],
                                     ts[c0:c0 + K], clip=plan.x0.clip)
    return tile_ops.from_tile_layout(x2, n, x_T.shape)  # conversion #2


run_mega.last_reason = None
