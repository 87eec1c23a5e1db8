"""The executors behind ``SamplerPlan.run`` (port of
``repro/sampling/backends.py``).

All backends consume the same compiled coefficient table and the same
per-step float32 arithmetic (``kernel_update``, the plain version of the
kernel body), so an eta=0 plan gives bitwise-equal outputs on 'eager' and
on the kernel backends' CPU path:

  run_eager          plain PyTorch loop over the natural shape (the
                     counterpart of the JAX 'jnp' reference; its noise, for
                     stochastic plans, is ``prng.normal`` of one key per
                     step, as JAX draws it).
  run_tile_resident  the production hot path: one conversion into the
                     padded (R, 256) tile layout, the whole S-step loop
                     carried there, one sampler_step_2d launch per step.
  run_rows           the per-row kernel sampler_step_rows_2d driven in
                     lockstep over the slot-tile layout.
  run_mega           the megakernel megastep_call: eps trunk and update
                     fused, K plan steps per launch, for eligible
                     (eps model, plan) pairs; the tile-resident loop for
                     every other.
  encode_eager       the forward ODE direction x_0 -> x_T on the plan's
                     own trajectory (the counterpart of JAX's encode_jnp).

Every run_* takes ``return_trajectory``: it then returns ``(x0, traj)``
with ``traj`` the (S + 1, batch, *shape) stack of iterates, ``traj[0]`` =
x_T and ``traj[-1]`` = x0, as the JAX backends do.  The tile backends
convert each step's state back with ``from_tile_layout`` /
``from_slot_tile_layout`` (views of the step's output, no copy per step).

Randomness stays outside the step loops: the kernel backends draw their
per-step int32 seeds from the run's threefry key up front with JAX's
``randint`` (``(S,)`` for the scalar kernel, ``(S, B)`` per-slot seeds for
the rows kernel), so one key gives the JAX package's seeds, then run the
inner loops ``_loop_tiles`` / ``_loop_rows``.  Deterministic plans draw
nothing and launch the kernels' no-PRNG specializations.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.solver import mix_history, warmup_weights
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


def _draw_seeds(rng: torch.Tensor, size) -> torch.Tensor:
    """int32 seeds in [0, 2**31 - 1) from the key ``rng``, as the JAX
    backends draw them."""
    return prng.randint(rng, size, 0, _INT32_MAX)


def _result(x0: torch.Tensor, x_T: torch.Tensor, traj: Optional[list]):
    """x0, or (x0, the (S + 1, ...) stack x_T, step 1, ..., x0)."""
    if traj is None:
        return x0
    return x0, torch.stack([x_T] + traj)


# ----------------------------------------------------------------- eager
def run_eager(plan, eps_fn, x_T: torch.Tensor, rng: Optional[torch.Tensor],
              return_trajectory: bool = False):
    tab = _table(plan, x_T.device)
    keys = prng.split(rng, plan.S) if plan.stochastic else None
    ts = plan.steps()["t"]
    clip, order = plan.x0.clip, plan.order
    x, hist = x_T, _hist0(order, x_T.shape, x_T.device)
    traj = [] if return_trajectory else None
    for k in range(plan.S):
        e32 = eps_fn(x, _timesteps(ts[k], x.shape[0], x.device)).float()
        e32, hist = mix_history(e32, hist, tab["solver_w"][k], order)
        out = kernel_update(x.float(), e32, tab["c_x0"][k], tab["c_dir"][k],
                            tab["sqrt_a_t"][k], tab["sqrt_1m_a_t"][k], clip)
        if plan.stochastic:
            out = out + tab["c_noise"][k] * prng.normal(
                keys[k], x.shape).to(x.device)
        x = out.to(x_T.dtype)
        if traj is not None:
            traj.append(x)
    return _result(x, x_T, traj)


# --------------------------------------------------------- tile_resident
def run_tile_resident(plan, eps_fn, x_T: torch.Tensor,
                      rng: Optional[torch.Tensor],
                      return_trajectory: bool = False):
    seeds = _draw_seeds(rng, (plan.S,)) if plan.stochastic else None
    traj = [] if return_trajectory else None
    x2, n = tile_ops.to_tile_layout(x_T)              # conversion #1 (entry)
    x2 = _loop_tiles(plan, eps_fn, x2, seeds, n, x_T.shape, traj)
    x0 = tile_ops.from_tile_layout(x2, n, x_T.shape)  # conversion #2
    return _result(x0, x_T, traj)


def _loop_tiles(plan, eps_fn, x2: torch.Tensor, seeds, n: int, shape,
                trajectory: Optional[list] = None):
    """The S-step loop in the tile layout; ``seeds`` is (S,) int32 or None.
    Each step's state, in the natural shape, is appended to ``trajectory``
    when one is given."""
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
        if trajectory is not None:
            trajectory.append(tile_ops.from_tile_layout(x2, n, shape))
    return x2


# ------------------------------------------------------------------ rows
def run_rows(plan, eps_fn, x_T: torch.Tensor, rng: Optional[torch.Tensor],
             return_trajectory: bool = False):
    B = x_T.shape[0]
    seeds = _draw_seeds(rng, (plan.S, B)) if plan.stochastic else None
    traj = [] if return_trajectory else None
    x2, n = tile_ops.to_slot_tile_layout(x_T)
    x2 = _loop_rows(plan, eps_fn, x2, seeds, n, x_T.shape, traj)
    x0 = tile_ops.from_slot_tile_layout(x2, n, x_T.shape)
    return _result(x0, x_T, traj)


def _loop_rows(plan, eps_fn, x2: torch.Tensor, seeds, n: int, batch_shape,
               trajectory: Optional[list] = None):
    """The lockstep loop over the slot-tile layout; ``seeds`` is (S, B)
    int32 per-slot tick seeds or None.  The per-step row tables are built
    once, before the loop.  Each step's state, in the natural shape, is
    appended to ``trajectory`` when one is given."""
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
        if trajectory is not None:
            trajectory.append(tile_ops.from_slot_tile_layout(x2, n,
                                                             batch_shape))
    return x2


# ------------------------------------------------------------------ mega
def run_mega(plan, eps_fn, x_T: torch.Tensor, rng: Optional[torch.Tensor],
             k_fuse: Optional[int] = None, return_trajectory: bool = False):
    """The megakernel path: trunk + update fused, K plan steps per launch.

    Eligibility is the JAX package's rule: a deterministic order-1 plan
    without trajectory capture, over an eps model whose ``mega_spec`` fits
    ``MEGA_BUDGET``, runs fused; on the card the state must also meet the
    CUDA kernel's own limits (``megastep.eligible``).  Everything else runs
    the tile-resident loop (the same arithmetic, unfused).  Why is kept in
    ``run_mega.last_reason`` ("ok" when fused).  An S-step plan is exactly
    ceil(S / K) launches; the last chunk takes the S % K remainder as its
    own smaller K.
    """
    from repro_torch.kernels import megastep as mega_ops

    ok, why = mega_ops.eligible(getattr(eps_fn, "mega_spec", None), x_T)
    if ok and plan.stochastic:
        ok, why = False, "the plan is stochastic (mega plans take no noise)"
    if ok and plan.order > 1:
        ok, why = False, f"the plan has solver order {plan.order} > 1"
    if ok and return_trajectory:
        ok, why = False, ("the run returns its trajectory (the fused steps "
                          "keep no iterates)")
    run_mega.last_reason = why
    if not ok:
        return run_tile_resident(plan, eps_fn, x_T, rng, return_trajectory)
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


# ---------------------------------------------------------------- encode
def encode_eager(plan, eps_fn, x_0: torch.Tensor) -> torch.Tensor:
    """Forward ODE integration x_0 -> x_T on the plan's own trajectory.

    Euler (order 1) or Adams–Bashforth (the plan's order) steps in the
    x_bar/sigma coordinates of Eq. 14, in the canonical a*x + b*eps form:

      x_next = sqrt(a_to)/sqrt(a_from) * x + sqrt(a_to) * dsigma * eps_eff

    The a / b / solver_w tables are float64 numpy math cast once to float32
    (the JAX package's ``encode_jnp``); the first step evaluates the model
    at t = 1, the start of its grid.
    """
    ab = np.asarray(plan.schedule.alpha_bar.detach().cpu().numpy(),
                    np.float64)
    t_traj = np.asarray(plan.steps()["t"][::-1], np.int64)  # increasing
    t_from = np.concatenate([[0], t_traj[:-1]])
    a_f, a_to = ab[t_from], ab[t_traj]
    sig = lambda a: np.sqrt((1.0 - a) / a)  # noqa: E731
    dev = x_0.device
    f32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev)
    a_coef = f32(np.sqrt(a_to / a_f))
    b_coef = f32(np.sqrt(a_to) * (sig(a_to) - sig(a_f)))
    order = plan.order
    solver_w = f32(warmup_weights(len(t_traj), order))
    t_eval = np.maximum(t_from, 1).astype(np.int32)
    batch = x_0.shape[0]
    x, hist = x_0, _hist0(order, x_0.shape, dev)
    for k in range(len(t_traj)):
        e32 = eps_fn(x, _timesteps(t_eval[k], batch, dev)).float()
        e32, hist = mix_history(e32, hist, solver_w[k], order)
        x = (a_coef[k] * x.float() + b_coef[k] * e32).to(x_0.dtype)
    return x
