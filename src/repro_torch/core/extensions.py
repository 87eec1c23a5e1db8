"""Beyond-paper sampler extensions (port of ``repro/core/extensions.py``),
built on the same schedule / marginal machinery:

* v-prediction (Salimans & Ho 2022): the network predicts
  v = sqrt(a) eps - sqrt(1-a) x0.  Exact adapters turn a v-model into an
  eps_fn, so it plugs into the paper's Eq. 12 sampler unchanged.
* classifier-free guidance (Ho & Salimans 2021): eps_cfg = eps_u +
  w (eps_c - eps_u), again an eps_fn, so every sampler and backend
  (B1's tile-resident loop included) serves guidance as it is.

Each keeps the JAX function's op order: float32 in, float32 out.
"""
from __future__ import annotations

from typing import Callable

import torch

from .diffusion import EpsFn, _alpha_bar, _bcast
from .schedules import NoiseSchedule


def v_from_eps_x0(schedule: NoiseSchedule, t: torch.Tensor,
                  eps: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    a = _alpha_bar(schedule, t)
    return (_bcast(torch.sqrt(a), eps) * eps
            - _bcast(torch.sqrt(1.0 - a), eps) * x0)


def eps_from_v(schedule: NoiseSchedule, x_t: torch.Tensor, t: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """Invert v-parameterization: eps = sqrt(a) v + sqrt(1-a) x_t."""
    a = _alpha_bar(schedule, t)
    return (_bcast(torch.sqrt(a), v) * v
            + _bcast(torch.sqrt(1.0 - a), v) * x_t)


def x0_from_v(schedule: NoiseSchedule, x_t: torch.Tensor, t: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    a = _alpha_bar(schedule, t)
    return (_bcast(torch.sqrt(a), v) * x_t
            - _bcast(torch.sqrt(1.0 - a), v) * v)


def eps_fn_from_v_fn(schedule: NoiseSchedule, v_fn: Callable) -> EpsFn:
    """Wrap a v-predictor as an eps_fn for the Eq. 12 sampler family."""
    def eps_fn(x_t, t):
        return eps_from_v(schedule, x_t, t, v_fn(x_t, t))
    return eps_fn


def v_training_target(schedule: NoiseSchedule, x0: torch.Tensor,
                      t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The regression target for v-models (same q_sample inputs as L_1)."""
    return v_from_eps_x0(schedule, t, noise, x0)


def cfg_eps_fn(eps_cond: EpsFn, eps_uncond: EpsFn, guidance: float) -> EpsFn:
    """Classifier-free guidance over any pair of eps models."""
    def eps_fn(x_t, t):
        eu = eps_uncond(x_t, t)
        ec = eps_cond(x_t, t)
        return eu + guidance * (ec - eu)
    return eps_fn
