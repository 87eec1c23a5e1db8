"""Forward process, x0-prediction and training losses (paper §2–§3); port
of ``repro/core/diffusion.py``.

Everything here is a function of (schedule, tensors); the ε-network is
passed in as ``eps_fn(x_t, t) -> eps`` where ``t`` is an int32 tensor of
timesteps (one per batch element, values in [1, T]).  The math runs in
the inputs' dtype on their device; ``alpha_bar`` is the schedule's float32
table, moved there.  Where JAX splits a PRNG key, the port splits the
same threefry key (``repro_torch.prng``), so one key gives JAX's draws.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch import prng

from .schedules import NoiseSchedule

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _alpha_bar(schedule: NoiseSchedule, t: torch.Tensor) -> torch.Tensor:
    """alpha_bar[t] on t's device (float32)."""
    return schedule.alpha_bar.to(t.device)[t.long()]


def _bcast(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast per-batch scalar coefficients over trailing dims of x."""
    return coef.reshape(coef.shape + (1,) * (x.dim() - coef.dim()))


def q_sample(schedule: NoiseSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Sample x_t ~ q(x_t | x0) = N(sqrt(a_t) x0, (1-a_t) I)  (paper Eq. 4)."""
    a = _alpha_bar(schedule, t)
    return (_bcast(torch.sqrt(a), x0) * x0
            + _bcast(torch.sqrt(1.0 - a), x0) * noise)


def predict_x0(schedule: NoiseSchedule, x_t: torch.Tensor, t: torch.Tensor,
               eps: torch.Tensor, clip: Optional[float] = None
               ) -> torch.Tensor:
    """Denoised observation f_theta (paper Eq. 9)."""
    a = _alpha_bar(schedule, t)
    x0 = ((x_t - _bcast(torch.sqrt(1.0 - a), x_t) * eps)
          / _bcast(torch.sqrt(a), x_t))
    if clip is not None:
        x0 = torch.clamp(x0, -clip, clip)
    return x0


def eps_from_x0(schedule: NoiseSchedule, x_t: torch.Tensor, t: torch.Tensor,
                x0: torch.Tensor) -> torch.Tensor:
    """Invert Eq. 9: the ε consistent with (x_t, x0)."""
    a = _alpha_bar(schedule, t)
    return ((x_t - _bcast(torch.sqrt(a), x_t) * x0)
            / _bcast(torch.sqrt(1.0 - a), x_t))


def posterior_sigma(schedule: NoiseSchedule, t: torch.Tensor,
                    s: torch.Tensor,
                    eta: Union[float, torch.Tensor] = 0.0) -> torch.Tensor:
    """sigma_t(eta) of paper Eq. 16, generalized to a (t -> s) jump.

    eta=1 recovers the DDPM posterior std; eta=0 is DDIM (deterministic).
    """
    a_t = _alpha_bar(schedule, t)
    a_s = _alpha_bar(schedule, s)
    return eta * torch.sqrt((1.0 - a_s) / (1.0 - a_t)) * torch.sqrt(
        1.0 - a_t / a_s)


def sigma_hat(schedule: NoiseSchedule, t: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """The over-dispersed DDPM variance sqrt(1 - a_t/a_s) (paper §5, App D.3).
    """
    return torch.sqrt(1.0 - _alpha_bar(schedule, t)
                      / _alpha_bar(schedule, s))


def gamma_weights(schedule: NoiseSchedule, sigma: torch.Tensor,
                  d: int) -> torch.Tensor:
    """Theorem-1 weights gamma_t = 1 / (2 d sigma_t^2 alpha_t), shape (T,).

    These make J_sigma == L_gamma + C; with parameter sharing across t the
    optimum coincides with L_1, which is why the paper trains only L_1.
    ``sigma`` must be positive (Theorem 1 requires sigma > 0).
    """
    a = schedule.alpha_bar.to(sigma.device)[1:]
    return 1.0 / (2.0 * d * (sigma ** 2) * a)


def simple_loss(schedule: NoiseSchedule, eps_fn: EpsFn, x0: torch.Tensor,
                t: torch.Tensor, noise: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L_gamma (paper Eq. 5). weights=None gives gamma=1, i.e. L_simple/L_1.
    """
    x_t = q_sample(schedule, x0, t, noise)
    eps_hat = eps_fn(x_t, t)
    per_ex = torch.mean(torch.square(eps_hat - noise),
                        dim=tuple(range(1, x0.dim())))
    if weights is not None:
        per_ex = per_ex * weights[t.long() - 1]
    return torch.mean(per_ex)


def training_loss(schedule: NoiseSchedule, eps_fn: EpsFn, x0: torch.Tensor,
                  rng: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw (t, ε) and evaluate the denoising loss — one training step's
    loss.  ``k_t, k_e = split(rng)``, t int32 uniform on [1, T], ε normal
    of x0's shape, as the JAX function draws them."""
    k_t, k_e = prng.split(rng)
    t = prng.randint(k_t, (x0.shape[0],), 1, schedule.T + 1)
    noise = prng.normal(k_e, x0.shape, dtype=x0.dtype)
    return simple_loss(schedule, eps_fn, x0, t.to(x0.device),
                       noise.to(x0.device), weights)
