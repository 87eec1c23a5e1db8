"""Non-Markovian multinomial forward process for discrete data (paper
App. A); port of ``repro/core/discrete.py``.

For one-hot x0 with K classes:
  q(x_t | x0)            = Cat(a_t x0 + (1 - a_t) 1/K)                 (Eq. 17)
  q(x_{t-1} | x_t, x0)   = Cat(s_t x_t + (a_{t-1} - s_t a_t) x0
                               + ((1-a_{t-1}) - (1-a_t) s_t) 1/K)      (Eq. 19)
  p_theta(x_{t-1} | x_t) = same with x0 -> f_theta(x_t)                (Eq. 20)

s_t (the paper's sigma_t) controls stochasticity: the s_t that zeroes the
uniform-mass term gives the "implicit" (DDIM-like) limit, where the chain
either keeps x_t or jumps to the predicted x0.

Draws are JAX's: ``jax.random.categorical(key, log(p + 1e-20), axis=-1)``
with ONE key over the whole (batch, ..., K) array, i.e. the argmax of
``gumbel(key, p.shape) + log(p + 1e-20)`` (``prng.categorical`` with a
single key).  ``prng.gumbel`` is within 4 float32 ulps of JAX's, so a
token can differ from JAX's only where the two largest perturbed logits
tie within that bound.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng

from .schedules import NoiseSchedule, make_tau

# f_theta(x_t, t) -> (batch, ..., K) probabilities of x0
X0Fn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _ab(schedule: NoiseSchedule, t, device) -> torch.Tensor:
    """alpha_bar[t] (float32) on ``device``; t an int or an int tensor."""
    t = torch.as_tensor(t, device=device).long()
    return schedule.alpha_bar.to(device)[t]


def _b(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return coef.reshape(coef.shape + (1,) * (x.dim() - coef.dim()))


def q_probs(schedule: NoiseSchedule, x0: torch.Tensor,
            t: torch.Tensor) -> torch.Tensor:
    """Marginal Cat probabilities of x_t given one-hot x0 (Eq. 17)."""
    K = x0.shape[-1]
    a = _ab(schedule, t, x0.device)
    return _b(a, x0) * x0 + _b(1.0 - a, x0) / K


def _draw_one_hot(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One-hot draws from Cat(p) over the last axis, one key for all."""
    idx = prng.categorical(key.to(p.device), torch.log(p + 1e-20))
    return F.one_hot(idx, p.shape[-1]).to(p.dtype)


def q_sample(schedule: NoiseSchedule, x0: torch.Tensor, t: torch.Tensor,
             rng: torch.Tensor) -> torch.Tensor:
    """Draw one-hot x_t ~ q(x_t | x0)."""
    return _draw_one_hot(rng, q_probs(schedule, x0, t))


def sigma_implicit(schedule: NoiseSchedule, t, s) -> torch.Tensor:
    """The s_t that zeroes the uniform-mass term: (1-a_s)/(1-a_t).

    The discrete analogue of eta=0: maximally deterministic while keeping
    all mixture weights in Eq. 18 non-negative.
    """
    dev = t.device if isinstance(t, torch.Tensor) else None
    return (1.0 - _ab(schedule, s, dev)) / (1.0 - _ab(schedule, t, dev))


def posterior_probs(schedule: NoiseSchedule, x_t: torch.Tensor,
                    x0: torch.Tensor, t, s, sigma) -> torch.Tensor:
    """q(x_s | x_t, x0) mixture probabilities (Eq. 19), generalized t->s."""
    K = x_t.shape[-1]
    a_t = _ab(schedule, t, x_t.device)
    a_s = _ab(schedule, s, x_t.device)
    w_t = torch.as_tensor(sigma, dtype=torch.float32, device=x_t.device)
    w_0 = a_s - w_t * a_t
    w_u = (1.0 - a_s) - (1.0 - a_t) * w_t
    return (_b(w_t, x_t) * x_t + _b(w_0, x_t) * x0 + _b(w_u, x_t) / K)


def reverse_sample(schedule: NoiseSchedule, x0_fn: X0Fn, x_T: torch.Tensor,
                   rng: torch.Tensor, S: int, eta: float = 0.0,
                   tau_kind: str = "linear") -> torch.Tensor:
    """Sample the reverse multinomial chain on a sub-sequence tau.

    eta interpolates sigma between 0 (fully stochastic jump to uniform
    terms) and the implicit value (deterministic keep-or-jump):
    sigma = eta * sigma*.  Each step takes ``key, k1 = split(key)`` and
    draws with k1, as the JAX scan does.
    """
    tau = make_tau(schedule.T, S, tau_kind)
    t_cur = tau[::-1]
    t_prev = np.concatenate([[0], tau[:-1]])[::-1]
    batch = x_T.shape[0]
    dev = x_T.device
    x, key = x_T, rng.to(dev)
    for tc, tp in zip(t_cur.tolist(), t_prev.tolist()):
        key, k1 = prng.split(key)
        probs_x0 = x0_fn(x, torch.full((batch,), tc, dtype=torch.int32,
                                       device=dev))
        tc_t = torch.tensor(tc, device=dev)
        sig = eta * sigma_implicit(schedule, tc_t, torch.tensor(tp,
                                                                device=dev))
        p = posterior_probs(schedule, x, probs_x0, tc_t, tp, sig)
        x = _draw_one_hot(k1, p).to(x_T.dtype)
    return x


def kl_loss(schedule: NoiseSchedule, x0_fn: X0Fn, x0: torch.Tensor,
            t: torch.Tensor, rng: torch.Tensor,
            eta: float = 0.9) -> torch.Tensor:
    """Variational KL between the true and model posteriors (Eq. 21).

    Bounded above by a weighted classification loss (App. A, last
    equation); this is the exact categorical KL, which is tractable.
    """
    x_t = q_sample(schedule, x0, t, rng)
    s = torch.clamp(t - 1, min=0)
    sig = eta * sigma_implicit(schedule, t, s)
    q_p = posterior_probs(schedule, x_t, x0, t, s, sig)
    p_p = posterior_probs(schedule, x_t, x0_fn(x_t, t), t, s, sig)
    kl = torch.sum(q_p * (torch.log(q_p + 1e-20) - torch.log(p_p + 1e-20)),
                   dim=-1)
    return torch.mean(kl)
