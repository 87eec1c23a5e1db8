"""ODE view of DDIM (paper §4.3) — encoding, decoding, probability-flow
Euler and the deprecated multistep entry; port of ``repro/core/ode.py``.

With x_bar = x/sqrt(a) and sigma = sqrt((1-a)/a), DDIM is Euler on
``d x_bar = eps_theta(x) d sigma`` (Eq. 14).  Integrating forward in t
encodes x0 -> x_T (a latent the deterministic sampler reconstructs from —
Table 2).  ``SamplerPlan.encode`` is the forward direction on any plan
trajectory, and a ``SamplerPlan(order=k)`` run is the multistep sampler;
this module keeps the stable functional entries over them.  Everything
runs on the device its inputs lie on: ``decode`` takes the tile-resident
loop, so on the card each of its steps is one ``sampler_step_2d`` launch.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .diffusion import EpsFn
from .schedules import NoiseSchedule, make_tau


def _plan(schedule: NoiseSchedule, S: int, tau_kind: str, order: int = 1):
    from repro_torch.sampling import SamplerPlan, TauSpec
    kind = "uniform" if tau_kind == "linear" else tau_kind
    return SamplerPlan.build(schedule, tau=TauSpec(kind=kind, S=S),
                             order=order)


def encode(schedule: NoiseSchedule, eps_fn: EpsFn, x0: torch.Tensor,
           S: int = 100, tau_kind: str = "linear") -> torch.Tensor:
    """Run Eq. 13 forward in t: x0 -> x_T (deterministic latent).

    The reverse of DDIM sampling with the same trajectory tau; Euler steps
    in sigma with eps evaluated at the left (lower-noise) endpoint.
    Functional entry over ``SamplerPlan.encode`` — build a plan directly
    for quadratic/learned tau or multistep encoding.
    """
    return _plan(schedule, S, tau_kind).encode(eps_fn, x0)


def decode(schedule: NoiseSchedule, eps_fn: EpsFn, x_T: torch.Tensor,
           S: int = 100, tau_kind: str = "linear") -> torch.Tensor:
    """Deterministic reconstruction — the eta=0 plan run on the
    'tile_resident' backend (the same arithmetic as 'eager'; on the card
    one B1 launch per step)."""
    return _plan(schedule, S, tau_kind).run(eps_fn, x_T,
                                            backend="tile_resident")


def probability_flow_sample(schedule: NoiseSchedule, eps_fn: EpsFn,
                            x_T: torch.Tensor, S: int = 50,
                            tau_kind: str = "linear") -> torch.Tensor:
    """Euler discretization of the probability-flow ODE (paper Eq. 15).

    Equivalent to DDIM in the continuum limit (Proposition 1), but takes
    Euler steps w.r.t. dt (via the 1/2 d(sigma^2) form) rather than d sigma —
    the paper notes this degrades at small S.  (Not a plan backend: it
    discretizes a different form on purpose.)  A plain PyTorch loop in
    float32 on x_T's device.
    """
    tau = make_tau(schedule.T, S, tau_kind)
    t_cur = tau[::-1]
    t_prev = np.concatenate([[0], tau[:-1]])[::-1]
    ab = schedule.alpha_bar.to(x_T.device)
    batch = x_T.shape[0]
    x = x_T
    with torch.no_grad():
        for tc, tp in zip(t_cur.tolist(), t_prev.tolist()):
            a_t, a_s = ab[tc], ab[tp]
            eps = eps_fn(x, torch.full((batch,), tc, dtype=torch.int32,
                                       device=x.device))
            xbar = x / torch.sqrt(a_t)
            delta = 0.5 * ((1.0 - a_s) / a_s - (1.0 - a_t) / a_t)
            xbar = xbar + delta * torch.sqrt(a_t / (1.0 - a_t)) * eps
            x = xbar * torch.sqrt(a_s)
    return x


def multistep_sample(schedule: NoiseSchedule, eps_fn: EpsFn,
                     x_T: torch.Tensor, S: int = 25, order: int = 2,
                     tau_kind: str = "linear") -> torch.Tensor:
    """DEPRECATED: use ``SamplerPlan.build(schedule, tau=S, order=order)``.

    Adams–Bashforth multistep DDIM (paper Discussion §7): in x_bar/sigma
    coordinates the RHS is just eps, so AB-k reuses the last k eps
    evaluations — same model-eval count as DDIM but O(h^k) local error.
    A thin shim over a solver-order-k plan ('eager', as JAX's runs 'jnp').
    """
    warnings.warn(
        "multistep_sample is deprecated: use repro_torch.sampling."
        "SamplerPlan.build(schedule, tau=S, order=order).run(eps_fn, x_T)",
        DeprecationWarning, stacklevel=2)
    return _plan(schedule, S, tau_kind, order=order).run(eps_fn, x_T)
