"""The scalar-knob sampler surface (port of ``repro/core/sampler.py:68-88,
271-327``): ``SamplerConfig`` and the thin ``sample`` adapter over
``SamplerPlan``.  For trajectories the scalar knobs cannot express (learned
tau, per-step eta schedules, explicit sigmas, multistep orders) build the
plan directly."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.schedules import NoiseSchedule


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """How to produce samples from a trained eps-model (paper §5 knobs)."""

    S: int = 50                       # dim(tau): number of sampler steps
    eta: float = 0.0                  # 0 = DDIM, 1 = DDPM (Eq. 16)
    tau_kind: str = "linear"          # 'linear' | 'quadratic' (App. D.2)
    sigma_hat: bool = False           # over-dispersed DDPM variant (App. D.3)
    clip_x0: Optional[float] = None   # clip predicted x0 (common practice)

    def __post_init__(self):
        if self.sigma_hat and self.eta != 1.0:
            raise ValueError("sigma_hat is a DDPM (eta=1) variant")

    def to_plan(self, schedule: NoiseSchedule, order: int = 1):
        """The equivalent compiled SamplerPlan."""
        from repro_torch.sampling import SamplerPlan
        return SamplerPlan.from_config(schedule, self, order=order)


def sample(schedule: NoiseSchedule, eps_fn, x_T: torch.Tensor,
           cfg: SamplerConfig, generator: Optional[torch.Generator] = None,
           tile_resident: bool = False,
           backend: Optional[str] = None) -> torch.Tensor:
    """Run the generalized generative process from x_T to x_0.

    Builds the plan for ``cfg`` and runs backend 'eager' (the counterpart
    of JAX's 'jnp'), or 'tile_resident' when ``tile_resident``; an explicit
    ``backend`` ('eager' | 'tile_resident' | 'rows' | 'mega') overrides
    the flag.  ``generator`` is required iff eta > 0 or sigma_hat.
    """
    if (cfg.eta > 0.0 or cfg.sigma_hat) and generator is None:
        raise ValueError("stochastic sampler (eta>0 or sigma_hat) needs a "
                         "generator")
    if backend is None:
        backend = "tile_resident" if tile_resident else "eager"
    return cfg.to_plan(schedule).run(eps_fn, x_T, generator, backend=backend)
