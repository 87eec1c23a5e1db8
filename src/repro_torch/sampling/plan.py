"""`SamplerPlan` — the declarative trajectory front door.

Port of ``repro/sampling/plan.py``.  One plan = (noise schedule, TauSpec,
SigmaSpec, X0Policy, solver order), compiled ONCE into the per-step
coefficient table every backend consumes:

  row k (sampling order, k=0 starts at t=tau_S):
    t            timestep fed to the eps model
    c_x0         sqrt(alpha_bar[prev])                "predicted x0" weight
    c_dir        sqrt(1 - alpha_bar[prev] - sigma^2)  "direction to x_t"
    c_noise      noise scale (sigma, or the sigma-hat variant)
    sqrt_a_t     sqrt(alpha_bar[t])
    sqrt_1m_a_t  sqrt(1 - alpha_bar[t])
    solver_w     (order,) Adams–Bashforth weights over the eps history

The table is float64 numpy math cast once to float32, exactly as in the
JAX package, so the two packages compile bitwise-equal tables and equal
schedule digests.

  plan.encode(eps_fn, x_0)   the ODE direction x_0 -> x_T on the plan's
      own tau and solver order (paper §4.3); a deterministic ``run``
      decodes it (paper Table 2)
  plan.run(eps_fn, x_T, rng, backend=...)   backend in
      'eager'          plain PyTorch loop over the natural shape (the
                       counterpart of the JAX 'jnp' reference)
      'tile_resident'  the (R, 256) tile layout carried through the loop,
                       one sampler_step_2d kernel launch per step
      'rows'           the per-row kernel sampler_step_rows_2d driven in
                       lockstep over the slot-tile layout
      'mega'           the megakernel megastep_call (eps trunk + update,
                       k_fuse steps per launch) for an eps model carrying
                       a fitting ``mega_spec`` and a deterministic order-1
                       plan; the 'tile_resident' loop otherwise
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.schedules import NoiseSchedule
from repro_torch.core.solver import MAX_ORDER, warmup_weights

from .specs import SigmaSpec, TauSpec, X0Policy

_BACKENDS = ("eager", "tile_resident", "rows", "mega")


def _schedule_digest(schedule: NoiseSchedule) -> bytes:
    """SHA-1 over the float32 alpha_bar bytes + str(T) (as the JAX one)."""
    ab = schedule.alpha_bar.detach().cpu().numpy()
    return hashlib.sha1(np.ascontiguousarray(ab).tobytes()
                        + str(schedule.T).encode()).digest()


@dataclasses.dataclass(frozen=True, eq=False)
class SamplerPlan:
    """A compiled generalized-generative-process trajectory (Eq. 12/16)."""

    schedule: NoiseSchedule
    tau: TauSpec
    sigma: SigmaSpec = SigmaSpec.ddim()
    x0: X0Policy = X0Policy.none()
    order: int = 1

    def __post_init__(self):
        if not 1 <= self.order <= MAX_ORDER:
            raise ValueError(f"order must be in 1..{MAX_ORDER}, got "
                             f"{self.order}")
        table = self._compile()
        if self.order > 1 and bool(np.any(table["c_noise"] > 0.0)):
            raise ValueError(
                "multistep (order > 1) plans must be deterministic — the "
                "Adams–Bashforth path integrates the ODE view (Eq. 14), "
                "which has no noise term; use order=1 for stochastic plans")
        object.__setattr__(self, "_table", table)
        object.__setattr__(self, "_key", (
            _schedule_digest(self.schedule), self.tau, self.sigma, self.x0,
            self.order))

    # ----------------------------------------------------------- identity
    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, SamplerPlan) and self._key == other._key

    def __repr__(self):
        return (f"SamplerPlan(S={self.S}, tau={self.tau.kind}, "
                f"sigma={self.sigma.kind}"
                + (f"(eta={self.sigma.eta:g})" if self.sigma.kind == "eta"
                   else "")
                + (f", clip={self.x0.clip:g}" if self.x0.clip is not None
                   else "")
                + (f", order={self.order}" if self.order > 1 else "")
                + f", T={self.schedule.T})")

    # ------------------------------------------------------------ builders
    @classmethod
    def build(cls, schedule: NoiseSchedule,
              tau: Union[TauSpec, int],
              sigma: Union[SigmaSpec, float] = 0.0,
              x0: Union[X0Policy, float, None] = None,
              order: int = 1) -> "SamplerPlan":
        """``tau=50`` means 50 uniform steps; ``sigma=0.7`` scalar eta=0.7;
        ``x0=1.0`` clips |x0| to 1."""
        if not isinstance(tau, TauSpec):
            tau = TauSpec.uniform(int(tau))
        if not isinstance(sigma, SigmaSpec):
            sigma = SigmaSpec.from_eta(float(sigma))
        if not isinstance(x0, X0Policy):
            x0 = X0Policy(clip=None if x0 is None else float(x0))
        return cls(schedule=schedule, tau=tau, sigma=sigma, x0=x0,
                   order=order)

    @classmethod
    def from_config(cls, schedule: NoiseSchedule, cfg,
                    order: int = 1) -> "SamplerPlan":
        """Adapter from the scalar ``core.sampler.SamplerConfig`` knobs."""
        tau_kind = "uniform" if cfg.tau_kind == "linear" else cfg.tau_kind
        return cls(schedule=schedule,
                   tau=TauSpec(kind=tau_kind, S=cfg.S),
                   sigma=SigmaSpec.from_eta(cfg.eta, sigma_hat=cfg.sigma_hat),
                   x0=X0Policy(clip=cfg.clip_x0),
                   order=order)

    # ------------------------------------------------------------- compile
    def _compile(self) -> Dict[str, np.ndarray]:
        """The per-step table, SAMPLING order: float64 math, one f32 cast."""
        ab = np.asarray(self.schedule.alpha_bar.detach().cpu().numpy(),
                        np.float64)
        tau = self.tau.resolve(self.schedule.T)            # increasing
        t_prev = np.concatenate([[0], tau[:-1]])
        a_t, a_s = ab[tau], ab[t_prev]
        sigma, noise_scale = self.sigma.resolve(ab, tau)
        c_dir = np.sqrt(np.clip(1.0 - a_s - sigma ** 2, 0.0, None))
        rev = slice(None, None, -1)
        f32 = lambda a: np.ascontiguousarray(a[rev], np.float32)
        table = {
            "t": np.ascontiguousarray(tau[rev]).astype(np.int32),
            "c_x0": f32(np.sqrt(a_s)),
            "c_dir": f32(c_dir),
            "c_noise": f32(noise_scale),
            "sqrt_a_t": f32(np.sqrt(a_t)),
            "sqrt_1m_a_t": f32(np.sqrt(1.0 - a_t)),
            "solver_w": np.ascontiguousarray(
                warmup_weights(len(tau), self.order), np.float32),
        }
        for v in table.values():   # shared by every steps() consumer
            v.setflags(write=False)
        return table

    # ---------------------------------------------------------- properties
    @property
    def S(self) -> int:
        """Trajectory length == network evaluations per sample."""
        return int(self._table["t"].shape[0])

    @property
    def stochastic(self) -> bool:
        """True iff any step injects noise (needs a key)."""
        return bool(np.any(self._table["c_noise"] > 0.0))

    # -------------------------------------------------------------- views
    def steps(self) -> Dict[str, np.ndarray]:
        """Per-step read-only numpy rows in SAMPLING order (k=0 first)."""
        return dict(self._table)

    def schedule_digest(self) -> bytes:
        """Digest identifying the bound noise schedule."""
        return self._key[0]

    def coefficients(self) -> Dict[str, torch.Tensor]:
        """The table in TRAJECTORY order (increasing t), without
        ``solver_w``: the legacy view ``core.trajectory_coefficients``
        returns (CPU tensors)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v[::-1]))
                for k, v in self._table.items() if k != "solver_w"}

    # ---------------------------------------------------------- execution
    def run(self, eps_fn, x_T: torch.Tensor,
            rng: Optional[torch.Tensor] = None, *,
            backend: str = "eager", return_trajectory: bool = False,
            k_fuse: Optional[int] = None):
        """Execute the plan from x_T to x_0 on the device x_T lies on.

        Args:
          eps_fn: eps_theta(x_t, t) with x_t (batch, *shape) and t an int32
            (batch,) tensor on x_T's device.
          x_T: (batch, *shape) initial latent, float32 or bfloat16: N(0, I)
            for generation, or an encoding from :meth:`encode` for
            reconstruction.
          rng: a threefry key (``prng.PRNGKey``) on x_T's device; required
            iff the plan is stochastic.  The per-step kernel seeds and the
            eager noise are drawn from it as the JAX backends draw them, so
            one key gives JAX's draws.
          backend: 'eager' | 'tile_resident' | 'rows' | 'mega'.  On
            'tile_resident' (and 'mega') a model may declare
            ``eps_fn.tile_aware = True`` to receive the (R, 256) tile view;
            on 'mega' it must carry ``eps_fn.mega_spec`` (set by
            ``diffusion_lm.make_tile_eps_fn``) to run fused.
          return_trajectory: also return the (S + 1, batch, *shape) stack
            of iterates, x_T first and x_0 last: ``(x_0, traj)``.  On
            'mega' it runs the tile-resident loop (the fused steps keep no
            iterates), as in JAX.
          k_fuse: 'mega' only — plan steps per megakernel launch (default
            ``kernels.megastep.DEFAULT_K_FUSE``); S steps are
            ceil(S / k_fuse) launches.
        """
        from . import backends
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from "
                             f"{_BACKENDS}")
        if self.stochastic and rng is None:
            raise ValueError("stochastic plan needs rng (sigma > 0 "
                             "somewhere in the schedule)")
        if k_fuse is not None and backend != "mega":
            raise ValueError("k_fuse is a 'mega' backend knob")
        with torch.no_grad():
            if backend == "mega":
                return backends.run_mega(self, eps_fn, x_T, rng, k_fuse,
                                         return_trajectory)
            fn = {"eager": backends.run_eager,
                  "tile_resident": backends.run_tile_resident,
                  "rows": backends.run_rows}[backend]
            return fn(self, eps_fn, x_T, rng, return_trajectory)

    def encode(self, eps_fn, x_0: torch.Tensor) -> torch.Tensor:
        """Integrate the ODE view FORWARD: x_0 -> x_T (paper §4.3, Eq. 13),
        on the device x_0 lies on.

        Uses the plan's own tau (so a quadratic or learned trajectory
        encodes on the same grid it decodes on) and its solver order (AB-k
        forward steps in sigma, Euler warm-up).  The sigma spec plays no
        role — encoding is the deterministic ODE direction; a subsequent
        deterministic ``run`` reconstructs x_0 (paper Table 2).  A plain
        PyTorch loop, as JAX's encode runs its 'jnp' reference.
        """
        from . import backends
        with torch.no_grad():
            return backends.encode_eager(self, eps_fn, x_0)
