"""The scalar-knob sampler surface and the scheduler's single-step API
(port of ``repro/core/sampler.py``).

  * ``SamplerConfig`` and the thin ``sample`` adapter over ``SamplerPlan``.
    For trajectories the scalar knobs cannot express (learned tau,
    per-step eta schedules, explicit sigmas, multistep orders) build the
    plan directly.
  * ``trajectory_coefficients`` / ``step_table``: views of the compiled
    plan's table (one coefficient program for the whole package).
  * DEPRECATED shims ``ddim_sample`` / ``ddpm_sample`` over plans, and
    the legacy injectable ``step_impl=`` loop of ``sample`` (the StepImpl
    contract of ``kernels/ddim_step/ops.py::fused_ddim_step``); each
    emits a DeprecationWarning.
  * ``StepStates`` / ``step_table`` / ``slot_tile_step`` / ``sample_step``:
    one step of a slot batch where every slot sits at its own position of
    its own trajectory, the body of the continuous-batching tick.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import solver
from repro_torch import prng
from repro_torch.core.diffusion import predict_x0
from repro_torch.core.schedules import NoiseSchedule

# fused Eq. 12 update signature of the legacy ``sample(step_impl=...)``
# path: (x, eps, noise | None, c_x0, c_dir, c_noise, sqrt_a_t,
# sqrt_1m_a_t) -> x_prev.  DEPRECATED: build a SamplerPlan instead.
StepImpl = Callable[..., torch.Tensor]


def _jnp_step(x, eps, noise, c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t):
    """Reference fused Eq. 12 update for the legacy StepImpl path (the
    name is JAX's).  ``noise`` is None on the deterministic path: the
    noise term is skipped rather than multiplied by zero."""
    x0 = (x - sqrt_1m_a_t * eps) / sqrt_a_t
    out = c_x0 * x0 + c_dir * eps
    if noise is not None:
        out = out + c_noise * noise
    return out


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


def trajectory_coefficients(schedule: NoiseSchedule, cfg: SamplerConfig):
    """Per-step scalar coefficients for the Eq. 12 update (legacy view).

    Returns a dict of (S,) CPU tensors in TRAJECTORY order (increasing
    t): t and the five coefficients consumed by the fused step, read from
    the compiled SamplerPlan.
    """
    return cfg.to_plan(schedule).coefficients()


def _legacy_step_impl_sample(schedule, eps_fn, x_T, cfg, rng, step_impl,
                             return_trajectory):
    """The injectable-StepImpl loop (deprecated migration baseline): one
    ``step_impl`` call per step on the natural shape, the step noise
    ``normal`` of ``split(rng, S)`` drawn outside it, as in JAX.  The
    coefficients go in as 0-dim CPU tensors in x's dtype (no device copy
    per step)."""
    stochastic = cfg.eta > 0.0 or cfg.sigma_hat
    coefs = trajectory_coefficients(schedule, cfg)
    batch, dt, dev = x_T.shape[0], x_T.dtype, x_T.device
    keys = prng.split(rng.to(dev), cfg.S) if stochastic else None
    ab = schedule.alpha_bar.to(dev)
    x, traj = x_T, []
    for k in range(cfg.S - 1, -1, -1):       # largest timestep first
        c = {n: v[k] for n, v in coefs.items()}
        tk = int(c["t"])
        t = torch.full((batch,), tk, dtype=torch.int32, device=dev)
        eps = eps_fn(x, t)
        if cfg.clip_x0 is not None:
            # clipping predicted x0 re-derives an equivalent eps
            x0 = predict_x0(schedule, x, t, eps, clip=cfg.clip_x0)
            eps = (x - torch.sqrt(ab[tk]) * x0) / torch.sqrt(1.0 - ab[tk])
        noise = (prng.normal(keys[cfg.S - 1 - k], x.shape).to(dt)
                 if stochastic else None)
        x = step_impl(x, eps, noise,
                      *(c[n].to(dt) for n in (
                          "c_x0", "c_dir", "c_noise", "sqrt_a_t",
                          "sqrt_1m_a_t")))
        traj.append(x)
    if return_trajectory:
        return x, torch.stack([x_T] + traj)
    return x


def sample(schedule: NoiseSchedule, eps_fn, x_T: torch.Tensor,
           cfg: SamplerConfig, rng: Optional[torch.Tensor] = None,
           tile_resident: bool = False,
           backend: Optional[str] = None,
           return_trajectory: bool = False,
           step_impl: StepImpl = _jnp_step):
    """Run the generalized generative process from x_T to x_0.

    Builds the plan for ``cfg`` and runs backend 'eager' (the counterpart
    of JAX's 'jnp'), or 'tile_resident' when ``tile_resident``; an explicit
    ``backend`` ('eager' | 'tile_resident' | 'rows' | 'mega') overrides
    the flag.  ``rng`` (a threefry key) is required iff eta > 0 or
    sigma_hat; the step noise is drawn from ``split(rng, S)`` as in JAX.
    With ``return_trajectory`` it returns ``(x_0, traj)``, traj the
    (S + 1, ...) stack of iterates.  ``step_impl`` is DEPRECATED: passing
    anything but the default runs the legacy per-step loop (for example
    ``kernels.ddim_step.fused_ddim_step``, B1 once per step) and warns;
    it is ignored when ``tile_resident``.
    """
    if (cfg.eta > 0.0 or cfg.sigma_hat) and rng is None:
        raise ValueError("stochastic sampler (eta>0 or sigma_hat) needs rng")
    if step_impl is not _jnp_step and not tile_resident:
        warnings.warn(
            "sample(step_impl=...) is deprecated: build a "
            "repro_torch.sampling.SamplerPlan and pick a backend "
            "(run(..., backend='tile_resident') is the fused hot path)",
            DeprecationWarning, stacklevel=2)
        return _legacy_step_impl_sample(schedule, eps_fn, x_T, cfg, rng,
                                        step_impl, return_trajectory)
    if backend is None:
        backend = "tile_resident" if tile_resident else "eager"
    return cfg.to_plan(schedule).run(eps_fn, x_T, rng, backend=backend,
                                     return_trajectory=return_trajectory)


def ddim_sample(schedule: NoiseSchedule, eps_fn, x_T: torch.Tensor,
                S: int = 50, tau_kind: str = "linear", **kw):
    """DEPRECATED: use ``SamplerPlan.build(schedule, tau=S).run(...)``.

    Deterministic DDIM (eta = 0) — the paper's headline sampler; ``kw`` go
    to ``sample``.
    """
    warnings.warn("ddim_sample is deprecated: use repro_torch.sampling."
                  "SamplerPlan.build(schedule, tau=S).run(eps_fn, x_T)",
                  DeprecationWarning, stacklevel=2)
    return sample(schedule, eps_fn, x_T,
                  SamplerConfig(S=S, eta=0.0, tau_kind=tau_kind), **kw)


def ddpm_sample(schedule: NoiseSchedule, eps_fn, x_T: torch.Tensor,
                rng: torch.Tensor, S: Optional[int] = None,
                tau_kind: str = "linear", sigma_hat: bool = False, **kw):
    """DEPRECATED: use ``SamplerPlan.build(schedule, tau=S, sigma=1.0)``.

    DDPM baseline (eta = 1), optionally the sigma-hat variant; S defaults
    to the schedule's T.  ``kw`` go to ``sample``.
    """
    warnings.warn(
        "ddpm_sample is deprecated: use repro_torch.sampling.SamplerPlan."
        "build(schedule, tau=S, sigma=SigmaSpec.ddpm(...)).run(eps_fn, x_T, "
        "rng)", DeprecationWarning, stacklevel=2)
    S = S if S is not None else schedule.T
    return sample(schedule, eps_fn, x_T,
                  SamplerConfig(S=S, eta=1.0, tau_kind=tau_kind,
                                sigma_hat=sigma_hat), rng, **kw)


class StepStates(NamedTuple):
    """Per-slot step state for one scheduler tick (all tensors length B).

    ``t[b]`` is slot b's timestep for the eps model and the five
    coefficient vectors are that position's Eq. 12 row.  ``seed`` is the
    per-slot per-tick int32 noise seed (stochastic engines only);
    ``solver_w`` the per-slot (B, max_order) Adams–Bashforth weight row
    (multistep-capable engines only).
    """

    t: torch.Tensor
    c_x0: torch.Tensor
    c_dir: torch.Tensor
    c_noise: torch.Tensor
    sqrt_a_t: torch.Tensor
    sqrt_1m_a_t: torch.Tensor
    seed: Optional[torch.Tensor] = None
    solver_w: Optional[torch.Tensor] = None

    def coef_matrix(self) -> torch.Tensor:
        """(B, 5) float32 rows in the kernels' column order."""
        return torch.stack([self.c_x0, self.c_dir, self.c_noise,
                            self.sqrt_a_t, self.sqrt_1m_a_t],
                           dim=1).float()


def step_table(schedule: NoiseSchedule, cfg: SamplerConfig):
    """Per-request step table in SAMPLING order (row k is the k-th tick:
    t, c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t, and (S, order)
    ``solver_w``) — the compiled plan's ``steps()``."""
    return cfg.to_plan(schedule).steps()


def slot_tile_eps(eps_fn, x2: torch.Tensor, t: torch.Tensor, shape):
    """The eps model on a (B * rows_per_slot, 256) slot-tile view, in that
    layout.  eps models declaring ``slot_tile_aware = True`` receive (x2,
    t (B,)); others see the natural (B, *shape) view through an adapter."""
    from repro_torch.kernels.sampler_step import ops as tile_ops

    if getattr(eps_fn, "slot_tile_aware", False):
        return eps_fn(x2, t)
    n = int(np.prod(shape))
    x_nat = tile_ops.from_slot_tile_layout(x2, n,
                                           (t.shape[0],) + tuple(shape))
    return tile_ops.to_slot_tile_layout(eps_fn(x_nat, t))[0]


def slot_row_inputs(states: StepStates, rps: int, stochastic: bool):
    """Per-row inputs of the update: (R, 8) coefficients, (R,) seeds (None
    when deterministic) and the (order, R, 1) Adams–Bashforth weight stack
    (None without ``solver_w``).  Row r of each belongs to slot r // rps,
    so a block of rows takes the same rows of each."""
    from repro_torch.kernels.sampler_step import ops as tile_ops

    row_coefs = tile_ops.expand_slot_coefs(states.coef_matrix(), rps)
    row_seeds = (tile_ops.derive_row_seeds(states.seed, rps)
                 if stochastic else None)
    row_w = (states.solver_w.float().repeat_interleave(rps, dim=0).T[
        :, :, None] if states.solver_w is not None else None)
    return row_coefs, row_seeds, row_w


def slot_rows_update(x2, eps2, row_coefs, row_seeds=None, *, hist2=None,
                     row_w=None, clip_x0=None, stochastic: bool = False,
                     want_x0: bool = False):
    """The update of a block of slot-tile rows: each row's Adams–Bashforth
    combination (with ``hist2``, the (max_order-1, R, 256) float32 stack
    of previous evaluations, newest first, and ``row_w``) through
    ``solver.mix_history``, then one ``sampler_step_rows_2d`` launch.
    Returns (step_out, new_hist2 or None)."""
    from repro_torch.kernels.sampler_step import ops as tile_ops

    new_hist2 = None
    if hist2 is not None:
        eps2, new_hist2 = solver.mix_history(eps2.float(), hist2, row_w,
                                             row_w.shape[0])
    out = tile_ops.sampler_step_rows(
        x2, eps2.contiguous(), row_coefs, row_seeds, clip=clip_x0,
        stochastic=stochastic, want_x0=want_x0)
    return out, new_hist2


def slot_tile_step(eps_fn, x2: torch.Tensor, states: StepStates, shape, *,
                   hist2: Optional[torch.Tensor] = None, clip_x0=None,
                   stochastic: bool = False, want_x0: bool = False,
                   want_eps: bool = False):
    """One scheduler tick over the (B * rows_per_slot, 256) slot-tile view.

    The eps model through ``slot_tile_eps``, then ``slot_rows_update``.
    Multistep engines pass ``hist2``, the (max_order-1, R, 256) float32
    stack of previous eps evaluations (newest first), and
    ``states.solver_w``: each slot's effective eps is its own
    Adams–Bashforth combination.  The update is one
    ``sampler_step_rows_2d`` launch.  Returns the advanced view (plus the
    x0 preview when ``want_x0``); with ``hist2`` ``(step_out,
    new_hist2)``.  ``want_eps`` also appends the RAW eps evaluation
    (before the Adams–Bashforth mix) in tile layout, for the engine's
    probed tick: ``(step_out, eps)`` or ``(step_out, new_hist2, eps)``.
    """
    rps = x2.shape[0] // states.t.shape[0]
    with torch.no_grad():
        eps_raw2 = slot_tile_eps(eps_fn, x2, states.t, shape)
        row_coefs, row_seeds, row_w = slot_row_inputs(states, rps,
                                                      stochastic)
        out, new_hist2 = slot_rows_update(
            x2, eps_raw2, row_coefs, row_seeds, hist2=hist2, row_w=row_w,
            clip_x0=clip_x0, stochastic=stochastic, want_x0=want_x0)
    ret = (out, new_hist2) if hist2 is not None else (out,)
    if want_eps:
        ret += (eps_raw2,)
    return ret if len(ret) > 1 else out


def sample_step(schedule: NoiseSchedule, eps_fn, x: torch.Tensor,
                states: StepStates, *, clip_x0=None,
                stochastic: bool = False, want_x0: bool = False):
    """Advance a natural-shape slot batch ONE step, each row at its own
    trajectory position (order 1; one layout conversion in, one out).
    ``schedule`` is unused, kept for symmetry with ``sample``."""
    del schedule
    from repro_torch.kernels.sampler_step import ops as tile_ops

    x2, n = tile_ops.to_slot_tile_layout(x)
    out = slot_tile_step(eps_fn, x2, states, x.shape[1:], clip_x0=clip_x0,
                         stochastic=stochastic, want_x0=want_x0)
    if want_x0:
        return tuple(tile_ops.from_slot_tile_layout(o, n, x.shape)
                     for o in out)
    return tile_ops.from_slot_tile_layout(out, n, x.shape)
