"""Per-transition diffusion ELBO terms (the decomposable DP objective);
port of ``repro/eval/elbo.py``.

The variational bound of the generalized (non-Markovian) family factors
over trajectory transitions (paper §4.1 / Watson et al. 2021 Eq. 3): for
any sub-sequence 0 = tau_0 < tau_1 < ... < tau_S,

  -ELBO = E_q[ KL(q(x_{tau_S}|x_0) || N(0, I)) ]                 (prior)
        + sum_{k=2..S} E_q[ KL(q_sigma(x_{tau_{k-1}} | x_{tau_k}, x_0)
                              || p_theta(x_{tau_{k-1}} | x_{tau_k})) ]
        + E_q[ -log p_theta(x_0 | x_{tau_1}) ]                   (recon)

Every term depends only on its OWN transition (s, t) — the bound over a
trajectory is a PATH SUM over a fixed table, which is exactly what makes
the optimal tau sub-sequence searchable by dynamic programming
(``repro_torch.autoplan.search``).  Both Gaussians in each KL share the
Eq. 16 variance sigma^2(s, t), so the KL collapses to a mean mismatch that
is an analytic multiple of the model's eps-prediction error:

  KL(s, t) = c(s, t)^2 * (1 - a_t) / (2 sigma^2 a_t) * E||eps - eps_hat||^2
  c(s, t)  = sqrt(a_s) - sqrt(1 - a_s - sigma^2) * sqrt(a_t) / sqrt(1 - a_t)

so the model is evaluated ONCE PER GRID TIMESTEP (a Monte-Carlo estimate
of the per-dim eps MSE, in float32 on the model's device) and the full
(s, t) table is a vectorized float64 numpy computation on the host —
T model evals buy a T x T table, not T^2 evals.

The reconstruction row uses a fixed-variance Gaussian decoder
N(x0_hat, recon_sigma^2 I) (the continuous-data stand-in for the paper's
discretized decoder), and the prior column is the closed-form Gaussian KL.
All terms are NATS PER DIMENSION; ``path_bpd`` converts a trajectory's sum
to bits/dim for Table-1-style likelihood reporting.

The forward-process noise is ``prng.normal`` of a threefry key, JAX's
draw, so one key gives the JAX package's table; ``noise=`` injects a
draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.schedules import NoiseSchedule

LN2 = float(np.log(2.0))


@dataclasses.dataclass(frozen=True)
class TransitionTable:
    """The decomposable per-transition NELBO terms on a timestep grid.

    Node 0 is the data endpoint s = 0; node j >= 1 is ``grid[j-1]``.

    Attributes:
      grid:  (G,) increasing int64 timesteps in [1, T].
      nodes: (G+1,) int64, ``[0] + grid``.
      trans: (G+1, G+1) float64, ``trans[i, j]`` = per-dim nats of the
        jump from t = nodes[j] down to s = nodes[i] (+inf where i >= j).
        Row 0 is the reconstruction term, rows i >= 1 are the KL terms.
      prior: (G+1,) float64, per-dim KL(q(x_{nodes[j]} | x0) || N(0, I))
        — the cost of STARTING a trajectory at nodes[j] (+inf at node 0).
      mse:   (G,) float64 per-dim Monte-Carlo E||eps - eps_hat||^2 at each
        grid timestep (the only model-dependent ingredient).
    """

    grid: np.ndarray
    nodes: np.ndarray
    trans: np.ndarray
    prior: np.ndarray
    mse: np.ndarray
    eta: float
    recon_sigma: float
    dims: int

    def path_nelbo(self, taus: Sequence[int]) -> float:
        """-ELBO (nats/dim) of the trajectory visiting ``taus`` (increasing).

        Every tau must be a grid timestep — the table has no rows for
        off-grid jumps.
        """
        idx = self._indices(taus)
        total = float(self.prior[idx[-1]])
        prev = 0
        for j in idx:
            total += float(self.trans[prev, j])
            prev = j
        return total

    def path_bpd(self, taus: Sequence[int]) -> float:
        """The same path sum in bits per dimension."""
        return self.path_nelbo(taus) / LN2

    def _indices(self, taus: Sequence[int]) -> np.ndarray:
        taus = np.asarray(taus, np.int64)
        idx = np.searchsorted(self.nodes, taus)
        if (idx >= len(self.nodes)).any() or (self.nodes[idx] != taus).any():
            missing = taus[(idx >= len(self.nodes))
                           | (self.nodes[np.minimum(idx, len(self.nodes) - 1)]
                              != taus)]
            raise ValueError(f"taus {missing.tolist()} are not on the "
                             f"table's grid")
        return idx


def _mse_reduce(eps_hat: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Per-dim per-timestep eps-prediction MSE over (T?, B, *shape) stacks
    — THE definition both the standalone table and callers injecting
    ``mse=`` (e.g. ``autoplan.build_objective``) must share."""
    d = (eps_hat.to(torch.float32) - eps.to(torch.float32)) ** 2
    return torch.mean(d, dim=tuple(range(1, d.dim())))


def eps_mse(eps_hat: torch.Tensor, noise: torch.Tensor) -> np.ndarray:
    """Public float64 form of :func:`_mse_reduce` for ``mse=`` injectors
    (float32 on the tensors' device, then float64 on the host)."""
    return _mse_reduce(eps_hat, noise).cpu().numpy().astype(np.float64)


def _alpha_bar_f32(schedule: NoiseSchedule, device) -> torch.Tensor:
    """alpha_bar as the float32 table both packages index by timestep."""
    ab = np.asarray(schedule.alpha_bar.detach().cpu().numpy(), np.float64)
    return torch.from_numpy(ab.astype(np.float32)).to(device)


def _mse_per_t(schedule: NoiseSchedule, eps_fn, x0: torch.Tensor,
               grid: np.ndarray, noise: torch.Tensor,
               chunk: int) -> np.ndarray:
    """Per-dim E||eps - eps_hat(x_t, t)||^2 at each grid t (one model eval
    per grid timestep, batched ``chunk`` timesteps at a time)."""
    B = x0.shape[0]
    ab = _alpha_bar_f32(schedule, x0.device)
    out = []
    with torch.inference_mode():
        for c0 in range(0, len(grid), chunk):
            ts = torch.from_numpy(np.asarray(grid[c0:c0 + chunk])).to(
                x0.device)
            eps = noise[c0:c0 + chunk].to(x0.device)
            a = ab[ts].reshape((-1, 1) + (1,) * (x0.dim() - 1))
            x_t = torch.sqrt(a) * x0[None] + torch.sqrt(1.0 - a) * eps
            flat = x_t.reshape((-1,) + tuple(x0.shape[1:]))
            t_vec = ts.to(torch.int32).repeat_interleave(B)
            eps_hat = eps_fn(flat, t_vec).reshape(eps.shape)
            out.append(eps_mse(eps_hat, eps))
    return np.concatenate(out)


def transition_elbo_table(schedule: NoiseSchedule, eps_fn, x0: torch.Tensor,
                          rng: Optional[torch.Tensor] = None,
                          grid: Optional[Sequence[int]] = None,
                          eta: float = 1.0, recon_sigma: float = 0.1,
                          chunk: int = 32,
                          noise: Optional[torch.Tensor] = None,
                          mse: Optional[np.ndarray] = None
                          ) -> TransitionTable:
    """Build the full per-transition NELBO table for a model.

    Args:
      schedule: the T-step noise schedule the model was trained with.
      eps_fn: eps_theta(x_t, t), t an int32 per-row tensor on x0's device.
      x0: (B, *shape) data batch for the Monte-Carlo expectation.
      rng: threefry key for the forward-process noise (ignored when
        ``noise`` is given; required otherwise).  The noise is drawn where
        the key lies and moved to x0's device.
      grid: increasing timesteps in [1, T] to tabulate (default: all of
        1..T).  Grid size G costs G model evals and a (G+1)^2 table.
      eta: Eq. 16 noise level defining the transition variances; must be
        > 0 (eta = 0 has zero variance and an undefined KL — the DP
        objective uses the DDPM-posterior eta = 1 by default, and the tau
        it finds is then served at any eta).
      recon_sigma: std of the fixed-variance Gaussian decoder in the
        reconstruction row.
      chunk: timesteps per batched model call.
      noise: optional (G, B, *shape) forward-process noise to inject
        (test/oracle hook — makes the Monte-Carlo estimate deterministic).
      mse: optional (G,) precomputed per-dim eps-MSE at each grid t —
        callers that already evaluated the model on the same noise (e.g.
        ``autoplan.build_objective``'s shared eps table) skip the G model
        evals here.

    Returns a :class:`TransitionTable` (float64, nats/dim).
    """
    if eta <= 0.0:
        raise ValueError(f"transition ELBO needs eta > 0 (Eq. 16 variance "
                         f"must be positive), got {eta}")
    if recon_sigma <= 0.0:
        raise ValueError(f"recon_sigma must be > 0, got {recon_sigma}")
    x0 = torch.as_tensor(x0)
    T = schedule.T
    if grid is None:
        grid = np.arange(1, T + 1, dtype=np.int64)
    else:
        grid = np.asarray(sorted(int(t) for t in grid), np.int64)
        if len(grid) == 0:
            raise ValueError("grid is empty")
        if len(np.unique(grid)) != len(grid):
            raise ValueError("grid has duplicate timesteps")
        if grid[0] < 1 or grid[-1] > T:
            raise ValueError(f"grid must lie in [1, T={T}], got "
                             f"[{grid[0]}, {grid[-1]}]")
    G = len(grid)
    if mse is not None:
        mse = np.asarray(mse, np.float64)
        if mse.shape != (G,):
            raise ValueError(f"mse shape {mse.shape} != ({G},)")
    else:
        if noise is None:
            if rng is None:
                raise ValueError("need rng (or explicit noise) for the "
                                 "Monte-Carlo eps-MSE estimate")
            noise = prng.normal(rng, (G,) + tuple(x0.shape))
        elif tuple(noise.shape) != (G,) + tuple(x0.shape):
            raise ValueError(f"noise shape {tuple(noise.shape)} != "
                             f"{(G,) + tuple(x0.shape)}")
        mse = _mse_per_t(schedule, eps_fn, x0, grid, noise, chunk)

    ab = np.asarray(schedule.alpha_bar.detach().cpu().numpy(), np.float64)
    nodes = np.concatenate([[0], grid])
    a_n = ab[nodes]                                  # a[0] = 1 by convention
    a_s = a_n[:, None]                               # rows: destination s
    a_t = a_n[None, :]                               # cols: source t
    with np.errstate(divide="ignore", invalid="ignore"):
        sig2 = (eta ** 2) * (1.0 - a_s) / (1.0 - a_t) * np.clip(
            1.0 - a_t / a_s, 0.0, None)
        c = np.sqrt(a_s) - (np.sqrt(np.clip(1.0 - a_s - sig2, 0.0, None))
                            * np.sqrt(a_t) / np.sqrt(1.0 - a_t))
        kl = c ** 2 * (1.0 - a_t) / (2.0 * sig2 * a_t)
        recon = (1.0 - a_t) / (2.0 * recon_sigma ** 2 * a_t)
    trans = np.full((G + 1, G + 1), np.inf)
    mse_row = np.concatenate([[np.nan], mse])        # column j uses mse[j-1]
    iu = np.triu_indices(G + 1, k=1)
    weight = np.where(np.arange(G + 1)[:, None] == 0, recon, kl)
    trans[iu] = (weight * mse_row[None, :])[iu]
    # the decoder's log-normalizer is an additive constant, NOT mse-scaled
    trans[0, 1:] += 0.5 * np.log(2.0 * np.pi * recon_sigma ** 2)

    m2 = float(np.mean(np.square(x0.detach().cpu().numpy().astype(
        np.float64))))
    prior = np.full((G + 1,), np.inf)
    prior[1:] = 0.5 * (a_n[1:] * m2 + (1.0 - a_n[1:]) - 1.0
                       - np.log(1.0 - a_n[1:]))
    return TransitionTable(grid=grid, nodes=nodes, trans=trans, prior=prior,
                           mse=mse, eta=float(eta),
                           recon_sigma=float(recon_sigma),
                           dims=int(np.prod(x0.shape[1:])))
