"""The decomposable per-transition objective the DP search minimizes; port
of ``repro/autoplan/objective.py``.

Two ingredients, both tabulated once over a candidate timestep GRID:

  * the diffusion ELBO terms (``repro_torch.eval.transition_elbo_table``)
    — the exact Watson et al. 2021 objective: one model eval per grid
    timestep, every (s, t) pair analytic on top.  Minimizing the path sum
    maximizes a variational bound on log-likelihood.
  * a cheap SAMPLE-QUALITY proxy: the step-doubling defect of the
    deterministic Eq. 12 jump.  For each pair (s, t) the one-jump state
    Phi(t->s) is compared against the two-jump state Phi(t->m->s) through
    the grid midpoint m — one extra model evaluation per (s, t) pair, all
    pairs batched into a handful of stacked calls.  This is the classic
    local truncation error of the ODE view (paper Eq. 14): it measures
    how much a long jump actually bends the trajectory, which is what
    degrades FID-proxy/MMD at small S — a failure mode the likelihood
    terms alone under-penalize (Watson et al. 2021 §5 observe exactly
    this ELBO/FID mismatch).  Image-shaped states are compared in
    ``repro_torch.eval.metrics.image_features`` space (the FID-proxy's
    feature map); flat states in state space.

The combined cost is ``elbo + quality_weight * defect`` — still a sum of
per-transition terms, so the DP's exact-optimality guarantee is intact.

The model runs in float32 on x0's device under ``torch.inference_mode``;
the tables are float64 numpy on the host.  ``build_objective`` draws its
forward-process noise with ``prng.normal(PRNGKey(ObjectiveConfig.seed))``
on x0's device, JAX's draw, so one seed gives the JAX package's table; the
functions below take the noise explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.eval import TransitionTable, transition_elbo_table
from repro_torch.eval.elbo import _alpha_bar_f32, eps_mse
from repro_torch.eval.metrics import image_features


@dataclasses.dataclass(frozen=True)
class ObjectiveConfig:
    """Search-objective knobs (recorded verbatim in PlanBank provenance)."""

    grid_size: int = 48          # candidate timesteps (evals: ~G + G^2/2)
    grid_kind: str = "quadratic"  # 'uniform' | 'quadratic' candidate spacing
    eta: float = 1.0             # Eq. 16 variance defining the ELBO terms
    recon_sigma: float = 0.1     # fixed-variance Gaussian decoder std
    quality_weight: float = 1.0  # weight on the step-doubling defect term
    batch: int = 128             # Monte-Carlo batch for both tables
    chunk: int = 32              # grid timesteps per stacked model call
    seed: int = 0

    def __post_init__(self):
        if self.grid_size < 2:
            raise ValueError(f"grid_size must be >= 2, got {self.grid_size}")
        if self.grid_kind not in ("uniform", "quadratic"):
            raise ValueError(f"unknown grid_kind {self.grid_kind!r}")
        if self.quality_weight < 0.0:
            raise ValueError("quality_weight must be >= 0")


@dataclasses.dataclass(frozen=True)
class ObjectiveTable:
    """ELBO + quality terms on one grid; ``cost`` is what the DP consumes."""

    elbo: TransitionTable
    defect: Optional[np.ndarray]     # (G+1, G+1) per-dim step-doubling MSE
    quality_weight: float
    config: ObjectiveConfig

    @property
    def nodes(self) -> np.ndarray:
        return self.elbo.nodes

    @property
    def grid(self) -> np.ndarray:
        return self.elbo.grid

    @property
    def cost(self) -> np.ndarray:
        c = self.elbo.trans
        if self.defect is not None and self.quality_weight > 0.0:
            c = c + self.quality_weight * self.defect
        return c

    @property
    def prior(self) -> np.ndarray:
        return self.elbo.prior

    def path_cost(self, taus: Sequence[int]) -> float:
        """Combined objective of a grid trajectory (the DP's path sum)."""
        idx = self.elbo._indices(taus)
        cost = self.cost
        total = float(self.prior[idx[-1]])
        prev = 0
        for j in idx:
            total += float(cost[prev, j])
            prev = j
        return total


def make_grid(T: int, size: int, kind: str = "quadratic") -> np.ndarray:
    """Candidate timestep grid: increasing, unique, always ending at T.

    'quadratic' concentrates candidates at low t (where the paper's own
    quadratic tau spends its budget); 'uniform' is even coverage.
    """
    size = min(size, T)
    i = np.arange(1, size + 1, dtype=np.float64)
    if kind == "uniform":
        g = np.round(i * T / size)
    elif kind == "quadratic":
        g = np.round((i / size) ** 2 * T)
    else:
        raise ValueError(f"unknown grid_kind {kind!r}")
    g = np.unique(np.clip(g.astype(np.int64), 1, T))
    if len(g) < size:   # collisions at low t: refill from unused timesteps
        missing = np.setdiff1d(np.arange(1, T + 1, dtype=np.int64), g)
        g = np.sort(np.concatenate([g, missing[: size - len(g)]]))
    return g


def _features(x: torch.Tensor) -> torch.Tensor:
    """Comparison space for the defect: FID-proxy features for images."""
    if x.dim() == 4:
        return image_features(x)
    return x.reshape(x.shape[0], -1)


def _eps_table(schedule: NoiseSchedule, eps_fn, x0: torch.Tensor,
               grid: np.ndarray, noise: torch.Tensor, chunk: int):
    """(x_t, eps_hat) at every grid timestep — ONE model eval per t,
    ``chunk`` timesteps per stacked call.  Both the ELBO table's eps-MSE
    and the defect's direct jumps derive from this shared table."""
    ab = _alpha_bar_f32(schedule, x0.device)
    B = x0.shape[0]
    x_t_all, eps_all = [], []
    with torch.inference_mode():
        for c0 in range(0, len(grid), chunk):
            ts = torch.from_numpy(np.asarray(grid[c0:c0 + chunk])).to(
                x0.device)
            eps = noise[c0:c0 + chunk].to(x0.device)
            a = ab[ts].reshape((-1, 1) + (1,) * (x0.dim() - 1))
            x_t = torch.sqrt(a) * x0[None] + torch.sqrt(1.0 - a) * eps
            flat = x_t.reshape((-1,) + tuple(x0.shape[1:]))
            t_vec = ts.to(torch.int32).repeat_interleave(B)
            x_t_all.append(x_t)
            eps_all.append(eps_fn(flat, t_vec).reshape(x_t.shape))
    return torch.cat(x_t_all), torch.cat(eps_all)


def step_doubling_defect(schedule: NoiseSchedule, eps_fn, x0: torch.Tensor,
                         grid: np.ndarray, noise: torch.Tensor,
                         pair_chunk: int = 256, chunk: int = 32,
                         eps_table=None) -> np.ndarray:
    """(G+1, G+1) per-dim squared step-doubling defect of the Eq. 12 jump.

    For each grid pair s < t (s = 0 included): draw x_t ~ q(x_t|x0) (the
    same noise the ELBO table used), jump deterministically t -> s in one
    step and in two steps through the grid midpoint, and average the
    squared feature-space gap.  Costs ONE model eval per pair (at the
    midpoint state) on top of the G per-timestep evals — all stacked into
    ``pair_chunk``-sized batched calls of ``pair_chunk * batch`` states
    (``chunk`` timesteps per call for the per-t table; pass
    ``eps_table=(x_t, eps_hat)`` to reuse one already computed).
    Adjacent pairs (no interior grid point) have zero defect by
    construction.
    """
    G = len(grid)
    nodes = np.concatenate([[0], grid])
    B = x0.shape[0]
    dev = x0.device
    ab = _alpha_bar_f32(schedule, dev)

    # one model eval per grid t: eps_hat at x_t (shared across its pairs)
    x_t_all, eps_all = (eps_table if eps_table is not None else
                        _eps_table(schedule, eps_fn, x0, grid, noise,
                                   chunk))                 # (G, B, *shape)

    def _jump(x, eps, t_from, t_to):
        """Deterministic Eq. 12 jump t_from -> t_to (per-pair timesteps)."""
        a_f, a_to = ab[t_from], ab[t_to]
        shp = (-1, 1) + (1,) * (x.dim() - 2)
        a = (torch.sqrt(a_to) / torch.sqrt(a_f)).reshape(shp)
        b = (torch.sqrt(1.0 - a_to)
             - torch.sqrt(a_to / a_f) * torch.sqrt(1.0 - a_f)).reshape(shp)
        return a * x + b * eps

    # pairs with an interior midpoint; (i, j) node indices, mid grid index
    pairs = [(i, j, (i + j) // 2)
             for j in range(2, G + 1) for i in range(0, j - 1)]
    defect = np.zeros((G + 1, G + 1))
    sample = tuple(x0.shape[1:])
    with torch.inference_mode():
        for c0 in range(0, len(pairs), pair_chunk):
            batch_pairs = pairs[c0:c0 + pair_chunk]
            ii = np.array([p[0] for p in batch_pairs])
            jj = np.array([p[1] for p in batch_pairs])
            mm = np.array([p[2] for p in batch_pairs])
            ti = torch.from_numpy(nodes[ii]).to(dev)
            tj = torch.from_numpy(nodes[jj]).to(dev)
            tm = torch.from_numpy(grid[mm - 1]).to(dev)
            sel = torch.from_numpy(jj - 1).to(dev)
            x_tj, eps_tj = x_t_all[sel], eps_all[sel]
            one = _jump(x_tj, eps_tj, tj, ti)              # t -> s direct
            x_m = _jump(x_tj, eps_tj, tj, tm)              # t -> m
            flat = x_m.reshape((-1,) + sample)
            t_vec = tm.to(torch.int32).repeat_interleave(B)
            eps_m = eps_fn(flat, t_vec).reshape(x_m.shape)  # the pair eval
            two = _jump(x_m, eps_m, tm, ti)                # m -> s
            d = _features(one.reshape((-1,) + sample))
            d = d - _features(two.reshape((-1,) + sample))
            d = d.reshape(one.shape[0], B, -1) ** 2
            vals = torch.mean(d, dim=(1, 2))
            defect[ii, jj] = vals.cpu().numpy().astype(np.float64)
    return defect


def build_objective(schedule: NoiseSchedule, eps_fn, x0: torch.Tensor,
                    cfg: ObjectiveConfig = ObjectiveConfig(),
                    rng: Optional[torch.Tensor] = None) -> ObjectiveTable:
    """Tabulate the combined DP objective for one model on one grid.

    ``x0`` is a data batch (at least ``cfg.batch`` rows; extra rows are
    dropped) on the device the model runs on.  The same forward-process
    noise draw — ``normal(rng)``, by default ``rng = PRNGKey(cfg.seed)``
    on x0's device, as in JAX — feeds both the ELBO table
    and the defect table, so the two terms see the same x_t states, and
    the per-timestep eps evaluations are computed ONCE and shared (the
    ELBO's eps-MSE and the defect's direct jumps both read them).
    """
    x0 = torch.as_tensor(x0)[: cfg.batch]
    if rng is None:
        rng = prng.PRNGKey(cfg.seed, x0.device)
    grid = make_grid(schedule.T, cfg.grid_size, cfg.grid_kind)
    noise = prng.normal(rng, (len(grid),) + tuple(x0.shape)).to(x0.device)
    eps_table = _eps_table(schedule, eps_fn, x0, grid, noise, cfg.chunk)
    mse = eps_mse(eps_table[1], noise)
    elbo = transition_elbo_table(schedule, eps_fn, x0, grid=grid,
                                 eta=cfg.eta, recon_sigma=cfg.recon_sigma,
                                 chunk=cfg.chunk, noise=noise, mse=mse)
    defect = None
    if cfg.quality_weight > 0.0:
        defect = step_doubling_defect(schedule, eps_fn, x0, grid, noise,
                                      chunk=cfg.chunk, eps_table=eps_table)
    return ObjectiveTable(elbo=elbo, defect=defect,
                          quality_weight=cfg.quality_weight, config=cfg)
