"""Exact DP over tau sub-sequences + coordinate-descent plan refinement;
port of ``repro/autoplan/search.py`` (numpy on the host, over the port's
sampling specs).

DP (Watson et al. 2021): the objective table is decomposable — the cost of
a trajectory 0 < tau_1 < ... < tau_S is prior(tau_S) plus a sum of
per-transition terms — so the best S-step sub-sequence of the candidate
grid is an exact shortest-path problem:

    C_1[j]   = cost(0, j)                                  (the recon jump)
    C_k[j]   = min_{i < j}  C_{k-1}[i] + cost(i, j)
    best(S)  = argmin_j  C_S[j] + prior[j]

One O(S_max * G^2) vectorized sweep yields the OPTIMAL trajectory for
EVERY budget 1..S_max simultaneously (the whole frontier from one pass);
optimality vs brute-force enumeration is asserted in
tests/test_torch_autoplan.py.

Refinement (Watson et al. 2022 motivate tuning the remaining knobs): on
top of the DP tau, a coordinate-descent pass grid-tunes the solver order
and the (scalar or per-step) eta schedule, scoring FULL ROLLOUTS of each
candidate plan through a statics-keyed :class:`PlanExecutor` —
candidates share one rollout function, so each trial is one lookup and one
tile-resident loop (one B1 launch per step on the card).  Only
moves that improve the rollout score are kept, so the refined plan is
never worse than the raw DP plan under the scorer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.schedules import NoiseSchedule
from repro_torch.core.solver import MAX_ORDER
from repro_torch.sampling import SamplerPlan, SigmaSpec, TauSpec, X0Policy

from .objective import ObjectiveTable


@dataclasses.dataclass(frozen=True)
class DPResult:
    """The optimal grid sub-sequence for one step budget."""

    S: int
    taus: Tuple[int, ...]          # increasing timesteps (grid values)
    objective: float               # path cost incl. prior (nats/dim scale)

    def tau_spec(self, T: Optional[int] = None) -> TauSpec:
        return TauSpec.explicit(self.taus, T=T)


def dp_search(table: ObjectiveTable,
              budgets: Sequence[int]) -> Dict[int, DPResult]:
    """Exact least-cost tau sub-sequences for every requested budget.

    ``budgets`` are step counts S (network evals per sample).  Budgets
    larger than the grid are clamped to the grid size (the grid is the
    candidate set — a trajectory cannot visit more points than exist).
    """
    budgets = sorted({int(b) for b in budgets})
    if not budgets or budgets[0] < 1:
        raise ValueError(f"budgets must be positive ints, got {budgets}")
    cost = table.cost                       # (N, N), N = G+1, +inf invalid
    prior = table.prior
    nodes = table.nodes
    N = cost.shape[0]
    S_max = min(budgets[-1], N - 1)

    C = cost[0].copy()                      # C_1[j] = cost(0 -> j)
    parents = np.zeros((S_max + 1, N), np.int32)
    best: Dict[int, np.ndarray] = {}
    Cs: Dict[int, np.ndarray] = {1: C.copy()}
    for k in range(2, S_max + 1):
        # min-plus step, vectorized over all (i, j) at once
        tot = C[:, None] + cost             # (N, N): via i, ending at j
        parents[k] = np.argmin(tot, axis=0)
        C = tot[parents[k], np.arange(N)]
        Cs[k] = C.copy()

    out: Dict[int, DPResult] = {}
    for S in budgets:
        S_eff = min(S, S_max)
        total = Cs[S_eff] + prior
        j = int(np.argmin(total))
        if not np.isfinite(total[j]):
            raise ValueError(f"no feasible {S_eff}-step trajectory on a "
                             f"{N - 1}-point grid")
        path = [j]
        for k in range(S_eff, 1, -1):
            j = int(parents[k][j])
            path.append(j)
        taus = tuple(int(nodes[i]) for i in reversed(path))
        out[S] = DPResult(S=S_eff, taus=taus,
                          objective=float(total[path[0]]))
    return out


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Coordinate-descent knobs for the post-DP refinement pass."""

    eta_grid: Tuple[float, ...] = (0.0, 0.25, 0.5, 1.0)
    orders: Tuple[int, ...] = (1, 2, 3)
    per_step_eta: bool = False     # sweep each step's eta (S x |grid| trials)
    passes: int = 1

    def __post_init__(self):
        if any(not 1 <= o <= MAX_ORDER for o in self.orders):
            raise ValueError(f"orders must be in 1..{MAX_ORDER}")
        if any(e < 0 for e in self.eta_grid):
            raise ValueError("eta_grid entries must be >= 0")
        if self.passes < 1:
            raise ValueError("passes must be >= 1")


def _build_plan(schedule: NoiseSchedule, taus: Tuple[int, ...],
                etas: Tuple[float, ...], order: int,
                clip: Optional[float]) -> SamplerPlan:
    if any(e > 0 for e in etas):
        sigma = (SigmaSpec.schedule(etas) if len(set(etas)) > 1
                 else SigmaSpec.from_eta(etas[0]))
        order = 1                  # stochastic plans are single-step only
    else:
        sigma = SigmaSpec.ddim()
    return SamplerPlan(schedule=schedule, tau=TauSpec.explicit(taus),
                       sigma=sigma, x0=X0Policy(clip=clip), order=order)


def refine_plan(schedule: NoiseSchedule, taus: Sequence[int],
                score_fn: Callable[[SamplerPlan], float],
                cfg: RefineConfig = RefineConfig(),
                clip: Optional[float] = None,
                init_score: Optional[float] = None
                ) -> Tuple[SamplerPlan, float, int]:
    """Coordinate descent over (order, eta schedule) on a fixed tau.

    ``score_fn(plan) -> float`` (lower is better) is typically a full
    rollout scored by an ``eval.metrics`` distance through a shared
    :class:`PlanExecutor`.  ``init_score``, when given, is the caller's
    already-computed score of the eta=0 order-1 starting plan (skips the
    duplicate baseline rollout).  Returns (best plan, best score,
    trials).  Stochastic moves force order back to 1 (multistep
    integrates the deterministic ODE view), so the two coordinates stay
    consistent.
    """
    taus = tuple(int(t) for t in taus)
    S = len(taus)
    etas = (0.0,) * S
    order = 1
    best_plan = _build_plan(schedule, taus, etas, order, clip)
    best = (float(score_fn(best_plan)) if init_score is None
            else float(init_score))
    trials = 1
    for _ in range(cfg.passes):
        # ---- solver order (deterministic plans only)
        if all(e == 0 for e in etas):
            for o in cfg.orders:
                if o == order:
                    continue
                cand = _build_plan(schedule, taus, etas, o, clip)
                s = float(score_fn(cand))
                trials += 1
                if s < best:
                    best, best_plan, order = s, cand, o
        # ---- eta: scalar sweep, then optional per-step sweep
        for v in cfg.eta_grid:
            cand_etas = (v,) * S
            if cand_etas == etas:
                continue
            cand = _build_plan(schedule, taus, cand_etas,
                               order if v == 0 else 1, clip)
            s = float(score_fn(cand))
            trials += 1
            if s < best:
                best, best_plan, etas = s, cand, cand_etas
                if v > 0:
                    order = 1
        if cfg.per_step_eta:
            for k in range(S):
                for v in cfg.eta_grid:
                    if etas[k] == v:
                        continue
                    cand_etas = etas[:k] + (v,) + etas[k + 1:]
                    cand = _build_plan(
                        schedule, taus, cand_etas,
                        order if all(e == 0 for e in cand_etas) else 1,
                        clip)
                    s = float(score_fn(cand))
                    trials += 1
                    if s < best:
                        best, best_plan, etas = s, cand, cand_etas
                        if any(e > 0 for e in cand_etas):
                            order = 1
    return best_plan, best, trials


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """End-to-end search: objective grid -> DP frontier -> refinement."""

    budgets: Tuple[int, ...] = (5, 10, 20, 50)
    refine: Optional[RefineConfig] = RefineConfig()
    clip: Optional[float] = None

    def __post_init__(self):
        if not self.budgets or any(b < 1 for b in self.budgets):
            raise ValueError(f"budgets must be positive, got {self.budgets}")


def search_plans(schedule: NoiseSchedule, table: ObjectiveTable,
                 cfg: SearchConfig = SearchConfig(),
                 score_fn: Optional[Callable[[SamplerPlan], float]] = None,
                 ):
    """DP + refinement over a prebuilt objective table.

    Returns ``{budget: dict}`` where each record carries the DP result,
    the final (possibly refined) plan, scores, and wall-clock — the raw
    material :class:`repro_torch.autoplan.PlanBank` entries are built
    from.
    Refinement runs only when ``score_fn`` is given (it needs a rollout
    scorer); otherwise the DP plan ships as-is at eta = 0, order 1.
    """
    t0 = time.perf_counter()
    dp = dp_search(table, cfg.budgets)
    dp_wall = time.perf_counter() - t0
    out = {}
    for S in cfg.budgets:
        r = dp[S]
        t1 = time.perf_counter()
        plan = _build_plan(schedule, r.taus, (0.0,) * r.S, 1, cfg.clip)
        score = None
        trials = 0
        if score_fn is not None:
            score = float(score_fn(plan))
            trials = 1
            if cfg.refine is not None:
                plan, score, trials = refine_plan(
                    schedule, r.taus, score_fn, cfg.refine, clip=cfg.clip,
                    init_score=score)
        out[S] = dict(dp=r, plan=plan, score=score, trials=trials,
                      wall_s=dp_wall / len(cfg.budgets)
                      + time.perf_counter() - t1)
    return out
