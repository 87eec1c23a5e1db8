"""`repro_torch.autoplan` — budget-aware trajectory autotuning (the search
side of DDIM's compute/quality dial); port of ``repro.autoplan``.

The paper makes the step budget S a free parameter; this package CLOSES
the loop it opens: instead of hand-picked uniform/quadratic tau, an exact
dynamic program over a decomposable per-transition objective (Watson et
al. 2021) finds the best sub-sequence for EVERY budget at once, a
coordinate-descent pass tunes the remaining knobs (eta schedule, solver
order — Watson et al. 2022), and the resulting frontier persists as a
:class:`PlanBank` that serving loads at startup.  The continuous-batching
scheduler then picks a bank row PER REQUEST from its deadline and the
measured tick latency.

    from repro_torch.autoplan import (ObjectiveConfig, PlanExecutor,
                                      SearchConfig, PlanBank,
                                      build_objective, search_bank)

    table = build_objective(schedule, eps_fn, x0_batch,
                            ObjectiveConfig(grid_size=16, batch=16, chunk=8))
    ex = PlanExecutor(eps_fn)
    bank = search_bank(schedule, table, SearchConfig(budgets=(5, 10, 20)),
                       score_fn=lambda p: fid_proxy(ex.run(p, x_T, gen),
                                                    reference))
    bank.save("planbank.json")
    # serving: ContinuousBatchingEngine(..., plan_bank=PlanBank.load(...))

The sizes above fit one H100 at CIFAR10 width: the step-doubling defect
runs the model on up to ``pair_chunk`` (256) pairs x ``batch`` images per
call, and grid 16 x batch 16 is 1,920 images.  ``ObjectiveConfig()``'s
defaults (grid 48, batch 128) make that 32,768 CIFAR10 images in one call,
which one H100 does not hold; ``build_objective`` does not expose
``pair_chunk``, so at those defaults call ``step_doubling_defect`` with a
smaller ``pair_chunk``.

The model runs on the tensors' device (the CUDA card by default, as every
entry point of the port); the tables, the DP and the bank are float64 /
JSON on the host.  Everything downstream of the search is ordinary
SamplerPlan machinery: the found trajectories are `TauSpec.explicit`
plans, frozen and hashable, so scoring a candidate is a dictionary lookup
and one tile-resident rollout (:class:`PlanExecutor`), and serving mixes
bank rows across scheduler slots in one tick function.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.core.schedules import NoiseSchedule
from repro_torch.sampling import SamplerPlan

from .bank import BankEntry, PlanBank
from .executor import PlanExecutor
from .objective import (ObjectiveConfig, ObjectiveTable, build_objective,
                        make_grid, step_doubling_defect)
from .search import (DPResult, RefineConfig, SearchConfig, dp_search,
                     refine_plan, search_plans)

__all__ = [
    "BankEntry", "PlanBank", "PlanExecutor",
    "ObjectiveConfig", "ObjectiveTable", "build_objective", "make_grid",
    "step_doubling_defect",
    "DPResult", "RefineConfig", "SearchConfig", "dp_search", "refine_plan",
    "search_plans", "search_bank",
]


def search_bank(schedule: NoiseSchedule, table: ObjectiveTable,
                cfg: SearchConfig = SearchConfig(),
                score_fn: Optional[Callable[[SamplerPlan], float]] = None,
                model_digest: Optional[str] = None) -> PlanBank:
    """One-call search: DP + refinement over ``table`` into a PlanBank."""
    t0 = time.perf_counter()
    results = search_plans(schedule, table, cfg, score_fn=score_fn)
    bank = PlanBank(
        schedule,
        search_config={
            "budgets": list(cfg.budgets),
            "objective": {
                "grid_size": table.config.grid_size,
                "grid_kind": table.config.grid_kind,
                "eta": table.config.eta,
                "recon_sigma": table.config.recon_sigma,
                "quality_weight": table.quality_weight,
                "batch": table.config.batch,
                "seed": table.config.seed,
            },
            "refine": (None if cfg.refine is None else {
                "eta_grid": list(cfg.refine.eta_grid),
                "orders": list(cfg.refine.orders),
                "per_step_eta": cfg.refine.per_step_eta,
                "passes": cfg.refine.passes,
            }),
            "wall_s": None,   # patched below once the loop is timed
        },
        model_digest=model_digest)
    for S, rec in results.items():
        bank.add_plan(rec["plan"], objective=rec["dp"].objective,
                      score=rec["score"], wall_s=rec["wall_s"],
                      meta={"dp_taus": list(rec["dp"].taus),
                            "refine_trials": rec["trials"]})
    bank.search_config["wall_s"] = time.perf_counter() - t0
    return bank
