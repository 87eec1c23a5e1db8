"""PlanBank — the persisted budget -> best-plan frontier serving loads;
port of ``repro/autoplan/bank.py``.

A bank is the search subsystem's product: for each step budget (NFE) the
best :class:`repro_torch.sampling.SamplerPlan` found, with provenance (DP
objective, rollout scores vs the uniform/quadratic baselines at equal
NFE, search config, schedule/model digests).  Serving loads it once at
startup — no re-search — and the scheduler's deadline-aware admission
picks a row per request (`select`).

On disk a bank is ONE JSON artifact (human-diffable, committed next to
benchmark baselines); in memory every entry lazily builds and caches its
frozen plan, so repeated selections hand back the SAME hashable object
and every plan-keyed cache downstream (the engine's table cache) hits.

Schedule binding: a bank records the noise-schedule digest it was
searched on; ``load`` re-validates against the schedule it is handed, so
a bank can never silently serve trajectories from a different diffusion.

The JSON format is the JAX package's, key for key (same ``FORMAT`` tag,
same schedule digest), so a bank saved by either package loads in the
other.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedules import NoiseSchedule
from repro_torch.sampling import SamplerPlan, SigmaSpec, TauSpec, X0Policy
from repro_torch.sampling.plan import _schedule_digest

FORMAT = "repro.autoplan.PlanBank/v1"


class _Unset:
    """Sentinel: 'no clip filter' (None is a real clip value)."""

    def __repr__(self):
        return "<unset>"


_UNSET = _Unset()


def _sigma_to_json(sigma: SigmaSpec) -> Dict:
    d = {"kind": sigma.kind}
    if sigma.kind == "eta":
        d["eta"] = sigma.eta
        if sigma.sigma_hat:
            d["sigma_hat"] = True
    elif sigma.kind == "eta_schedule":
        d["etas"] = list(sigma.etas)
    else:
        d["sigmas"] = list(sigma.sigmas)
    return d


def _sigma_from_json(d: Dict) -> SigmaSpec:
    kind = d["kind"]
    if kind == "eta":
        return SigmaSpec.from_eta(d["eta"], sigma_hat=d.get("sigma_hat",
                                                            False))
    if kind == "eta_schedule":
        return SigmaSpec.schedule(d["etas"])
    if kind == "explicit":
        return SigmaSpec.explicit(d["sigmas"])
    raise ValueError(f"unknown sigma kind in bank entry: {kind!r}")


@dataclasses.dataclass
class BankEntry:
    """One frontier row: the best plan found for one step budget."""

    nfe: int                                   # steps == network evals
    taus: Tuple[int, ...]
    sigma: SigmaSpec = SigmaSpec.ddim()
    order: int = 1
    clip: Optional[float] = None
    objective: Optional[float] = None          # DP path cost (nats/dim+)
    score: Optional[float] = None              # rollout score (lower=better)
    baselines: Dict[str, float] = dataclasses.field(default_factory=dict)
    wall_s: Optional[float] = None             # search wall for this row
    meta: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict:
        return {
            "nfe": self.nfe, "taus": list(self.taus),
            "sigma": _sigma_to_json(self.sigma), "order": self.order,
            "clip": self.clip, "objective": self.objective,
            "score": self.score, "baselines": dict(self.baselines),
            "wall_s": self.wall_s, "meta": dict(self.meta),
        }

    @classmethod
    def from_json(cls, d: Dict) -> "BankEntry":
        return cls(nfe=int(d["nfe"]), taus=tuple(int(t) for t in d["taus"]),
                   sigma=_sigma_from_json(d["sigma"]),
                   order=int(d.get("order", 1)), clip=d.get("clip"),
                   objective=d.get("objective"), score=d.get("score"),
                   baselines=dict(d.get("baselines", {})),
                   wall_s=d.get("wall_s"), meta=dict(d.get("meta", {})))


class PlanBank:
    """Budget-indexed frontier of frozen SamplerPlans + provenance.

    Entries are kept sorted by NFE; one entry per NFE (adding a duplicate
    budget replaces the row).  Plans build lazily against the bound
    schedule and are cached, so equal selections share one frozen object.
    """

    def __init__(self, schedule: NoiseSchedule,
                 entries: Sequence[BankEntry] = (),
                 search_config: Optional[Dict] = None,
                 model_digest: Optional[str] = None):
        self.schedule = schedule
        self.search_config = dict(search_config or {})
        self.model_digest = model_digest
        self._entries: List[BankEntry] = []
        self._plans: Dict[int, SamplerPlan] = {}
        for e in entries:
            self.add_entry(e)

    # ------------------------------------------------------------ mutation
    def add_entry(self, entry: BankEntry) -> None:
        TauSpec.explicit(entry.taus, T=self.schedule.T)   # fail fast
        if len(entry.taus) != entry.nfe:
            raise ValueError(f"entry nfe={entry.nfe} != len(taus)="
                             f"{len(entry.taus)}")
        self._entries = [e for e in self._entries if e.nfe != entry.nfe]
        self._entries.append(entry)
        self._entries.sort(key=lambda e: e.nfe)
        self._plans.pop(entry.nfe, None)

    def add_plan(self, plan: SamplerPlan, **meta) -> BankEntry:
        """Add a searched plan (its specs are decomposed into the entry)."""
        if plan.schedule_digest() != _schedule_digest(self.schedule):
            raise ValueError("plan built on a different noise schedule "
                             "than this bank")
        if plan.tau.kind != "explicit":
            raise ValueError("bank plans carry explicit (searched) taus; "
                             f"got tau kind {plan.tau.kind!r}")
        entry = BankEntry(nfe=plan.S, taus=plan.tau.taus, sigma=plan.sigma,
                          order=plan.order, clip=plan.x0.clip, **meta)
        self.add_entry(entry)
        self._plans[entry.nfe] = plan
        return entry

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> Tuple[BankEntry, ...]:
        return tuple(self._entries)

    @property
    def nfes(self) -> Tuple[int, ...]:
        return tuple(e.nfe for e in self._entries)

    def plan(self, nfe: int) -> SamplerPlan:
        """The frozen plan for one budget (built once, then cached)."""
        if nfe not in self._plans:
            entry = next((e for e in self._entries if e.nfe == nfe), None)
            if entry is None:
                raise KeyError(f"no bank entry with nfe={nfe}; have "
                               f"{self.nfes}")
            self._plans[nfe] = SamplerPlan(
                schedule=self.schedule,
                tau=TauSpec.explicit(entry.taus, T=self.schedule.T),
                sigma=entry.sigma, x0=X0Policy(clip=entry.clip),
                order=entry.order)
        return self._plans[nfe]

    def compatible(self, deterministic: Optional[bool] = None,
                   max_order: Optional[int] = None,
                   clip: object = _UNSET) -> List[BankEntry]:
        """Entries a caller with the given capabilities could serve.

        ``deterministic=True`` drops stochastic rows, ``False`` drops
        deterministic rows, ``None`` keeps both; ``max_order`` drops
        higher-order solvers; ``clip`` (when passed — None is a real clip
        value) keeps only exact matches.  This is the filter ``best`` and
        ``select`` (and the scheduler's admission) build on.
        """
        out = []
        for e in self._entries:
            if max_order is not None and e.order > max_order:
                continue
            if clip is not _UNSET and e.clip != clip:
                continue
            if (deterministic is not None
                    and self.plan(e.nfe).stochastic == deterministic):
                continue
            out.append(e)
        return out

    def best(self, max_nfe: Optional[int] = None, *,
             deterministic: Optional[bool] = None,
             max_order: Optional[int] = None,
             clip: object = _UNSET) -> Optional[SamplerPlan]:
        """The largest-NFE compatible plan with NFE <= ``max_nfe``.

        ``max_nfe=None`` means unconstrained (the quality end of the
        frontier).  Returns None when no entry is compatible at all; if
        entries are compatible but all exceed ``max_nfe``, returns the
        SMALLEST compatible plan (graceful degradation — serve the
        cheapest thing the bank knows rather than nothing).
        """
        cands = self.compatible(deterministic, max_order, clip)
        if not cands:
            return None
        fits = [e for e in cands
                if max_nfe is None or e.nfe <= max_nfe]
        entry = max(fits, key=lambda e: e.nfe) if fits else \
            min(cands, key=lambda e: e.nfe)
        return self.plan(entry.nfe)

    def select(self, headroom_s: float, per_step_s: Optional[float],
               margin: float = 0.9, *,
               deterministic: Optional[bool] = None,
               max_order: Optional[int] = None,
               clip: object = _UNSET,
               on_outcome: Optional[Callable] = None
               ) -> Optional[SamplerPlan]:
        """Deadline-aware row pick: the largest NFE that FITS the budget.

        ``headroom_s`` is the caller's remaining time (deadline - now;
        +inf for deadline-free requests); ``per_step_s`` the measured
        per-step latency (the scheduler's EWMA tick time — one tick
        advances a request one step).  A plan fits when
        ``NFE * per_step_s <= headroom_s * margin``.  With no latency
        measurement yet (``per_step_s`` None/0) a finite deadline picks
        the SMALLEST compatible plan (nothing is known, be conservative);
        an infinite headroom always picks the quality end.

        ``on_outcome(outcome, plan)`` — selection-policy telemetry hook,
        called exactly once per select with WHY this row was picked:

        * ``"quality"``      — no deadline: quality end of the frontier
        * ``"conservative"`` — deadline but no latency measurement yet:
          smallest compatible row
        * ``"fit"``          — largest row fitting the deadline headroom
        * ``"degraded"``     — nothing fits: smallest compatible row
          (serve the cheapest thing known rather than nothing)
        * ``"none"``         — no compatible row at all (plan is None)
        """
        def done(outcome: str, plan: Optional[SamplerPlan]):
            if on_outcome is not None:
                on_outcome(outcome, plan)
            return plan

        cands = self.compatible(deterministic, max_order, clip)
        if not cands:
            return done("none", None)
        if math.isinf(headroom_s):
            return done("quality",
                        self.plan(max(cands, key=lambda e: e.nfe).nfe))
        if not per_step_s:
            return done("conservative",
                        self.plan(min(cands, key=lambda e: e.nfe).nfe))
        fit = int(max(headroom_s, 0.0) * margin / per_step_s)
        fits = [e for e in cands if e.nfe <= fit]
        if fits:
            return done("fit", self.plan(max(fits, key=lambda e: e.nfe).nfe))
        return done("degraded",
                    self.plan(min(cands, key=lambda e: e.nfe).nfe))

    # --------------------------------------------------------- persistence
    def to_json(self) -> Dict:
        return {
            "format": FORMAT,
            "schedule": {"digest": _schedule_digest(self.schedule).hex(),
                         "T": self.schedule.T, "kind": self.schedule.kind},
            "model_digest": self.model_digest,
            "search_config": self.search_config,
            "entries": [e.to_json() for e in self._entries],
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str, schedule: NoiseSchedule) -> "PlanBank":
        """Load and re-validate a bank against the serving schedule."""
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != FORMAT:
            raise ValueError(f"{path}: not a PlanBank artifact "
                             f"(format={d.get('format')!r})")
        digest = _schedule_digest(schedule).hex()
        if d["schedule"]["digest"] != digest:
            raise ValueError(
                f"{path}: bank was searched on a different noise schedule "
                f"(bank kind={d['schedule']['kind']!r} T="
                f"{d['schedule']['T']}; serving kind={schedule.kind!r} "
                f"T={schedule.T}) — re-search or load the matching bank")
        return cls(schedule,
                   entries=[BankEntry.from_json(e) for e in d["entries"]],
                   search_config=d.get("search_config"),
                   model_digest=d.get("model_digest"))

