"""Deterministic fault injection for the serving stack (port of
``repro/serving/resilience/faults.py``; one seed gives the same plan in
both packages, fault for fault).

A :class:`FaultPlan` is a frozen, seeded schedule of faults keyed on
(pool, per-pool busy-tick index) — the same plan replayed against the
same request trace produces the same failure sequence, which is what
lets a chaos replay GATE recovery behavior instead of sampling it. Five
fault kinds (docs/resilience.md has the taxonomy):

  ``tick-error``      raise InjectedFault just before pool p's n-th busy
                      tick (models a device/XLA fault: the supervisor
                      must quarantine the pool and migrate its work)
  ``nan-eps``         overwrite one resident slot's tile rows with NaN
                      after the tick (``engine.write_slot_rows`` moves
                      the host rows to the engine's device; models a
                      numerically exploded eps
                      trunk: the gateway's terminal guard must convert
                      the garbage into a typed 5xx, never stream it)
  ``tick-latency``    report ``delay_s`` of injected latency after the
                      tick (virtual-clock replays add it to the clock;
                      goodput gates see the slowdown)
  ``sse-disconnect``  mark the n-th ACCEPTED request for a mid-stream
                      client disconnect (the chaos harness cancels it
                      after its first streamed event — the gateway must
                      free the slot and emit a ``cancel`` span)
  ``corrupted-weights`` hot-swap the pool's eps weights with a scaled
                      copy after the tick (models silent weight
                      corruption: every sample stays FINITE, so neither
                      the nonfinite guard nor the breaker sees it — only
                      the device-probe tier's eps activation statistics
                      can localize it, via
                      obs.flight.detect_weight_corruption)

The injector is threaded through :class:`PoolSupervisor` as an OPTIONAL
hook: a supervisor built with ``injector=None`` (the default everywhere
outside tests/chaos runs) pays one ``is None`` test per tick and adds
zero ops to any tick function — faults are host-side control flow by
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

FAULT_KINDS = ("tick-error", "nan-eps", "tick-latency", "sse-disconnect",
               "corrupted-weights")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``pool``/``tick`` key the tick-scoped kinds
    (per-pool BUSY tick index, as counted by the supervisor); ``delay_s``
    is the injected latency for ``tick-latency``; ``request_index`` is
    the acceptance-order index for ``sse-disconnect``; ``scale`` is the
    weight multiplier for ``corrupted-weights``."""

    kind: str
    pool: int = 0
    tick: int = 0
    delay_s: float = 0.0
    request_index: int = 0
    scale: float = 8.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")


def _scale_matrices(tree, scale: float):
    """A copy of a nested dict / list / tuple of tensors with every leaf
    of ndim >= 2 multiplied by ``scale`` (same shape, dtype, device) and
    every other leaf passed through."""
    if isinstance(tree, dict):
        return {k: _scale_matrices(v, scale) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_scale_matrices(v, scale) for v in tree)
    return tree * scale if getattr(tree, "ndim", 0) >= 2 else tree


class InjectedFault(RuntimeError):
    """The exception a ``tick-error`` fault raises inside the tick path.

    Carries its :class:`Fault` spec so audits (and tests) can tell an
    injected failure from an organic one."""

    def __init__(self, fault: Fault):
        super().__init__(
            f"injected tick fault: pool={fault.pool} tick={fault.tick}")
        self.fault = fault


class FaultPlan:
    """An immutable, validated collection of faults."""

    def __init__(self, faults: Sequence[Fault]):
        tick_keys = [(f.pool, f.tick) for f in faults
                     if f.kind in ("tick-error", "nan-eps", "tick-latency",
                                   "corrupted-weights")]
        if len(tick_keys) != len(set(tick_keys)):
            raise ValueError("fault plan schedules two tick-scoped faults "
                             "on the same (pool, tick)")
        self.faults: Tuple[Fault, ...] = tuple(faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    @classmethod
    def seeded(cls, seed: int, *, n_pools: int, horizon_ticks: int,
               n_tick_errors: int = 2, n_nan: int = 1, n_latency: int = 2,
               latency_s: float = 0.05, n_disconnects: int = 1,
               n_requests: int = 0, n_corrupt: int = 0,
               corrupt_scale: float = 8.0) -> "FaultPlan":
        """A deterministic plan drawn from one PRNG stream.

        Tick-scoped faults land on distinct (pool, tick) cells sampled
        without replacement from the ``n_pools x horizon_ticks`` grid
        (ticks start at 1 so pools always complete their first tick);
        disconnects pick distinct acceptance indices in
        ``[0, n_requests)``. Same seed, same plan — always.
        """
        rng = np.random.default_rng(seed)
        n_tick = n_tick_errors + n_nan + n_latency + n_corrupt
        grid = n_pools * max(horizon_ticks - 1, 1)
        if n_tick > grid:
            raise ValueError(f"{n_tick} tick faults won't fit a "
                             f"{n_pools}x{horizon_ticks} grid")
        cells = rng.choice(grid, size=n_tick, replace=False)
        kinds = (["tick-error"] * n_tick_errors + ["nan-eps"] * n_nan
                 + ["tick-latency"] * n_latency
                 + ["corrupted-weights"] * n_corrupt)
        faults: List[Fault] = []
        for kind, cell in zip(kinds, cells):
            pool, tick = int(cell) % n_pools, 1 + int(cell) // n_pools
            faults.append(Fault(kind=kind, pool=pool, tick=tick,
                                delay_s=(latency_s if kind == "tick-latency"
                                         else 0.0),
                                scale=corrupt_scale))
        if n_disconnects:
            if n_requests <= 0:
                raise ValueError("sse-disconnect faults need n_requests")
            idx = rng.choice(n_requests, size=min(n_disconnects, n_requests),
                             replace=False)
            faults.extend(Fault(kind="sse-disconnect",
                                request_index=int(i)) for i in idx)
        return cls(faults)


class FaultInjector:
    """Executes a FaultPlan against the supervisor's tick loop.

    The supervisor calls ``before_tick``/``after_tick`` around every
    BUSY pool tick with that pool's own tick index; the chaos harness
    consumes the disconnect schedule via ``should_disconnect``. Every
    fired fault is appended to ``log`` (an audit a chaos replay asserts
    against — e.g. "quarantine count == tick-errors fired").
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        # poison audits: the exact (pool, slot, step) each corruption
        # fault actually hit — a chaos replay's ground truth for the
        # flight-recorder attribution gate (docs/resilience.md)
        self.poisoned: List[Dict] = []
        self.corrupted: List[Dict] = []
        self._by_tick: Dict[Tuple[int, int], Fault] = {
            (f.pool, f.tick): f for f in plan
            if f.kind in ("tick-error", "nan-eps", "tick-latency",
                          "corrupted-weights")}
        self._disconnects: Set[int] = {
            f.request_index for f in plan if f.kind == "sse-disconnect"}
        self.log: List[Fault] = []

    def before_tick(self, pool: int, tick: int) -> None:
        """Raise the scheduled InjectedFault, if any."""
        f = self._by_tick.get((pool, tick))
        if f is not None and f.kind == "tick-error":
            self.log.append(f)
            raise InjectedFault(f)

    def after_tick(self, pool: int, tick: int, engine) -> float:
        """Post-tick corruption/latency; returns injected seconds."""
        f = self._by_tick.get((pool, tick))
        if f is None:
            return 0.0
        if f.kind == "nan-eps":
            residents = engine.resident_requests()
            if residents:
                b, req = residents[0]
                step = int(engine.snapshot_slot(b).k)
                rows = np.full(engine.slot_rows_shape, np.nan, np.float32)
                engine.write_slot_rows(b, rows)
                self.log.append(f)
                self.poisoned.append({
                    "pool": pool, "tick": tick, "slot": b,
                    "request_id": req.request_id, "step": step})
            return 0.0
        if f.kind == "corrupted-weights":
            params = getattr(engine, "eps_params", None)
            if params is not None:
                # corrupt the MATRIX leaves only: 1-D buffers riding in
                # the weights (alpha_bar, scalar gains) must keep their
                # values or the samples go nonfinite instead of silently
                # wrong — this fault models corruption the nonfinite
                # guard CANNOT see. Same shapes/dtypes/devices => the
                # install reuses the tick.
                engine.install_eps_params(_scale_matrices(params,
                                                          f.scale))
                self.log.append(f)
                self.corrupted.append({"pool": pool, "tick": tick,
                                       "scale": f.scale})
            return 0.0
        if f.kind == "tick-latency":
            self.log.append(f)
            return f.delay_s
        return 0.0

    def should_disconnect(self, accept_index: int) -> bool:
        """Whether the accept_index-th accepted request is scheduled for
        a mid-stream client disconnect (consumed once)."""
        if accept_index in self._disconnects:
            self._disconnects.discard(accept_index)
            self.log.append(Fault(kind="sse-disconnect",
                                  request_index=accept_index))
            return True
        return False

    def fired(self, kind: Optional[str] = None) -> int:
        """How many faults have fired (optionally of one kind)."""
        return sum(1 for f in self.log if kind is None or f.kind == kind)
