"""The port's fault-tolerant serving (``repro_torch.serving.resilience``)
against the JAX package's (``tests/test_resilience.py``, case for case).

Both packages run the same fault plans over the same requests on a
virtual clock (``pump(now=t)``), so breaker backoff and EDF order are
exact, on the CPU over the demo trunk (``repro/serving/fleet/sharded.py``
``trunk_apply``, and the port's
``repro_torch.serving.fleet.trunk_apply`` over the converted weights);
JAX's Pallas kernels run in interpret mode, the port's wrappers take
their plain versions.  Where x0 is compared, every
request starts from the same x_T in both packages, a k = 0
``SlotCheckpoint`` set on the accepted request; span checks draw x_T from
the seed instead (a k = 0 checkpoint logs a ``resume`` event that
``check_spans`` flags without a requeue).

Tolerances:
  * fault plans (``FaultPlan.seeded``, fault for fault), injector logs
    and poison / corruption audits, event kinds / request ids / steps /
    pools / codes / statuses, ``retry_after_s``, breaker states and
    trips, supervisor counters, span events and the key sets and values
    of ``health()``: exact.
  * x0: 1e-5 of max(|x0|, |x_T|), the engine-against-engine tolerance of
    ``test_torch_scheduler.py``; a resume against the port's own
    uninterrupted run: bitwise.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.core import make_schedule as j_make_schedule
from repro.kernels.sampler_step import ops as jops
from repro.obs import ListSink as JListSink
from repro.obs import Observability as JObs
from repro.obs import check_spans as j_check_spans
from repro.serving.errors import RequestError as JRequestError
from repro.serving.fleet import make_trunk_params, trunk_apply
from repro.serving.gateway import GatewayCore as JCore
from repro.serving.gateway import OverloadPolicy as JPolicy
from repro.serving.resilience import BreakerPolicy as JBreakerPolicy
from repro.serving.resilience import Fault as JFault
from repro.serving.resilience import FaultInjector as JInjector
from repro.serving.resilience import InjectedFault as JInjectedFault
from repro.serving.resilience import FaultPlan as JPlan
from repro.serving.resilience import PoolSupervisor as JSupervisor
from repro.serving.scheduler import SlotCheckpoint as JCk
from repro_torch.core import make_schedule
from repro_torch.obs import ListSink, Observability, check_spans
from repro_torch.obs.flight import detect_weight_corruption
from repro_torch.serving import (ContinuousBatchingEngine, PoolFleet,
                                 PoolState, RejectCode, RequestError,
                                 SampleRequest, SlotCheckpoint, SlotPool)
from repro_torch.serving.fleet import pick_pool
from repro_torch.serving.fleet import trunk_apply as t_trunk_apply
from repro_torch.serving.gateway import (EngineBridge, GatewayCore,
                                         OverloadPolicy)
from repro_torch.serving.resilience import (FAULT_KINDS, BreakerPolicy,
                                            BreakerState, CheckpointStore,
                                            Fault, FaultInjector, FaultPlan,
                                            InjectedFault, PoolSupervisor)

ENGINE_TOL_OF_SCALE = 1e-5
JSCH = j_make_schedule("linear", T=100)
TSCH = make_schedule("linear", T=100)
DIM, HIDDEN = 8, 32
J_PARAMS = make_trunk_params(JSCH, DIM, HIDDEN, seed=0)
T_PARAMS = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  J_PARAMS)
DT = 0.01


def _engine(slots=2, **kw):
    return ContinuousBatchingEngine(TSCH, t_trunk_apply, (DIM,), slots,
                                    eps_params=T_PARAMS, device="cpu", **kw)


def _plan_pair(faults):
    """(JAX, port) FaultPlans of the same (kind, **fields) tuples."""
    return (JPlan([JFault(kind=k, **kw) for k, kw in faults]),
            FaultPlan([Fault(kind=k, **kw) for k, kw in faults]))


def _freeze_tick_clock(core):
    """Seed every pool's tick EWMA at DT and freeze it (alpha 0).

    The least-loaded router ranks pools by backlog x tick EWMA, and
    ``retry_after_s`` reads the EWMA too.  Left live, the EWMA is each
    package's own wall-clock tick time even on the virtual clock, so under
    a loaded machine the two packages could route a requeued request to
    different pools."""
    for p in core.fleet.pools:
        p.engine.tick_ewma_s = DT
    return core


def _cores(pools=1, faults=None, breaker=None, supervise=True, obs=None,
           policy=None, **kw):
    """(JAX core, port core, JAX injector, port injector) on one model
    "m" with 2 slots per pool, on a frozen tick clock
    (``_freeze_tick_clock``)."""
    kw.setdefault("tick_ewma_alpha", 0.0)
    jinj = tinj = None
    if faults is not None:
        jp, tp = _plan_pair(faults)
        jinj, tinj = JInjector(jp), FaultInjector(tp)
    jobs, tobs = obs if obs is not None else (None, None)
    j = JCore.build(
        JSCH, trunk_apply, (DIM,), models={"m": J_PARAMS},
        pools_per_model=pools, slots=2, supervise=supervise, injector=jinj,
        breaker=(JBreakerPolicy(**breaker) if breaker else None), obs=jobs,
        policy=(JPolicy(**policy) if policy else None), **kw)
    t = GatewayCore.build(
        TSCH, t_trunk_apply, (DIM,), models={"m": T_PARAMS},
        pools_per_model=pools, slots=2, supervise=supervise, injector=tinj,
        breaker=(BreakerPolicy(**breaker) if breaker else None), obs=tobs,
        policy=(OverloadPolicy(**policy) if policy else None), device="cpu",
        **kw)
    return _freeze_tick_clock(j), _freeze_tick_clock(t), jinj, tinj


def _run(core, t=0.0, max_pumps=600):
    """Pump the core on a virtual clock until idle; returns final t."""
    n = 0
    while core.busy and n < max_pumps:
        core.pump(now=t)
        t += DT
        n += 1
    assert not core.busy, f"core still busy after {n} pumps"
    return t


def _x_T(seed):
    return np.random.RandomState(900 + seed).randn(DIM).astype(np.float32)


def _submit(core, events, t=0.0, x_T=True, **spec):
    """Submit a spec for model "m"; with ``x_T`` the request starts from
    ``_x_T(seed)`` as a k = 0 checkpoint in either package."""
    spec.setdefault("model", "m")
    rid = core.submit(spec, events.append, now=t)
    if x_T:
        rows = np.array(jops.to_slot_tile_layout(
            jnp.asarray(_x_T(spec.get("seed", 0)))[None])[0])
        core._requests[rid].resume = (
            JCk(request_id=rid, k=0, x_rows=rows, hist_rows=None)
            if isinstance(core, JCore) else
            SlotCheckpoint(request_id=rid, k=0, x_rows=torch.from_numpy(rows),
                           hist_rows=None))
    return rid


def _spans(sink):
    """A sink's span events, the builds' warm-up requests (ids < 0, on
    the wall clock) left out."""
    return [e for e in sink.events if e["req"] >= 0]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_events(tev, jev, seeds=None):
    """Equal event streams: x0 at tolerance (x_T of ``seeds[rid]``),
    every other field exact."""
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    for t, j in zip(tev, jev):
        assert set(t) == set(j), (t, j)
        for k in t:
            if k != "x0":
                assert t[k] == j[k], (k, t[k], j[k])
            elif seeds is not None:
                jx = _np(j[k])
                scale = max(np.abs(jx).max(),
                            np.abs(_x_T(seeds[t["request_id"]])).max())
                assert (np.abs(_np(t[k]) - jx).max()
                        <= ENGINE_TOL_OF_SCALE * scale)


# ----------------------------------------------------------- fault plans
def test_fault_kind_validation():
    assert FAULT_KINDS == ("tick-error", "nan-eps", "tick-latency",
                           "sse-disconnect", "corrupted-weights")
    for F in (JFault, Fault):
        with pytest.raises(ValueError, match="unknown fault kind"):
            F(kind="meteor-strike")


def test_fault_plan_rejects_colliding_cells():
    for F, P in ((JFault, JPlan), (Fault, FaultPlan)):
        with pytest.raises(ValueError, match="same \\(pool, tick\\)"):
            P([F(kind="tick-error", pool=1, tick=3),
               F(kind="nan-eps", pool=1, tick=3)])


SEEDED = {
    "default": dict(n_pools=3, horizon_ticks=40, n_disconnects=2,
                    n_requests=10),
    "corrupt": dict(n_pools=2, horizon_ticks=12, n_tick_errors=1, n_nan=2,
                    n_latency=1, n_corrupt=2, corrupt_scale=4.0,
                    latency_s=0.2, n_disconnects=3, n_requests=5),
    "dense-grid": dict(n_pools=1, horizon_ticks=6, n_tick_errors=2,
                       n_nan=1, n_latency=2, n_disconnects=0),
}


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_fault_plan_seeded_equals_jax_fault_for_fault(case):
    kw = SEEDED[case]
    for seed in (0, 7, 8, 123):
        want = JPlan.seeded(seed, **kw).faults
        got = FaultPlan.seeded(seed, **kw).faults
        assert ([dict(vars(f)) for f in got]
                == [dict(vars(f)) for f in want])
        assert got == FaultPlan.seeded(seed, **kw).faults
    assert FaultPlan.seeded(7, **kw).faults != FaultPlan.seeded(8, **kw).faults
    kinds = [f.kind for f in FaultPlan.seeded(7, **kw)]
    assert all(f.tick >= 1 for f in FaultPlan.seeded(7, **kw)
               if f.kind != "sse-disconnect")
    if case == "default":
        assert kinds.count("tick-error") == 2 and kinds.count("nan-eps") == 1


def test_fault_plan_seeded_refusals_equal_jax():
    for P in (JPlan, FaultPlan):
        with pytest.raises(ValueError, match="n_requests"):
            P.seeded(0, n_pools=2, horizon_ticks=10, n_disconnects=1)
        with pytest.raises(ValueError, match="won't fit"):
            P.seeded(0, n_pools=1, horizon_ticks=3, n_tick_errors=3)


def test_injector_fires_only_scheduled_cells():
    faults = [("tick-error", dict(pool=0, tick=2)),
              ("tick-latency", dict(pool=1, tick=1, delay_s=0.5))]
    jp, tp = _plan_pair(faults)
    logs = []
    for inj, Exc in ((JInjector(jp), JInjectedFault),
                     (FaultInjector(tp), InjectedFault)):
        inj.before_tick(0, 0)
        inj.before_tick(1, 2)                   # wrong pool: no raise
        assert inj.after_tick(1, 1, engine=None) == 0.5
        with pytest.raises(Exc) as ei:
            inj.before_tick(0, 2)
        assert ei.value.fault.pool == 0
        assert inj.fired() == 2 and inj.fired("tick-latency") == 1
        logs.append([dict(vars(f)) for f in inj.log])
    assert logs[0] == logs[1]


def test_injector_disconnect_consumed_once():
    for inj in (JInjector(JPlan([JFault(kind="sse-disconnect",
                                        request_index=3)])),
                FaultInjector(FaultPlan([Fault(kind="sse-disconnect",
                                               request_index=3)]))):
        assert not inj.should_disconnect(0)
        assert inj.should_disconnect(3)
        assert not inj.should_disconnect(3)     # consumed
        assert inj.fired("sse-disconnect") == 1


class _StandIn:
    """What the injector's post-tick faults touch on an engine."""

    def __init__(self, params, rows=(1, 256)):
        self.eps_params = params
        self.slot_rows_shape = rows
        self.written, self.installed = [], []

    def resident_requests(self):
        return [(1, SampleRequest(request_id=42))]

    def snapshot_slot(self, b):
        return SlotCheckpoint(request_id=42, k=5, x_rows=None,
                              hist_rows=None)

    def write_slot_rows(self, b, rows):
        self.written.append((b, rows))

    def install_eps_params(self, params):
        self.installed.append(params)


def test_nan_and_corruption_faults_touch_the_engine_as_jax():
    """nan-eps writes NaN rows into the first resident slot; corrupted-
    weights scales the ndim >= 2 leaves only (shape, dtype and device
    kept); the audits are JAX's."""
    faults = [("nan-eps", dict(pool=0, tick=1)),
              ("corrupted-weights", dict(pool=0, tick=2, scale=8.0))]
    out = []
    for inj, params in zip((JInjector(_plan_pair(faults)[0]),
                            FaultInjector(_plan_pair(faults)[1])),
                           (J_PARAMS, T_PARAMS)):
        eng = _StandIn(params)
        assert inj.after_tick(0, 1, eng) == 0.0
        assert inj.after_tick(0, 2, eng) == 0.0
        [(b, rows)] = eng.written
        assert b == 1 and np.isnan(np.asarray(rows)).all()
        assert np.asarray(rows).shape == (1, 256)
        [new] = eng.installed
        out.append((inj.poisoned, inj.corrupted, [f.kind for f in inj.log],
                    jax.tree_util.tree_map(_np, new)))
    (jp, jc, jl, jnew), (tp, tc, tl, tnew) = out
    assert (tp, tc, tl) == (jp, jc, jl)
    assert tp == [{"pool": 0, "tick": 1, "slot": 1, "request_id": 42,
                   "step": 5}]
    for (path, t), (_, j) in zip(
            jax.tree_util.tree_flatten_with_path(tnew)[0],
            jax.tree_util.tree_flatten_with_path(jnew)[0]):
        assert np.array_equal(t, j), path
    new = FaultInjector(_plan_pair(faults)[1])
    eng = _StandIn(T_PARAMS)
    new.after_tick(0, 2, eng)
    w = eng.installed[0]["trunk"]
    assert torch.equal(w["wq"], T_PARAMS["trunk"]["wq"] * 8.0)
    assert w["time_w"] is T_PARAMS["trunk"]["time_w"]
    assert eng.installed[0]["alpha_bar"] is T_PARAMS["alpha_bar"]


def test_checkpoint_store_latest_wins_and_forgets():
    st = CheckpointStore()
    st.put(SlotCheckpoint(request_id=1, k=2, x_rows=None, hist_rows=None))
    st.put(SlotCheckpoint(request_id=1, k=5, x_rows=None, hist_rows=None))
    assert st.latest(1).k == 5 and len(st) == 1 and st.taken == 2
    st.forget(1)
    assert st.latest(1) is None and len(st) == 0
    st.put(SlotCheckpoint(request_id=2, k=1, x_rows=None, hist_rows=None))
    st.clear()
    assert len(st) == 0 and st.taken == 3


# ------------------------------------------- engine: checkpoint / resume
def test_snapshot_resume_is_bit_identical():
    def req():
        rows = torch.from_numpy(np.array(jops.to_slot_tile_layout(
            jnp.asarray(_x_T(4))[None])[0]))
        return SampleRequest(request_id=0, S=8, seed=4, resume=SlotCheckpoint(
            request_id=0, k=0, x_rows=rows, hist_rows=None))
    ref = _engine().serve([req()])[0]
    a = _engine()
    a.submit(req(), now=0.0)
    for i in range(3):
        a.tick(now=i * DT)
    b, _ = a.resident_requests()[0]
    ck = a.snapshot_slot(b, now=3 * DT)
    assert ck.k == 3
    [r] = a.evict_residents()
    assert a.active == 0
    r.resume = ck
    out = _engine().serve([r])[0]
    assert torch.equal(out.x0, ref.x0) and out.S == 8
    # and the uninterrupted run is JAX's
    jeng_events = []
    j, _, _, _ = _cores(pools=1)
    _submit(j, jeng_events, S=8, seed=4)
    _run(j)
    _same_events([{"event": "result", "request_id": 0, "x0": ref.x0}],
                 [{"event": "result", "request_id": 0,
                   "x0": jeng_events[0]["x0"]}], seeds={0: 4})


def test_resume_rejects_out_of_range_k():
    eng = _engine()
    bad = SampleRequest(request_id=1, S=4, seed=0)
    bad.resume = SlotCheckpoint(request_id=1, k=4, x_rows=None,
                                hist_rows=None)
    eng.submit(bad, now=0.0)
    with pytest.raises(ValueError, match="outside"):
        eng.tick(now=0.0)


def test_engine_cancel_frees_slot_and_counts():
    eng = _engine()
    eng.submit(SampleRequest(request_id=5, S=10, seed=0), now=0.0)
    eng.tick(now=0.0)
    assert eng.active == 1
    assert eng.cancel(5, now=DT)
    assert eng.active == 0 and eng.capacity == eng.slots
    assert not eng.cancel(5, now=DT)            # idempotent
    assert eng.stats()["cancelled"] == 1
    res = eng.serve([SampleRequest(request_id=6, S=4, seed=1)])
    assert len(res) == 1 and not res[0].dropped


# ------------------------------------------- supervisor: quarantine path
def _sup_view(core):
    st = core.supervisor.stats()
    return {k: v for k, v in st.items()}


def test_quarantine_contains_fault_and_work_completes_elsewhere():
    j, t, jinj, tinj = _cores(
        pools=2, faults=[("tick-error", dict(pool=0, tick=3))],
        checkpoint_every=1, breaker=dict(backoff_pumps=2, probe_ticks=1))
    got = []
    for core in (j, t):
        events = []
        for i in range(4):
            _submit(core, events, S=8, seed=i)
        _run(core)
        got.append((events, _sup_view(core)))
    (jev, jsup), (tev, tsup) = got
    _same_events(tev, jev, seeds={i: i for i in range(4)})
    assert [e["event"] for e in tev] == ["result"] * 4
    jsup["breakers"] = {p: dict(b, last_error=None)
                        for p, b in jsup["breakers"].items()}
    last = {p: b["last_error"] for p, b in tsup["breakers"].items()}
    tsup["breakers"] = {p: dict(b, last_error=None)
                        for p, b in tsup["breakers"].items()}
    assert tsup == jsup
    assert tsup["quarantines"] == 1 and tinj.fired("tick-error") == 1
    assert tsup["migrated"] + tsup["restarted"] >= 1
    assert "InjectedFault" in last[0]
    assert any(e["pool_id"] == 1 for e in tev)


def test_quarantine_spans_are_clean():
    """The same quarantine with x_T drawn from the seed: every span
    (requeue, resume on the surviving pool) passes check_spans."""
    o = Observability()
    sink = o.add_sink(ListSink())
    _, t, _, tinj = _cores(
        pools=2, faults=[("tick-error", dict(pool=0, tick=3))],
        checkpoint_every=1, breaker=dict(backoff_pumps=2, probe_ticks=1),
        obs=(None, o))
    events = []
    for i in range(4):
        _submit(t, events, S=8, seed=i, x_T=False)
    _run(t)
    assert [e["event"] for e in events] == ["result"] * 4
    assert tinj.fired("tick-error") == 1
    assert check_spans(sink.events) == j_check_spans(sink.events) == []
    assert any(e["ev"] == "resume" for e in sink.events)


def test_supervised_happy_path_matches_unsupervised():
    outs = []
    for supervise in (False, True):
        j, t, _, _ = _cores(pools=1, supervise=supervise)
        got = []
        for core in (j, t):
            events = []
            _submit(core, events, S=6, seed=9)
            _run(core)
            got.append(events)
            assert (core.stats()["resilience"] is None) == (not supervise)
        _same_events(got[1], got[0], seeds={0: 9})
        outs.append(got[1][0]["x0"])
    assert torch.equal(outs[0], outs[1])


def test_breaker_backoff_probe_and_close():
    j, t, _, _ = _cores(pools=1, faults=[("tick-error", dict(pool=0,
                                                             tick=0))],
                        breaker=dict(backoff_pumps=2, probe_ticks=1))
    got = []
    for core, Err in ((j, JRequestError), (t, RequestError)):
        sup = core.supervisor
        events = []
        _submit(core, events, S=4, seed=0)
        core.pump(now=0.0)                # first busy tick -> quarantine
        br = sup.breaker(0)
        assert br.state.value == "open" and br.trips == 1
        assert core.fleet.pools[0].state.value == "quarantined"
        assert core.fleet.pools[0].health < 1.0
        with pytest.raises(Err) as ei:
            _submit(core, [], S=4, seed=1, t=DT)
        refusal = (ei.value.code.value, ei.value.status,
                   ei.value.retry_after_s)
        _run(core, t=DT)
        got.append((events, refusal, br.state.value, sup.stats()["probes"],
                    core.fleet.pools[0].state.value))
    _same_events(got[1][0], got[0][0], seeds={0: 0})
    assert got[1][1:] == got[0][1:]
    assert got[1][1][:2] == (RejectCode.MODEL_UNAVAILABLE.value, 503)
    assert got[1][1][2] >= 1
    assert got[1][2:] == (BreakerState.CLOSED.value, 1,
                          PoolState.ACTIVE.value)


def _fleet(n_pools):
    return PoolFleet([SlotPool(i, _engine()) for i in range(n_pools)])


def test_backoff_grows_exponentially_and_caps():
    pol = dict(backoff_pumps=4, backoff_factor=2.0, max_backoff_pumps=24)
    sup = PoolSupervisor(_fleet(1), policy=BreakerPolicy(**pol))
    jsup = JSupervisor.__new__(JSupervisor)
    jsup.policy = JBreakerPolicy(**pol)
    assert [sup._backoff(n) for n in (1, 2, 3, 4, 5)] == [
        jsup._backoff(n) for n in (1, 2, 3, 4, 5)] == [4, 8, 16, 24, 24]
    assert BreakerPolicy() == BreakerPolicy(**vars(JBreakerPolicy()))


def test_router_health_weights_choice():
    fleet = _fleet(2)
    fleet.pools[0].health = 0.1
    pool = pick_pool(fleet.pools, SampleRequest(request_id=0, S=4))
    assert pool.pool_id == 1                    # unhealthy pool avoided
    for key in range(8):
        req = SampleRequest(request_id=1, S=4, affinity_key=key)
        assert pick_pool(fleet.pools, req).pool_id == 1


# -------------------------------------------------- gateway: guard rails
def test_nan_guard_turns_garbage_into_typed_5xx():
    j, t, jinj, tinj = _cores(pools=1, faults=[("nan-eps", dict(pool=0,
                                                                tick=1))])
    got = []
    for core, inj in ((j, jinj), (t, tinj)):
        events = []
        _submit(core, events, S=6, seed=0)
        _run(core)
        got.append((events, core.stats()["nonfinite"], inj.poisoned))
    _same_events(got[1][0], got[0][0], seeds={0: 0})
    events = got[1][0]
    assert events[-1]["event"] == "error"
    assert (events[-1]["code"], events[-1]["status"]) == (
        "nonfinite-sample", 500)
    assert len(events) == 1 and "x0" not in events[0]
    assert got[1][1:] == got[0][1:] and got[1][1] == 1


def test_cancel_mid_trajectory_frees_slot_and_spans():
    jo, to = JObs(), Observability()
    jsink, tsink = jo.add_sink(JListSink()), to.add_sink(ListSink())
    j, t, _, _ = _cores(pools=1, obs=(jo, to))
    got = []
    for core in (j, t):
        events = []
        rid = _submit(core, events, S=12, seed=0, preview_every=1,
                      x_T=False)
        now = 0.0
        for _ in range(4):
            core.pump(now=now)
            now += DT
        assert core.fleet.active == 1
        assert core.cancel(rid, now=now)
        assert core.fleet.active == 0
        _run(core, t=now)
        assert not core.cancel(rid, now=now)
        got.append(([(e["event"], e["step"]) for e in events],
                    core.stats()["cancelled"]))
    assert got[1] == got[0]
    assert all(k == "preview" for k, _ in got[1][0])
    assert got[1][1] == 1
    assert _spans(tsink) == _spans(jsink)
    assert [e["ev"] for e in tsink.events if e["req"] == 0][-1] == "cancel"
    assert check_spans(tsink.events) == []


def test_queue_full_refusal_carries_retry_after():
    j, t, _, _ = _cores(pools=1, max_queue=2)
    got = []
    for core in (j, t):
        for i in range(2):
            _submit(core, [], S=4, seed=i)
        with pytest.raises(ValueError) as ei:
            _submit(core, [], S=4, seed=9)
        e = ei.value
        got.append((e.code.value, e.status, e.retry_after_s,
                    e.payload()))
    assert got[1] == got[0]
    assert got[1][:2] == ("queue-full", 429)
    assert isinstance(got[1][2], int) and got[1][2] >= 1
    assert got[1][3]["retry_after_s"] == got[1][2]


def test_shed_events_carry_retry_after():
    j, t, _, _ = _cores(pools=1, policy=dict(shed_depth=1, margin=0.0))
    got = []
    for core in (j, t):
        events = []
        for i in range(4):                      # deadline-free pile-up
            _submit(core, events, S=4, seed=i)
        _run(core)
        got.append(events)
    _same_events(got[1], got[0], seeds={i: i for i in range(4)})
    errs = [e for e in got[1] if e["event"] == "error"]
    assert errs and all(e["code"].startswith("shed-") for e in errs)
    assert all(e["retry_after_s"] >= 1 for e in errs)


def _degraded_then_ok():
    """Three requests on two pools; pool 0 faults at its tick 1 and is
    quarantined, then re-admitted: health() while degraded and after, and
    the event streams, held against JAX's."""
    j, t, _, _ = _cores(pools=2, faults=[("tick-error", dict(pool=0,
                                                             tick=1))],
                        breaker=dict(backoff_pumps=1, probe_ticks=1))
    got = []
    for core in (j, t):
        events = []
        for i in range(3):
            _submit(core, events, S=6, seed=i)
        now = 0.0
        while core.supervisor.stats()["quarantines"] == 0 and now < 1.0:
            core.pump(now=now)
            now += DT
        degraded = core.health()
        _run(core, t=now)
        got.append((degraded, core.health(), events))
    (jdeg, jok, jev), (tdeg, tok, tev) = got
    assert set(tdeg) == set(jdeg) and set(tok) == set(jok)
    assert tdeg["status"] == jdeg["status"] == "degraded"
    assert tdeg["quarantined"][0]["pool"] == 0
    assert "InjectedFault" in tdeg["quarantined"][0]["last_error"]
    assert [dict(q, last_error=None) for q in tdeg["quarantined"]] == [
        dict(q, last_error=None) for q in jdeg["quarantined"]]
    for k in ("pools", "queue_depth", "absorbed_pump_errors"):
        assert tdeg[k] == jdeg[k] and tok[k] == jok[k], k
    assert {p["state"] for p in tdeg["pools"]} >= {"quarantined"}
    assert tok == jok and tok["status"] == "ok"
    # request 0 is evicted before the first checkpoint sweep and restarts
    # from step 0 with x_T drawn from its seed; the events are compared
    # here, the x0 of a seeded request in tests/test_torch_draws.py
    _same_events(tev, jev)
    assert len([e for e in tev if e["event"] == "result"]) == 3


def test_healthz_degraded_detail_then_recovers():
    _degraded_then_ok()


class _SkewedClock:
    """A ``time`` module whose perf_counter advances by a seeded random
    step (1 us to 0.5 s) at every reading."""

    def __init__(self, seed):
        self._t = 0.0
        self._rs = np.random.RandomState(seed)

    def perf_counter(self):
        self._t += self._rs.uniform(1e-6, 0.5)
        return self._t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.mark.parametrize("seed", [0, 10, 11])
def test_two_pool_replay_ignores_wall_clock_tick_times(seed, monkeypatch):
    """The port's engines measure arbitrary tick times while JAX's measure
    real ones: the virtual-clock replay still routes, degrades and
    recovers as JAX's does, because the tick EWMA the router ranks pools
    by is frozen in this file's cores.  (A live EWMA made
    test_healthz_degraded_detail_then_recovers fail under load.)"""
    import repro_torch.serving.scheduler.engine as tengine
    monkeypatch.setattr(tengine, "time", _SkewedClock(seed))
    _degraded_then_ok()


# ------------------------------------------------ requeue under hot swap
def test_requeue_under_drain_during_hot_swap():
    jo, to = JObs(), Observability()
    jsink, tsink = jo.add_sink(JListSink()), to.add_sink(ListSink())
    j, t, _, _ = _cores(pools=1, obs=(jo, to))
    got = []
    for core, params in ((j, J_PARAMS), (t, T_PARAMS)):
        events = []
        rids = [_submit(core, events, S=4, seed=i, deadline_s=100.0 + i,
                        x_T=False) for i in range(4)]
        q = core.fleet.queue
        assert q.submitted == 4
        stamps = {r.request_id: r.submit_t for r in q.pending_requests()}
        core.fleet.dispatch(0.0)
        assert len(q) == 2 and len(core.fleet.pools[0].engine.queue) == 2
        core.hot_swap("m", params, now=0.0)
        assert q.submitted == 4
        pend = q.pending_requests()
        assert [r.request_id for r in pend] == rids
        assert {r.request_id: r.submit_t for r in pend} == stamps
        _run(core)
        got.append(([e["event"] for e in events], core.swapping,
                    core.stats()["swaps"]))
    assert got[1] == got[0] == (["result"] * 4, None, 1)
    assert _spans(tsink) == _spans(jsink)
    assert check_spans(tsink.events) == []


def test_rollout_completes_when_draining_pool_quarantines():
    j, t, _, _ = _cores(pools=2, faults=[("tick-error", dict(pool=0,
                                                             tick=2))],
                        checkpoint_every=1,
                        breaker=dict(backoff_pumps=4, probe_ticks=1))
    got = []
    for core, params in ((j, J_PARAMS), (t, T_PARAMS)):
        events = []
        for i in range(3):
            _submit(core, events, S=8, seed=i)
        core.pump(now=0.0)
        core.hot_swap("m", params, now=DT)      # pool 0 starts draining
        _run(core, t=2 * DT)
        got.append((events, core.swapping, core.stats()["swaps"],
                    core.supervisor.stats()["quarantines"]))
    _same_events(got[1][0], got[0][0], seeds={i: i for i in range(3)})
    assert [e["event"] for e in got[1][0]] == ["result"] * 3
    assert got[1][1:] == got[0][1:]
    assert got[1][1] is None and got[1][2] == 1 and got[1][3] >= 1


# --------------------------------- corrupted weights and the flight ring
def test_corrupted_weights_keep_ticks_and_are_attributed():
    """A corrupted-weights fault on a probed pool: same tick function,
    every sample finite, and the pool's flight frames name it (the scale
    and detection factor of the JAX package's chaos replay, which move
    the demo trunk's eps_rms past its tanh saturation)."""
    _, t, _, tinj = _cores(
        pools=2, faults=[("corrupted-weights", dict(pool=1, tick=2,
                                                    scale=64.0))],
        probes=True)
    events = []
    for i in range(4):
        _submit(t, events, S=8, seed=i)
    _run(t)
    pool = t.fleet.pools[1]
    assert tinj.corrupted == [{"pool": 1, "tick": 2, "scale": 64.0}]
    assert pool.engine.stats()["compiled_ticks"] == 1
    assert pool.weight_swaps == 1
    assert [e["event"] for e in events] == ["result"] * 4
    assert all(torch.isfinite(e["x0"]).all() for e in events)
    hit = detect_weight_corruption(t.flight_snapshot(1)["frames"],
                                   factor=2.0)
    assert hit is not None and hit["pool"] == 1
    assert detect_weight_corruption(t.flight_snapshot(0)["frames"],
                                    factor=2.0) is None


# ------------------------------------------------ bridge survivability
def _await(pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached")
        time.sleep(0.01)


def test_bridge_survives_pump_fault_when_supervised():
    _, core, _, _ = _cores(pools=1)
    boom = {"armed": True}
    orig = core.pump

    def pump(now=None):
        if boom.pop("armed", False):
            raise RuntimeError("transient gateway-tier fault")
        return orig(now)

    core.pump = pump
    bridge = EngineBridge(core, idle_s=0.005).start()
    try:
        done = threading.Event()
        results = []

        def on_event(ev):
            results.append(ev)
            done.set()

        bridge.call(core.submit, {"model": "m", "S": 4},
                    on_event).result(10)
        _await(done.is_set)
        assert bridge.error is None             # absorbed, not poisoned
        assert results[0]["event"] == "result"
        assert core.health()["absorbed_pump_errors"] == 1
    finally:
        bridge.stop()


def test_bridge_poisons_without_supervisor():
    _, core, _, _ = _cores(pools=1, supervise=False)
    core.pump = lambda now=None: (_ for _ in ()).throw(
        RuntimeError("fatal"))
    bridge = EngineBridge(core, idle_s=0.005).start()
    try:
        bridge.call(core.submit, {"model": "m", "S": 4},
                    lambda ev: None).result(10)
        _await(lambda: bridge.error is not None)
        with pytest.raises(RuntimeError, match="engine thread failed"):
            bridge.call(core.stats)
    finally:
        bridge.stop()


# -------------------------------------------------- span segment checks
def _ev(req, kind, t, **kw):
    return dict({"ev": kind, "t": t, "req": req}, **kw)


SPAN_CASES = {
    "requeue-resets-segment": (
        [_ev(1, "submit", 0), _ev(1, "route", 1), _ev(1, "requeue", 2),
         _ev(1, "route", 3), _ev(1, "admit", 4), _ev(1, "resume", 4),
         _ev(1, "first_tick", 5), _ev(1, "retire", 6)], None),
    "out-of-order-in-segment": (
        [_ev(2, "submit", 0), _ev(2, "admit", 1), _ev(2, "route", 2),
         _ev(2, "retire", 3)], "out-of-order"),
    "resume-without-requeue": (
        [_ev(3, "submit", 0), _ev(3, "route", 1), _ev(3, "admit", 2),
         _ev(3, "resume", 2), _ev(3, "retire", 3)], "resume without"),
    "cancel-is-terminal": ([_ev(4, "submit", 0), _ev(4, "cancel", 1)],
                           None),
    "event-after-terminal": (
        [_ev(4, "submit", 0), _ev(4, "cancel", 1), _ev(4, "retire", 2)],
        "terminal"),
}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_check_spans_segments_equal_jax(case):
    events, needle = SPAN_CASES[case]
    got = check_spans(events)
    assert got == j_check_spans(events)
    if needle is None:
        assert got == []
    else:
        assert any(needle in e for e in got)
