"""The port's slot-pool fleet (``repro_torch.serving.fleet``) against the
JAX package's.

Both fleets serve the same requests on a virtual clock on the CPU, with
the analytic eps model of ``test_torch_scheduler.py`` (eps = x * f[t]) and
the same x_T (``SampleRequest(resume=SlotCheckpoint(k=0, ...))``); the JAX
pools run their Pallas kernels in interpret mode, the port's their plain
versions.  The routers see the same pool loads and healths through stand-in
pool objects.

Tolerances: routing decisions, pool assignments, span events, reject
codes and the counters of ``stats()``: exact.  Per request x0: 1e-5 of
max(|x0|, |x_T|), the engine-against-engine tolerance of
``test_torch_scheduler.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import obs as jobs
from repro.autoplan import PlanBank as JBank
from repro.core import make_schedule as j_make_schedule
from repro.kernels.sampler_step import ops as jops
from repro.sampling import SamplerPlan as JPlan
from repro.sampling import TauSpec as JTau
from repro.serving.errors import RejectCode as JRejectCode
from repro.serving.errors import RequestError as JRequestError
from repro.serving.fleet import PoolFleet as JFleet
from repro.serving.fleet import affinity_pool as j_affinity_pool
from repro.serving.fleet import pick_pool as j_pick_pool
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import SampleRequest as JReq
from repro.serving.scheduler import SlotCheckpoint as JCk
from repro_torch import obs
from repro_torch.autoplan import PlanBank
from repro_torch.core import make_schedule
from repro_torch.obs.schema import FLEET_STATS_KEYS, POOL_STATS_KEYS
from repro_torch.sampling import SamplerPlan
from repro_torch.sampling.specs import TauSpec
from repro_torch.serving import (ContinuousBatchingEngine, PoolFleet,
                                 PoolState, RejectCode, RequestError,
                                 SampleRequest, SlotCheckpoint, SlotPool)
from repro_torch.serving.fleet import (AFFINITY_HEALTH_MIN, affinity_pool,
                                       pick_pool)

ENGINE_TOL_OF_SCALE = 1e-5
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)
SHAPE = (7, 23)


def _eps_pair():
    a = TSCH.alpha_bar.double().numpy()
    f = (np.sqrt(1 - a) / (1 - a + a * 0.25)).astype(np.float32)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)

    def jeps(x, t):
        return x * jf[t].reshape((-1,) + (1,) * (x.ndim - 1))

    def teps(x, t):
        return x * tf[t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
    return jeps, teps


def _x(rid):
    return np.random.RandomState(700 + rid).randn(1, *SHAPE).astype(
        np.float32)


def _requests(spec, J: bool):
    """(rid, S, eta, deadline, affinity_key) rows -> requests, same x_T."""
    R, Ck = (JReq, JCk) if J else (SampleRequest, SlotCheckpoint)
    out = []
    for rid, S, eta, dl, key in spec:
        rows = np.array(jops.to_slot_tile_layout(jnp.asarray(_x(rid)))[0])
        out.append(R(request_id=rid, S=S, eta=eta, seed=rid, deadline=dl,
                     affinity_key=key,
                     resume=Ck(request_id=rid, k=0, hist_rows=None,
                               x_rows=rows if J else torch.from_numpy(rows))))
    return out


# ------------------------------------------------------------------ router
class _Pool:
    """Stand-in for a SlotPool: what the routers read."""

    def __init__(self, pool_id, capacity, health, ewma, backlog, model):
        self.pool_id, self.capacity, self.health = pool_id, capacity, health
        self.tick_ewma_s, self._backlog, self.model = ewma, backlog, model

    def load_eta_s(self, default_tick_s=0.0):
        tick = (self.tick_ewma_s if self.tick_ewma_s is not None
                else default_tick_s)
        return self._backlog * tick


def test_router_decisions_equal_jax():
    rs = np.random.RandomState(0)
    reasons = set()
    for trial in range(400):
        n = int(rs.randint(1, 5))
        pools = [_Pool(i, int(rs.randint(0, 3)),
                       float(rs.choice([1.0, 1.0, 0.3, 0.6])),
                       None if rs.rand() < 0.3 else float(rs.uniform(1e-3, 1)),
                       float(rs.randint(0, 40)),
                       None if trial % 3 else ("a", "b")[i % 2])
                 for i in range(n)]
        key = (None if rs.rand() < 0.4
               else (int(rs.randint(100)), f"user-{rs.randint(9)}")[
                   trial % 2])
        model = None if trial % 3 else ("a", "b")[trial % 2]
        req = SampleRequest(request_id=trial, affinity_key=key, model=model)
        got = pick_pool(pools, req, explain=True)
        want = j_pick_pool(pools, req, explain=True)
        assert (got[0] is want[0]) and got[1] == want[1], trial
        assert pick_pool(pools, req) is got[0]
        reasons.add(got[1])
    assert reasons == {"affinity", "least-loaded", "full"}
    for key in list(range(50)) + ["s", ("t", 3), 2 ** 40]:
        for n in (1, 2, 3, 7):
            assert affinity_pool(key, n) == j_affinity_pool(key, n)
    from repro.serving.fleet.router import AFFINITY_HEALTH_MIN as J_MIN
    assert AFFINITY_HEALTH_MIN == J_MIN


# ------------------------------------------------ fleet against JAX fleet
FLEET_SPEC = [  # (rid, S, eta, deadline, affinity_key)
    (0, 4, 0.0, None, None), (1, 6, 1.0, None, 3), (2, 3, 0.0, 0.35, None),
    (3, 5, 0.0, None, 3), (4, 2, 1.0, None, None), (5, 7, 0.0, 3.0, 8),
    (6, 3, 0.0, None, None), (7, 4, 1.0, 0.15, None), (8, 5, 0.0, None, 8),
    (9, 3, 0.0, None, None),
]


def _fleets(n_pools=2, slots=2, **kw):
    jeps, teps = _eps_pair()
    jo, to = jobs.Observability(), obs.Observability()
    js, ts = jo.add_sink(jobs.ListSink()), to.add_sink(obs.ListSink())
    jf = JFleet.build(JSCH, jeps, SHAPE, n_pools=n_pools, slots=slots,
                      obs=jo, **kw)
    tf = PoolFleet.build(TSCH, teps, SHAPE, n_pools=n_pools, slots=slots,
                         obs=to, device="cpu", **kw)
    return (jf, js), (tf, ts)


def _drive(fleet, reqs, drain_at=None, restore_at=None):
    """First half submitted at 0, the rest at 0.3; at ``drain_at`` a pool
    that was just dispatched work it has not admitted is drained (so it
    hands that work back), and restored at ``restore_at``; returns results
    by id."""
    res, now, late, drained = {}, 0.0, reqs[len(reqs) // 2:], 1
    for r in reqs[:len(reqs) // 2]:
        fleet.submit(r, now=now)
    while fleet.busy or late:
        if now >= 0.3 and late:
            for r in late:
                fleet.submit(r, now=now)
            late = []
        if drain_at is not None and abs(now - drain_at) < 1e-9:
            res.update((r.request_id, r) for r in fleet.dispatch(now))
            drained = next((p.pool_id for p in fleet.pools
                            if len(p.engine.queue)), 1)
            fleet.drain_pool(drained, now=now)
        if restore_at is not None and abs(now - restore_at) < 1e-9:
            fleet.restore_pool(drained)
        now = round(now + 0.1, 9)
        res.update((r.request_id, r) for r in fleet.tick(now=now))
    return res


COUNTERS = ("n_pools", "queued", "queue_rejected", "completed", "dropped",
            "drained_requests", "ticks", "slot_steps", "occupancy",
            "mega_tick_ratio")


@pytest.mark.parametrize("drain", [False, True], ids=["plain", "drain"])
def test_fleet_matches_jax_fleet_on_virtual_clock(drain):
    (jf, js), (tf, ts) = _fleets(stochastic=True, max_queue=9)
    kw = dict(drain_at=0.3, restore_at=0.7) if drain else {}
    jres = _drive(jf, _requests(FLEET_SPEC, J=True), **kw)
    tres = _drive(tf, _requests(FLEET_SPEC, J=False), **kw)
    assert sorted(tres) == sorted(jres) == [s[0] for s in FLEET_SPEC]
    for rid, j in jres.items():
        t = tres[rid]
        assert (t.pool_id, t.S, t.dropped, t.deadline_missed, t.admit_t,
                t.finish_t) == (j.pool_id, j.S, j.dropped, j.deadline_missed,
                                j.admit_t, j.finish_t), rid
        if j.x0 is not None:
            scale = max(np.abs(j.x0).max(), np.abs(_x(rid)).max())
            assert (np.abs(t.x0.numpy() - np.asarray(j.x0)).max()
                    <= ENGINE_TOL_OF_SCALE * scale), rid
    jst, tst = jf.stats(), tf.stats()
    for key in COUNTERS:
        assert tst[key] == jst[key], key
    for tp, jp in zip(tst["pools"], jst["pools"]):
        for key in ("pool_id", "state", "ticks", "completed", "dropped",
                    "slot_steps", "drained_requests", "compiled_ticks",
                    "weight_swaps", "health", "pending_steps"):
            assert tp[key] == jp[key], key
    assert ts.events == js.events
    # each request is handed its x_T as a k = 0 checkpoint, which the
    # engines log as a ``resume``; without those the spans are clean
    spans = [e for e in ts.events if e["ev"] != "resume"]
    assert len(spans) < len(ts.events)
    assert obs.check_spans(spans) == jobs.check_spans(spans) == []
    assert {r.pool_id for r in tres.values() if not r.dropped} == {0, 1}
    assert sum(r.dropped for r in tres.values()) >= 1
    requeued = obs.ordering(ts.events, "requeue")
    if drain:
        assert requeued and tst["drained_requests"] == len(requeued)
        assert requeued == jobs.ordering(js.events, "requeue")
        assert all(p.state is PoolState.ACTIVE for p in tf.pools)
    else:
        assert not requeued


def test_fleet_stats_keys_prometheus_and_reset():
    (_, _), (tf, _) = _fleets(probes=True, stochastic=True)
    tf.serve(_requests(FLEET_SPEC[:6], J=False), now=0.0)
    st = tf.stats()
    assert set(st) == FLEET_STATS_KEYS
    assert all(set(p) == POOL_STATS_KEYS for p in st["pools"])
    assert all(p.engine.flight is not None for p in tf.pools)
    text = tf.render_prometheus()
    for needle in ('pool="0"', 'pool="1"', 'tier="fleet"',
                   "engine_tick_seconds_bucket{", "queue_depth{",
                   "engine_probe_frames_total{"):
        assert needle in text, needle
    assert text.count("# TYPE engine_tick_seconds histogram") == 1
    assert obs.render_dashboard(st).count("\n") == 2 + 2 + 2 - 1
    tf.reset_stats()
    st = tf.stats()
    assert st["completed"] == 0 and st["ticks"] == 0
    assert all(p["compiled_ticks"] == 1 for p in st["pools"])


def test_heterogeneous_pools_raise_and_refusal_codes_match_jax():
    _, teps = _eps_pair()
    e1 = ContinuousBatchingEngine(TSCH, teps, SHAPE, 2, device="cpu")
    e2 = ContinuousBatchingEngine(TSCH, teps, SHAPE, 2, stochastic=True,
                                  device="cpu")
    with pytest.raises(ValueError, match="homogeneous"):
        PoolFleet([SlotPool(0, e1), SlotPool(1, e2)])
    with pytest.raises(ValueError, match="at least one pool"):
        PoolFleet([])
    (jf, _), (tf, _) = _fleets(n_pools=1, slots=1, max_queue=2)
    spec = [(20 + i, 3, 0.0, None, None) for i in range(5)]
    jres = jf.serve(_requests(spec, J=True), now=0.0)
    tres = tf.serve(_requests(spec, J=False), now=0.0)
    assert ([(r.request_id, r.dropped) for r in tres]
            == [(r.request_id, r.dropped) for r in jres])
    assert tf.stats()["queue_rejected"] == jf.stats()["queue_rejected"] == 3
    cases = [lambda R: R(request_id=90, S=4, eta=0.5),
             lambda R: R(request_id=91, S=0),
             lambda R: R(request_id=92, S=4, model="nope")]
    for make in cases:
        with pytest.raises(JRequestError) as je:
            jf.submit(make(JReq), now=0.0)
        with pytest.raises(RequestError) as te:
            tf.submit(make(SampleRequest), now=0.0)
        assert te.value.code.name == je.value.code.name
        assert te.value.status == je.value.status
    for f in (jf, tf):
        f.pools[0].quarantine()
    with pytest.raises(JRequestError) as je:
        jf.submit(JReq(request_id=93, S=4), now=0.0)
    with pytest.raises(RequestError) as te:
        tf.submit(SampleRequest(request_id=93, S=4), now=0.0)
    assert te.value.code is RejectCode.MODEL_UNAVAILABLE
    assert je.value.code is JRejectCode.MODEL_UNAVAILABLE


def test_pool_lifecycle_and_install_gate():
    _, teps = _eps_pair()

    def eps(params, x, t):
        return teps(x, t) * params["g"]
    params = {"g": torch.tensor(1.0)}
    fleet = PoolFleet.build(TSCH, eps, SHAPE, n_pools=2, slots=2,
                            eps_params=params, device="cpu")
    pool = fleet.pools[1]
    with pytest.raises(RuntimeError, match="STOPPED"):
        pool.install({"g": torch.tensor(2.0)})
    for r in _requests(FLEET_SPEC[:4], J=False):
        r.eta, r.deadline = 0.0, None
        fleet.submit(r, now=0.0)
    fleet.dispatch(0.0)
    assert fleet.drain_pool(1, now=0.0) >= 0
    assert pool.state in (PoolState.DRAINING, PoolState.STOPPED)
    fleet.run(now_fn=lambda: 1.0)
    assert pool.state is PoolState.STOPPED and not pool.busy
    n = pool.stats()["compiled_ticks"]
    pool.install({"g": torch.tensor(2.0)})
    assert pool.weight_swaps == 1 and pool.stats()["compiled_ticks"] == n
    pool.quarantine()
    assert pool.state is PoolState.QUARANTINED and pool.capacity == 0
    pool.install({"g": torch.tensor(1.0)})
    fleet.restore_pool(1)
    assert pool.accepting and pool.weight_swaps == 2
    assert pool.stats()["state"] == "active"
    with pytest.raises(RuntimeError, match="non-active"):
        fleet.pools[0].drain()
        fleet.pools[0].dispatch(SampleRequest(request_id=50), 0.0)


def _banks():
    out = []
    for Bank, Plan, Tau, sch in ((JBank, JPlan, JTau, JSCH),
                                 (PlanBank, SamplerPlan, TauSpec, TSCH)):
        bank = Bank(sch)
        for S in (4, 32):
            taus = sorted(set(np.linspace(1, sch.T, S).astype(int).tolist()))
            bank.add_plan(Plan.build(sch, tau=Tau.explicit(taus)))
        out.append(bank)
    return out


def test_auto_plan_uses_destination_pool_ewma():
    """A fast and a slow pool pick different bank rows for one deadline:
    selection runs at the destination pool's pop with its own EWMA."""
    jbank, tbank = _banks()
    (jf, _), (tf, _) = _fleets(plan_bank=None, tick_ewma_alpha=0.0)
    got = []
    for fleet, bank, R in ((jf, jbank, JReq), (tf, tbank, SampleRequest)):
        for p in fleet.pools:
            p.engine.plan_bank = bank
        fleet.pools[0].engine.tick_ewma_s = 0.001
        fleet.pools[1].engine.tick_ewma_s = 0.1
        k0 = next(k for k in range(16) if affinity_pool(k, 2) == 0)
        k1 = next(k for k in range(16) if affinity_pool(k, 2) == 1)
        for rid, key in ((0, k0), (1, k1)):
            fleet.submit(R(request_id=rid, auto_plan=True, deadline=0.5,
                           affinity_key=key), now=0.0)
        res = fleet.run(now_fn=lambda: 0.0)
        got.append(sorted((r.request_id, r.pool_id, r.S) for r in res))
    assert got[1] == got[0] == [(0, 0, 32), (1, 1, 4)]


def test_meshes_raise_and_build_defaults_to_the_card(monkeypatch):
    """``meshes`` gives pool i its mesh (None = unsharded) and a factory
    sees it; a wrong count raises as in JAX; the default device is the
    card."""
    from repro_torch.launch.mesh import make_host_mesh
    _, teps = _eps_pair()
    mesh = make_host_mesh(devices=[torch.device("cpu")] * 2)
    seen = []
    mixed = PoolFleet.build(TSCH, lambda pool_id, mesh: seen.append(mesh)
                            or teps, SHAPE, n_pools=2, slots=2,
                            meshes=[None, mesh], device="cpu")
    assert seen == [None, mesh]
    assert [p.engine.stats()["mesh"] for p in mixed.pools] == [
        None, {"data": 2, "model": 1}]
    assert [p.engine.stats()["state_sharded"] for p in mixed.pools] == [
        False, True]
    with pytest.raises(ValueError, match="meshes"):
        PoolFleet.build(TSCH, teps, SHAPE, n_pools=2, slots=2,
                        meshes=[None], device="cpu")
    fleet = PoolFleet.build(TSCH, lambda pool_id, mesh: teps, SHAPE,
                            n_pools=2, slots=2, meshes=[None, None],
                            device="cpu")
    assert [p.engine.eps_fn for p in fleet.pools] == [teps, teps]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PoolFleet.build(TSCH, teps, SHAPE, n_pools=2, slots=2)
