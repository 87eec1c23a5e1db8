"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

The same instrument calls, span events, stats dicts and results go through
both packages on the CPU; engines on both sides serve the same requests
on a virtual clock with the analytic eps model of
``test_torch_scheduler.py`` (one multiply by a float32 per-timestep
factor) and the same x_T (``SampleRequest(resume=SlotCheckpoint(k=0,
...))``); the JAX engine runs its Pallas kernels in interpret mode.

Tolerances: registry snapshots, Prometheus text, JSONL files, span checks,
dashboard and summary text, schemas, modeled-HBM bytes and the
virtual-clock histograms: exact (string- or bit-equal).  Histogram
percentiles: exact, against JAX and against values worked by hand.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import obs as jobs_mod
from repro.core import make_schedule as j_make_schedule
from repro.kernels.sampler_step import ops as jops
from repro.obs import schema as jschema
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import SampleRequest as JReq
from repro.serving.scheduler import SampleResult as JResult
from repro.serving.scheduler import SlotCheckpoint as JCk
from repro_torch import obs
from repro_torch.core import make_schedule
from repro_torch.obs import schema
from repro_torch.serving import (ContinuousBatchingEngine, SampleRequest,
                                 SampleResult, SlotCheckpoint)

JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)
SHAPE = (7, 23)


def _eps_pair(params: bool = False):
    """eps = x * f[t] in both frameworks (``params``: eps(p, x, t) reading
    the factor from p["f"])."""
    a = TSCH.alpha_bar.double().numpy()
    f = (np.sqrt(1 - a) / (1 - a + a * 0.25)).astype(np.float32)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)

    def jeps(x, t):
        return x * jf[t].reshape((-1,) + (1,) * (x.ndim - 1))

    def teps(x, t):
        return x * tf[t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
    return jeps, teps


def _requests(spec, J: bool):
    """Requests (rid, S, eta, deadline, submit time) with the same x_T."""
    R, Ck = (JReq, JCk) if J else (SampleRequest, SlotCheckpoint)
    out = []
    for rid, S, eta, dl, _ in spec:
        x = np.random.RandomState(100 + rid).randn(1, *SHAPE).astype(
            np.float32)
        rows = np.array(jops.to_slot_tile_layout(jnp.asarray(x))[0])
        out.append(R(request_id=rid, S=S, eta=eta, seed=rid, deadline=dl,
                     resume=Ck(request_id=rid, k=0, hist_rows=None,
                               x_rows=rows if J else torch.from_numpy(rows))))
    return out


def _replay(eng, reqs, spec):
    """Submit each request at its time and tick on a virtual clock (0.1 s
    per tick); returns the results by id."""
    results, now = {}, 0.0
    pending = list(zip(reqs, spec))
    while pending or len(eng.queue) or eng.active:
        for r, s in [p for p in pending if p[1][4] <= now]:
            eng.submit(r, now=now)
        pending = [p for p in pending if p[1][4] > now]
        now = round(now + 0.1, 9)
        for res in eng.tick(now=now):
            results[res.request_id] = res
    return results


REPLAY = [  # (rid, S, eta, deadline, submit time)
    (0, 4, 0.0, None, 0.0), (1, 6, 1.0, 2.0, 0.0), (2, 3, 0.0, 0.25, 0.0),
    (3, 5, 0.0, 9.0, 0.0), (4, 2, 1.0, None, 0.3), (5, 7, 0.0, 0.6, 0.3),
    (6, 3, 0.0, 5.0, 0.5), (7, 4, 1.0, 0.45, 0.5), (8, 5, 0.0, 0.3, 0.3),
]


# ---------------------------------------------------------------- registry
def _drive_registry(mod, seed):
    """The same instrument calls on a registry of ``mod`` (JAX or port)."""
    rs = np.random.RandomState(seed)
    reg = mod.MetricsRegistry()
    reg.counter("engine_ticks_total", "engine ticks executed",
                variant="rows").inc(3)
    reg.counter("engine_ticks_total", variant="mega").inc()
    reg.counter("fleet_routed_total", "", reason="affinity").inc(2)
    reg.counter("fleet_routed_total", "dispatches by routing decision",
                reason="least-loaded").inc(5)
    reg.counter("engine_tick_wall_seconds", "wall").inc(0.125)
    reg.counter("engine_tick_wall_seconds").inc(1.5e-3)
    reg.gauge("queue_depth", "current depth").set(4)
    reg.gauge("engine_tick_ewma_seconds", "ewma").set(0.0123456789)
    reg.gauge("odd", 'label "quoted" \\ help', path='a"b\\c').set(-2.5)
    h = reg.histogram("engine_tick_seconds", "per-tick wall")
    for v in rs.lognormal(-5, 2, 200):
        h.observe(float(v))
    s = reg.histogram("engine_deadline_slack_seconds", "slack",
                      edges=mod.SLACK_BUCKETS_S)
    for v in rs.randn(50) * 3:
        s.observe(float(v))
    reg.histogram("empty_seconds", "never observed")
    return reg


def test_registry_snapshot_and_prometheus_equal_jax():
    j1, t1 = _drive_registry(jobs_mod, 0), _drive_registry(obs, 0)
    j2, t2 = _drive_registry(jobs_mod, 1), _drive_registry(obs, 1)
    assert t1.snapshot() == j1.snapshot()
    want = jobs_mod.render_prometheus([(j1, {"tier": "fleet"}),
                                       (j2, {"pool": 0})])
    got = obs.render_prometheus([(t1, {"tier": "fleet"}), (t2, {"pool": 0})])
    assert got == want and "engine_tick_seconds_bucket{" in got
    assert got.count("# TYPE engine_ticks_total counter") == 1
    for key in (("engine_ticks_total", {"variant": "rows"}),
                ("queue_depth", {}), ("missing", {})):
        gi, ji = t1.get(key[0], **key[1]), j1.get(key[0], **key[1])
        assert (gi is None) == (ji is None)
        if gi is not None:
            assert (gi.kind, gi.value) == (ji.kind, ji.value)
    assert t1.help_for("fleet_routed_total") == j1.help_for(
        "fleet_routed_total") == ("counter", "dispatches by routing decision")
    jo, to = jobs_mod.Observability(registry=j1), obs.Observability(
        registry=t1)
    assert to.render_prometheus(pool=3) == jo.render_prometheus(pool=3)
    for r in (t1, j1):
        with pytest.raises(ValueError, match="already registered"):
            r.gauge("engine_ticks_total")
        with pytest.raises(ValueError, match="ascending"):
            r.histogram("bad", edges=(1.0, 1.0))
    t1.reset()
    j1.reset()
    assert t1.snapshot() == j1.snapshot()
    assert obs.render_prometheus([]) == jobs_mod.render_prometheus([]) == ""


def test_histogram_percentiles_exact():
    edges = (1.0, 2.0, 4.0)
    h, jh = obs.Histogram("h", edges=edges), jobs_mod.Histogram(
        "h", edges=edges)
    assert math.isnan(h.percentile(50)) and math.isnan(jh.percentile(50))
    for v in (0.5, 1.5, 1.5, 3.0, 9.0):
        h.observe(v)
        jh.observe(v)
    # counts per bucket [1, 2, 1, 1]: the 50th percentile (target 2.5) is
    # 1.5 / 2 of the way through (1, 2]; 100 sits in the +Inf bucket
    worked = {0: 0.0, 10: 0.5, 20: 1.0, 50: 1.75, 70: 3.0, 80: 4.0,
              100: 4.0}
    for q, want in worked.items():
        assert h.percentile(q) == jh.percentile(q) == want, q
    rs = np.random.RandomState(3)
    h, jh = obs.Histogram("s", edges=obs.SLACK_BUCKETS_S), \
        jobs_mod.Histogram("s", edges=jobs_mod.SLACK_BUCKETS_S)
    for v in rs.randn(300) * 4:
        h.observe(float(v))
        jh.observe(float(v))
    for q in (0, 0.5, 1, 5, 25, 50, 75, 95, 99, 99.9, 100):
        assert h.percentile(q) == jh.percentile(q), q
    assert h.counts.dtype == np.int64 and h.count == 300


# ------------------------------------------------------------------ spans
EVENTS = [
    {"ev": "submit", "t": 0.0, "req": 1, "deadline": 2.5},
    {"ev": "submit", "t": 0.0, "req": 2},
    {"ev": "route", "t": 0.0, "req": 1, "pool": 0, "reason": "affinity"},
    {"ev": "admit", "t": 0.1, "req": 1, "pool": 0, "slot": 1,
     "wait_s": 0.1, "plan": "abc", "nfe": 4},
    {"ev": "requeue", "t": 0.2, "req": 2, "reason": "drain"},
    {"ev": "first_tick", "t": 0.2, "req": 1, "pool": 0},
    {"ev": "preview", "t": 0.2, "req": 1, "k": 1},
    {"ev": "admit", "t": 0.3, "req": 2, "slot": 0},
    {"ev": "retire", "t": 0.5, "req": 1, "service_s": 0.4},
    {"ev": "retire", "t": 0.6, "req": 2, "missed": True},
    {"ev": "reject", "t": 0.7, "req": 3, "reason": "queue-full"},
]
BROKEN = [
    {"ev": "submit", "t": 0.0, "req": 9},
    {"ev": "retire", "t": 0.1, "req": 9},
    {"ev": "first_tick", "t": 0.2, "req": 9},
    {"ev": "bogus", "req": 8},
    {"ev": "resume", "t": 0.3, "req": 7, "k": 2},
    {"ev": "cancel", "t": 0.4, "req": 7},
    {"ev": "drop", "t": 0.4, "req": 7},
]


def test_jsonl_sink_round_trip_both_ways_and_span_checks(tmp_path):
    port_path, jax_path = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    with obs.JsonlSink(str(port_path)) as sink:
        for ev in EVENTS + BROKEN:
            sink.emit(ev)
    jsink = jobs_mod.JsonlSink(str(jax_path))
    for ev in EVENTS + BROKEN:
        jsink.emit(ev)
    jsink.close()
    assert port_path.read_text() == jax_path.read_text()
    assert jobs_mod.read_jsonl(str(port_path)) == EVENTS + BROKEN
    assert obs.read_jsonl(str(jax_path)) == EVENTS + BROKEN
    for evs in (EVENTS, BROKEN, EVENTS + BROKEN):
        assert obs.check_spans(evs) == jobs_mod.check_spans(evs)
        assert obs.spans(evs) == jobs_mod.spans(evs)
        for kind in ("admit", "retire", "submit"):
            assert obs.ordering(evs, kind) == jobs_mod.ordering(evs, kind)
    assert obs.check_spans(EVENTS) == []
    assert len(obs.check_spans(BROKEN)) >= 5
    assert obs.EVENT_KINDS == jobs_mod.EVENT_KINDS


def test_observability_child_close_and_tracer_count(tmp_path):
    o = obs.Observability(profile=True)
    sink = o.add_sink(obs.JsonlSink(str(tmp_path / "s.jsonl")))
    c = o.child()
    assert c.tracer is o.tracer and c.registry is not o.registry
    assert c.profile and c.tracing
    c.trace_context(5).emit("submit", 0.0)
    assert o.tracer.emitted == 1
    o.close()
    assert sink._f.closed
    assert obs.read_jsonl(str(tmp_path / "s.jsonl")) == [
        {"ev": "submit", "t": 0.0, "req": 5}]


# ------------------------------------------------------ dashboard, summary
ENGINE_STATS = {"pool_id": None, "slots": 4, "active": 3, "queued": 2,
                "ticks": 120, "tick_ewma_s": 0.01234, "completed": 40,
                "dropped": 1, "deadline_missed": 2, "occupancy": 0.8125,
                "tick_variant": "multistep", "probe_defect_max": 0.0421,
                "probe_finite_min": 1.0}
FLEET_STATS = {"n_pools": 2, "queued": 5, "ticks": 30, "completed": 11,
               "dropped": 0, "occupancy": 0.5, "mega_tick_ratio": 1.0,
               "pools": [dict(ENGINE_STATS, pool_id=0, state="active"),
                         {"pool_id": 1, "state": "stopped", "slots": 4}]}


@pytest.mark.parametrize("stats", [ENGINE_STATS, FLEET_STATS, {},
                                   {"pools": [{}]}, {"pools": []}],
                         ids=["engine", "fleet", "empty", "sparse-pool",
                              "no-pools"])
def test_render_dashboard_string_equal(stats):
    got = obs.render_dashboard(stats)
    assert got == jobs_mod.render_dashboard(stats)
    assert got.count("\n") >= 1


def _result_pair(rid, **kw):
    base = dict(request_id=rid, x0=None, S=kw.pop("S", 10), eta=0.0,
                submit_t=0.0, admit_t=0.5, finish_t=1.0)
    base.update(kw)
    return JResult(**base), SampleResult(**base)


RESULT_SETS = {
    "mixed": [dict(submit_t=0.0, admit_t=0.1 * i, finish_t=0.3 + 0.2 * i,
                   deadline_missed=i % 3 == 0,
                   quality={"frames": 4, "defect_mean": 0.01 * i})
              for i in range(7)] + [dict(dropped=True, admit_t=None)],
    "empty": [],
    "drop-only": [dict(dropped=True, admit_t=None, deadline_missed=True)] * 3,
    "untimed": [dict(submit_t=None), dict(submit_t=None, quality={})],
}


@pytest.mark.parametrize("case", list(RESULT_SETS))
def test_summarize_and_render_summary_string_equal(case):
    pairs = [_result_pair(i, **kw) for i, kw in enumerate(RESULT_SETS[case])]
    jsum = jobs_mod.summarize_results([p[0] for p in pairs])
    tsum = obs.summarize_results([p[1] for p in pairs])
    assert tsum == jsum
    for path in (None, "trace.jsonl"):
        assert (obs.render_summary(tsum, trace_path=path)
                == jobs_mod.render_summary(jsum, trace_path=path))
    assert obs.render_summary({}) == jobs_mod.render_summary({})


# ---------------------------------------------------------------- schemas
def test_schema_sets_equal_jax_and_engine_stats_keys():
    for name in ("ENGINE_STATS_KEYS", "POOL_STATS_KEYS", "FLEET_STATS_KEYS",
                 "GATEWAY_STATS_KEYS", "PROBE_COLUMNS", "FLIGHT_HEADER_KEYS",
                 "FLIGHT_FRAME_KEYS", "FLIGHT_SCHEMA_VERSION"):
        assert getattr(schema, name) == getattr(jschema, name), name
    _, teps = _eps_pair()
    for kw in ({}, {"probes": True}, {"max_order": 2, "preview": True,
                                      "stochastic": True}):
        eng = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2,
                                       device="cpu", **kw)
        eng.serve(_requests([(0, 3, 0.0, None, 0.0)], J=False))
        assert set(eng.stats()) == schema.ENGINE_STATS_KEYS


# ------------------------------------------------------- modeled HBM table
HBM_CASES = {
    "rows": dict(),
    "multistep": dict(max_order=3, stochastic=True),
    "preview": dict(preview=True, clip_x0=1.0),
    "probes": dict(probes=True),
    "probes-multistep": dict(probes=True, max_order=2),
    "probes-no-defect": dict(probes=jobs_mod.ProbeSpec(defect=False)),
}


@pytest.mark.parametrize("case", list(HBM_CASES))
def test_modeled_hbm_table_bytes_equal_jax(case):
    kw = dict(HBM_CASES[case])
    tkw = dict(kw)
    if isinstance(kw.get("probes"), jobs_mod.ProbeSpec):
        tkw["probes"] = obs.ProbeSpec(defect=False)
    jeps, teps = _eps_pair()
    jeng = JEngine(JSCH, jeps, SHAPE, slots=3, **kw)
    teng = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=3,
                                    device="cpu", **tkw)
    want = [(r["component"], r["bytes"])
            for r in jobs_mod.modeled_hbm_table(jeng)]
    got = [(r["component"], r["bytes"]) for r in obs.modeled_hbm_table(teng)]
    assert got == want
    text = obs.format_hbm_table(obs.modeled_hbm_table(teng))
    assert text.splitlines()[-1].startswith("total")


def test_modeled_hbm_table_mega_bytes_equal_jax():
    import jax
    from repro import diffusion_lm as jdlm
    from repro.models.common import ArchConfig as JArch
    from repro_torch import interop
    from repro_torch.diffusion_lm import model as tdlm
    from repro_torch.models.common import ArchConfig as TArch
    arch = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=50)
    jcfg = jdlm.DiffusionLMConfig(arch=JArch(name="t", family="dense",
                                             **arch), time_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=TArch(name="t", family="dense",
                                             **arch), time_dim=32)
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    shape = (64, tcfg.latent_dim)
    jeng = JEngine(JSCH, jdlm.make_tile_eps_fn(jp, jcfg, 2, 64), shape,
                   slots=2)
    teng = ContinuousBatchingEngine(
        TSCH, tdlm.make_tile_eps_fn(tp, tcfg, 2, 64), shape, slots=2,
        device="cpu")
    assert jeng.use_mega and teng.use_mega
    want = [(r["component"], r["bytes"])
            for r in jobs_mod.modeled_hbm_table(jeng)]
    got = [(r["component"], r["bytes"]) for r in obs.modeled_hbm_table(teng)]
    assert got == want
    assert dict(got)["trunk_weights"] > 0 and dict(got)["eps_roundtrip"] == 0


# ------------------------------------------- engine instruments vs JAX's
def test_engine_histograms_and_gauges_equal_jax_after_replay():
    jeps, teps = _eps_pair()
    jo, to = jobs_mod.Observability(), obs.Observability()
    jeng = JEngine(JSCH, jeps, SHAPE, slots=2, stochastic=True, obs=jo)
    teng = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2,
                                    stochastic=True, obs=to, device="cpu")
    jres = _replay(jeng, _requests(REPLAY, J=True), REPLAY)
    tres = _replay(teng, _requests(REPLAY, J=False), REPLAY)
    assert sorted(tres) == sorted(jres) == list(range(len(REPLAY)))
    assert sum(r.dropped for r in tres.values()) >= 2
    assert sum(r.deadline_missed for r in tres.values()) >= 3
    virtual = ("engine_queue_wait_seconds", "engine_service_seconds",
               "engine_request_latency_seconds",
               "engine_deadline_slack_seconds")
    for name in virtual + ("engine_tick_seconds",):
        j, t = jo.registry.get(name), to.registry.get(name)
        assert t.kind == j.kind == "histogram"
        assert t.count == j.count > 0, name
        if name in virtual:     # virtual-clock values: the same buckets
            np.testing.assert_array_equal(t.counts, j.counts)
            assert t.sum == pytest.approx(j.sum, abs=1e-9)
    assert to.registry.get("engine_tick_seconds").count == teng.ticks - 1
    for name, labels in (("engine_active_slots", {}), ("queue_depth", {}),
                         ("engine_completed_total", {}),
                         ("engine_deadline_miss_total", {}),
                         ("engine_ticks_total", {"variant": "rows"})):
        assert (to.registry.get(name, **labels).value
                == jo.registry.get(name, **labels).value), name
    assert ({n: to.registry.help_for(n) for n in virtual}
            == {n: jo.registry.help_for(n) for n in virtual})


def test_profile_records_tick_range_on_cpu():
    from torch.profiler import ProfilerActivity, profile
    _, teps = _eps_pair()
    eng = ContinuousBatchingEngine(
        TSCH, teps, SHAPE, slots=2, device="cpu",
        obs=obs.Observability(profile=True))
    plain = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2,
                                     device="cpu")
    for e in (eng, plain):
        e.submit(_requests([(0, 6, 0.0, None, 0.0)], J=False)[0], now=0.0)
        e.tick(now=0.1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            eng.tick(now=0.2 + 0.1 * i)
            plain.tick(now=0.2 + 0.1 * i)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("repro/tick/rows") == 3     # the plain engine: none
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.annotate("repro/tick/mega"):
            torch.ones(3).sum()
    assert "repro/tick/mega" in {e.key for e in prof.key_averages()}
