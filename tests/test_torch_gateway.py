"""The port's serving gateway (``repro_torch.serving.gateway``) against the
JAX package's (``tests/test_gateway.py``, case for case).

Both gateways serve the same wire specs on the CPU over the demo trunk of
``repro/serving/fleet/sharded.py`` (``trunk_apply``; the port's copy below
is the same function in torch, its weights converted from the JAX
``make_trunk_params``), the JAX pools running their Pallas kernels in
interpret mode, the port's their plain versions.  Where x0 is compared,
each request is handed the same x_T in both packages as a k = 0
``SlotCheckpoint`` set on the accepted request before its first pump.

Tolerances:
  * parse failures (code, HTTP status, message), the overload policy's
    shed order, shed-log records, event kinds / request ids / steps /
    pools, reject counters, ``retry_after_s``, registry versions and the
    ``stats()`` key set: exact.
  * x0 of results and previews: 1e-5 of max(|x0|, |x_T|), the
    engine-against-engine tolerance of ``test_torch_scheduler.py``.
The bridge (engine thread, grad mode, poisoning) and the aiohttp
transport are the port's own and run against the port only.
"""
import asyncio
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_schedule as j_make_schedule
from repro.kernels.sampler_step import ops as jops
from repro.obs import ListSink as JListSink
from repro.obs import Observability as JObs
from repro.obs.schema import GATEWAY_STATS_KEYS as J_GATEWAY_STATS_KEYS
from repro.serving.errors import RequestError as JRequestError
from repro.serving.fleet import make_trunk_params, trunk_apply
from repro.serving.gateway import GatewayCore as JCore
from repro.serving.gateway import ModelRegistry as JRegistry
from repro.serving.gateway import OverloadPolicy as JPolicy
from repro.serving.gateway import parse_spec as j_parse_spec
from repro.serving.scheduler import SampleRequest as JReq
from repro.serving.scheduler import SlotCheckpoint as JCk
from repro_torch.core import make_schedule
from repro_torch.obs import ListSink, Observability
from repro_torch.obs.schema import GATEWAY_STATS_KEYS
from repro_torch.serving import (RejectCode, RequestError, SampleRequest,
                                 SlotCheckpoint)
from repro_torch.serving.gateway import (EngineBridge, GatewayCore,
                                         HAVE_HTTP, ModelRegistry,
                                         OverloadPolicy, parse_spec)

ENGINE_TOL_OF_SCALE = 1e-5
JSCH = j_make_schedule("linear", T=100)
TSCH = make_schedule("linear", T=100)
DIM, HIDDEN = 8, 32
J_PARAMS = {s: make_trunk_params(JSCH, DIM, HIDDEN, seed=s)
            for s in (0, 1, 2)}


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


T_PARAMS = {s: _torch_tree(p) for s, p in J_PARAMS.items()}
A, B, C = 0, 1, 2


def t_trunk_apply(params, x, t):
    """``repro.serving.fleet.trunk_apply`` (single device) in torch."""
    w = params["trunk"]
    a = params["alpha_bar"][t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
    base = x * torch.sqrt(1 - a) / (1 - a + a * 0.25)
    r = torch.tanh(x @ w["wq"]) @ w["wo"]
    return base + 0.05 * torch.sqrt(1 - a) * w["time_w"] * r


def _gateways(models=None, obs=(None, None), **kw):
    """(JAX core, port core) over the same models and options; ``obs`` is
    a (JAX, port) pair of Observability handles."""
    models = models if models is not None else {"base": A}
    kw.setdefault("slots", 2)
    jkw, tkw = dict(kw, obs=obs[0]), dict(kw, obs=obs[1])
    for k, v in kw.items():
        if isinstance(v, OverloadPolicy):
            jkw[k] = JPolicy(shed_depth=v.shed_depth, margin=v.margin)
    j = JCore.build(JSCH, trunk_apply, (DIM,),
                    models={n: J_PARAMS[s] for n, s in models.items()},
                    **jkw)
    t = GatewayCore.build(TSCH, t_trunk_apply, (DIM,),
                          models={n: T_PARAMS[s] for n, s in models.items()},
                          device="cpu", **tkw)
    return j, t


def _x_T(seed):
    return np.random.RandomState(500 + seed).randn(DIM).astype(np.float32)


def _submit(core, spec, on_event, now=None, x_T=True):
    """Submit one spec; with ``x_T`` the accepted request starts from
    ``_x_T(seed)`` (a k = 0 checkpoint) in either package."""
    rid = core.submit(dict(spec), on_event, now=now)
    if x_T:
        rows = np.array(jops.to_slot_tile_layout(
            jnp.asarray(_x_T(spec.get("seed", 0)))[None])[0])
        req = core._requests[rid]
        req.resume = (JCk(request_id=rid, k=0, x_rows=rows, hist_rows=None)
                      if isinstance(core, JCore) else
                      SlotCheckpoint(request_id=rid, k=0,
                                     x_rows=torch.from_numpy(rows),
                                     hist_rows=None))
    return rid


def _serve_one(core, spec, now=None):
    """Submit one spec and pump until its terminal event."""
    events = []
    _submit(core, spec, events.append, now=now)
    for _ in range(500):
        if events and events[-1]["event"] in ("result", "error"):
            break
        core.pump(now)
    return events


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_events(tev, jev, seed=None):
    """Equal event streams: x0 within the tolerance of the x_T of spec
    seed ``seed`` (not compared when None), every other field exact."""
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    for t, j in zip(tev, jev):
        assert set(t) == set(j), (t, j)
        for k in t:
            if k == "x0":
                if seed is not None:
                    jx = _np(j[k])
                    scale = max(np.abs(jx).max(), np.abs(_x_T(seed)).max())
                    assert (np.abs(_np(t[k]) - jx).max()
                            <= ENGINE_TOL_OF_SCALE * scale)
            elif k in ("latency_s", "queue_wait_s", "service_s"):
                continue              # wall-clock pumps: host times
            else:
                assert t[k] == j[k], k


# ------------------------------------------------------------- parse_spec
BAD_SPECS = {
    "unknown-field": {"S": 4, "bogus": 1},
    "wrong-type": {"S": "ten"},
    "non-dict": [1, 2],
    "bad-tau": {"tau": "cubic"},
    "negative-preview": {"preview_every": -1},
    "float-for-int": {"preview_every": 1.5},
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_parse_spec_refusals_equal_jax(case):
    spec = BAD_SPECS[case]
    with pytest.raises(JRequestError) as je:
        j_parse_spec(spec, 0, now=0.0)
    with pytest.raises(RequestError) as te:
        parse_spec(spec, 0, now=0.0)
    assert te.value.code is RejectCode.BAD_REQUEST
    assert te.value.code.value == je.value.code.value
    assert te.value.status == je.value.status == 400
    assert str(te.value) == str(je.value)


def test_parse_spec_fields_and_deadline_equal_jax():
    spec = {"model": "m", "S": 4, "eta": 1, "tau": "quadratic", "seed": 9,
            "deadline_s": 2.5, "preview_every": 2, "auto_plan": False,
            "affinity_key": "k", "stream": True}
    j, t = j_parse_spec(spec, 7, now=10.0), parse_spec(spec, 7, now=10.0)
    for f in ("request_id", "S", "eta", "tau_kind", "seed", "deadline",
              "preview_every", "auto_plan", "affinity_key", "model"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.deadline == 12.5 and isinstance(t.eta, float)
    assert parse_spec({"S": 4}, 0, now=10.0).deadline is None


# --------------------------------------------------------- OverloadPolicy
def _pending(deadlines, S=10, auto_plan=False, t0=0.0, J=False):
    R = JReq if J else SampleRequest
    reqs = []
    for i, d in enumerate(deadlines):
        r = R(request_id=i, S=S, seed=i, deadline=d, auto_plan=auto_plan)
        r.submit_t = t0 + i
        reqs.append(r)
    return reqs


def _plans(policy_kw, deadlines, now, tick_s, **kw):
    out = []
    for J, Pol in ((True, JPolicy), (False, OverloadPolicy)):
        plan = Pol(**policy_kw).plan_shed(
            _pending(deadlines, J=J, **kw), now, tick_s)
        out.append([(r.request_id, c.value) for r, c in plan])
    assert out[0] == out[1]
    return out[1]


def test_policy_depth_shed_evicts_lowest_headroom_first():
    plan = _plans(dict(shed_depth=2, margin=0.0), [10.0, 1.0, 20.0, 5.0],
                  0.0, None)
    assert plan == [(1, "shed-overload"), (3, "shed-overload")]


def test_policy_feasibility_shed_exempts_auto_plan():
    assert _plans(dict(margin=1.0), [5.0], 0.0, 1.0, S=50) == [
        (0, "shed-infeasible")]
    assert _plans(dict(margin=1.0), [5.0], 0.0, 1.0, S=50,
                  auto_plan=True) == []
    assert _plans(dict(margin=1.0), [5.0], 0.0, None, S=50) == []


def test_policy_deadline_free_shed_last_newest_first():
    assert _plans(dict(shed_depth=1, margin=0.0), [None, None, None], 5.0,
                  None) == [(2, "shed-overload"), (1, "shed-overload")]


def test_policy_random_queues_shed_as_jax():
    rs = np.random.RandomState(3)
    seen = set()
    for trial in range(300):
        n = int(rs.randint(0, 9))
        dls = [None if rs.rand() < 0.3 else float(rs.uniform(0.1, 8.0))
               for _ in range(n)]
        kw = dict(shed_depth=(None if rs.rand() < 0.3
                              else int(rs.randint(0, 5))),
                  margin=float(rs.choice([0.0, 0.5, 1.0, 2.0])))
        tick = None if rs.rand() < 0.3 else float(rs.uniform(0.01, 0.5))
        plan = _plans(kw, dls, float(rs.uniform(0, 2)), tick,
                      S=int(rs.randint(1, 30)),
                      auto_plan=bool(rs.rand() < 0.2))
        seen.update(c for _, c in plan)
    assert seen == {"shed-overload", "shed-infeasible"}


# ------------------------------------------------------ core: happy paths
def test_gateway_result_event_round_trip():
    j, t = _gateways()
    spec = {"model": "base", "S": 4, "seed": 3}
    jev, tev = _serve_one(j, spec), _serve_one(t, spec)
    assert [e["event"] for e in tev] == ["result"]
    _same_events(tev, jev, seed=3)
    assert tuple(tev[0]["x0"].shape) == (DIM,)
    assert tev[0]["S"] == 4 and not tev[0]["deadline_missed"]
    st = t.stats()
    assert (st["requests"], st["results_streamed"], st["streams"]) == (
        1, 1, 0)
    for k in ("requests", "results_streamed", "streams", "rejected"):
        assert st[k] == j.stats()[k], k


def test_gateway_previews_stream_before_result():
    j, t = _gateways()
    spec = {"S": 6, "seed": 0, "preview_every": 2}
    jev, tev = _serve_one(j, spec), _serve_one(t, spec)
    _same_events(tev, jev, seed=0)
    kinds = [e["event"] for e in tev]
    assert kinds[-1] == "result" and kinds.count("preview") >= 2
    steps = [e["step"] for e in tev if e["event"] == "preview"]
    assert steps == sorted(steps)
    assert t.stats()["previews_streamed"] == kinds.count("preview")
    assert tev[-1]["previews"] == kinds.count("preview")
    assert all(isinstance(e["x0"], torch.Tensor) for e in tev)


def test_gateway_stats_schema_frozen():
    _, t = _gateways()
    assert set(t.stats()) == GATEWAY_STATS_KEYS == J_GATEWAY_STATS_KEYS


# --------------------------------------------------- core: typed refusals
@pytest.fixture(scope="module")
def cores():
    return _gateways()


@pytest.mark.parametrize("spec", [{"model": "nope", "S": 4},
                                  {"bogus": 1}, {"S": 0}, {"S": 4, "eta": 1}],
                         ids=["unknown-model", "bad-field", "bad-steps",
                              "stochastic"])
def test_refusals_are_typed_and_counted_as_jax(cores, spec):
    codes = []
    for core, Err in zip(cores, (JRequestError, RequestError)):
        before = core.stats()["rejected"]
        with pytest.raises(Err) as ei:
            core.submit(dict(spec), lambda e: None)
        assert core.stats()["rejected"] == before + 1
        counts = {dict(i.labels).get("code"): int(i.value)
                  for i in core.obs.registry.instruments()
                  if i.name == "gateway_rejected_total"}
        codes.append((ei.value.code.value, ei.value.status,
                       ei.value.retry_after_s, counts))
    assert codes[0] == codes[1]
    if spec.get("model") == "nope":
        assert codes[1][:2] == (RejectCode.UNKNOWN_MODEL.value, 404)


def test_bounded_queue_rejects_queue_full():
    out = []
    for core in _gateways(slots=1, max_queue=2):
        sink = []
        core.submit({"S": 30, "seed": 0}, sink.append, now=0.0)
        core.pump(now=0.0)                      # occupy the single slot
        core.submit({"S": 4, "seed": 1}, sink.append, now=0.0)
        core.submit({"S": 4, "seed": 2}, sink.append, now=0.0)
        with pytest.raises(ValueError) as ei:
            core.submit({"S": 4, "seed": 3}, sink.append, now=0.0)
        st = core.stats()
        out.append((ei.value.code.value, ei.value.status,
                    ei.value.retry_after_s, st["rejected"],
                    st["queue_depth"]))
    assert out[0] == out[1] == (RejectCode.QUEUE_FULL.value, 429, 1, 1, 2)


# ------------------------------------------------------- core: overload
def test_shed_before_tick_lowest_headroom_first():
    """The depth sweep runs BEFORE dispatch: victims get typed 503
    terminals + audit records (lowest headroom first) and never reach a
    pool; survivors keep their queue slots; the span events are JAX's."""
    jo, to = JObs(), Observability()
    jsink, tsink = jo.add_sink(JListSink()), to.add_sink(ListSink())
    j, t = _gateways(slots=1, obs=(jo, to),
                     policy=OverloadPolicy(shed_depth=2, margin=0.0))
    got = []
    for core in (j, t):
        by_rid = {}
        core.submit({"S": 40, "seed": 0}, lambda ev: None, now=0.0)
        core.pump(now=0.0)                  # resident fills the only slot
        for d in (10.0, 1.0, 20.0, 5.0):
            box = []
            rid = core.submit({"S": 4, "deadline_s": d, "seed": 1},
                              box.append, now=0.0)
            by_rid[rid] = box
        core.pump(now=0.0)                  # sweep: depth 4 > shed_depth 2
        got.append((by_rid, core.shed_log, core.stats()))
    (jb, jlog, jst), (tb, tlog, tst) = got
    for rid in tb:
        _same_events(tb[rid], jb[rid])
    assert tlog == jlog
    assert [rec["headroom_s"] for rec in tlog] == [1.0, 5.0]
    assert all(rec["kept_min_headroom_s"] == 10.0 for rec in tlog)
    shed = [evs[0] for evs in tb.values() if evs]
    assert len(shed) == 2 and all(
        e["code"] == RejectCode.SHED_OVERLOAD.value and e["status"] == 503
        for e in shed)
    assert (tst["queue_depth"], tst["shed"]) == (jst["queue_depth"],
                                                 jst["shed"]) == (2, 2)
    tdrops = [e for e in tsink.events if e["ev"] == "drop"]
    assert tdrops == [e for e in jsink.events if e["ev"] == "drop"]
    assert [e["reason"] for e in tdrops] == ["shed", "shed"]


def test_expired_requests_get_504():
    out = []
    for core in _gateways(slots=1, policy=OverloadPolicy(margin=0.0)):
        events = []
        core.submit({"S": 4, "deadline_s": 0.5, "seed": 1}, events.append,
                    now=0.0)
        core.pump(now=1.0)                  # deadline passed in the queue
        out.append((events, core.stats()["expired"]))
    _same_events(out[1][0], out[0][0])
    assert out[1][0][0]["code"] == RejectCode.EXPIRED.value
    assert out[1][0][0]["status"] == 504 and out[1][1] == out[0][1] == 1


# ------------------------------------------------------- core: hot swap
def test_hot_swap_serves_inflight_on_old_weights_without_retrace():
    """A rollout started mid-request: the resident finishes on the OLD
    weights, work submitted during the walk runs on the NEW ones (both
    as in JAX), the version bumps, and the pool's tick count stays 1."""
    spec = {"model": "base", "S": 6, "seed": 7}
    got = []
    for core, new in zip(_gateways({"base": A, "alt": B}),
                         (J_PARAMS[C], T_PARAMS[C])):
        inflight, during = [], []
        _submit(core, spec, inflight.append)
        core.pump()                         # resident on the base pool
        assert core.hot_swap("base", new) == 1
        assert core.swapping == "base"
        _submit(core, spec, during.append)  # lands after the restore
        for _ in range(500):
            if core.swapping is None and during \
                    and during[-1]["event"] in ("result", "error"):
                break
            core.pump()
        assert core.swapping is None
        base = next(p for p in core.fleet.pools if p.model == "base")
        got.append((inflight, during, core.registry.version("base"),
                    base.weight_swaps,
                    base.engine.stats()["compiled_ticks"],
                    core.stats()["swaps"]))
    (ji, jd, *jrest), (ti, td, *trest) = got
    _same_events(ti, ji, seed=7)
    _same_events(td, jd, seed=7)
    assert trest == jrest == [2, 1, 1, 1]
    # the port's own old / new weights, each on a lone gateway
    _, lone_old = _gateways({"base": A})
    _, lone_new = _gateways({"base": C})
    old = _serve_one(lone_old, spec)[-1]["x0"]
    new = _serve_one(lone_new, spec)[-1]["x0"]
    assert not torch.allclose(old, new)
    assert torch.equal(ti[-1]["x0"], old) and torch.equal(td[-1]["x0"], new)


def test_hot_swap_requires_staged_checkpoint_and_known_model(cores):
    for core in cores:
        with pytest.raises(ValueError, match="no staged"):
            core.hot_swap("base")
        with pytest.raises(ValueError) as ei:
            core.hot_swap("ghost")
        assert ei.value.code.value == RejectCode.UNKNOWN_MODEL.value


def test_registry_stage_rejects_mismatches():
    bad = make_trunk_params(JSCH, DIM, HIDDEN * 2, seed=3)
    for Reg, params, wrong in ((JRegistry, J_PARAMS, bad),
                               (ModelRegistry, T_PARAMS, _torch_tree(bad))):
        reg = Reg()
        reg.register("m", params[A])
        with pytest.raises(ValueError, match="rollout must preserve"):
            reg.stage("m", wrong)
        with pytest.raises(KeyError):
            reg.stage("ghost", params[C])
        reg.stage("m", params[C])
        assert reg.describe()["m"] == {"version": 1, "staged": True}
        assert reg.promote("m") == 2
        with pytest.raises(ValueError, match="no staged"):
            reg.promote("m")
    reg = ModelRegistry()
    reg.register("m", T_PARAMS[A])
    with pytest.raises(ValueError, match="tree structure"):
        reg.stage("m", {"trunk": T_PARAMS[C]["trunk"]})
    dtype = _torch_tree(J_PARAMS[C])
    dtype["trunk"]["wq"] = dtype["trunk"]["wq"].double()
    with pytest.raises(ValueError, match="rollout must preserve"):
        reg.stage("m", dtype)
    meta = jax.tree_util.tree_map(lambda x: x.to("meta"), T_PARAMS[C])
    with pytest.raises(ValueError, match="meta"):
        reg.stage("m", meta)


# ------------------------------------------------------------- routing
def test_multi_model_requests_route_to_their_pools():
    got = []
    for core in _gateways({"base": A, "alt": B}):
        pool_of = {p.model: p.pool_id for p in core.fleet.pools}
        evs = [_serve_one(core, {"model": m, "S": 3, "seed": 0})
               for m in ("base", "alt", "base")]
        assert [e[-1]["pool_id"] for e in evs] == [
            pool_of[m] for m in ("base", "alt", "base")]
        got.append(evs)
    for tev, jev in zip(*reversed(got)):
        _same_events(tev, jev, seed=0)


# -------------------------------------------------------------- bridge
def test_bridge_runs_commands_and_traffic_on_engine_thread():
    """Commands and callbacks run on the engine thread, under its own
    no_grad (grad mode is thread-local: the caller's mode does not
    reach it)."""
    _, core = _gateways()
    seen = {}
    orig = core.pump

    def pump(now=None):
        seen.setdefault("grad", torch.is_grad_enabled())
        seen.setdefault("thread", threading.current_thread().name)
        return orig(now)

    core.pump = pump
    assert torch.is_grad_enabled()
    bridge = EngineBridge(core, idle_s=0.01).start()
    try:
        assert bridge.call(lambda: 41 + 1).result(timeout=5) == 42
        assert bridge.call(torch.is_grad_enabled).result(timeout=5) is False
        done = threading.Event()
        events = []

        def on_event(ev):
            events.append((ev, threading.current_thread().name))
            if ev["event"] in ("result", "error"):
                done.set()

        bridge.call(core.submit, {"S": 4, "seed": 0},
                    on_event).result(timeout=5)
        assert done.wait(timeout=30)
        assert events[-1][0]["event"] == "result"
        assert {name for _, name in events} == {"gateway-engine"}
        assert seen == {"grad": False, "thread": "gateway-engine"}
        with pytest.raises(RequestError):
            bridge.call(core.submit, {"model": "ghost", "S": 4},
                        lambda e: None).result(timeout=5)
    finally:
        bridge.stop()


def test_bridge_pump_failure_poisons_future_calls():
    class Exploding:
        busy = True

        def pump(self):
            raise RuntimeError("tick went sideways")

    bridge = EngineBridge(Exploding(), idle_s=0.01).start()
    try:
        deadline = time.monotonic() + 5
        while bridge.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert isinstance(bridge.error, RuntimeError)
        with pytest.raises(RuntimeError, match="engine thread failed"):
            bridge.call(lambda: 1)
    finally:
        bridge.stop()


# ------------------------------------------------------------ HTTP / SSE
needs_http = pytest.mark.skipif(not HAVE_HTTP,
                                reason="aiohttp not installed")


@needs_http
def test_http_sse_end_to_end_with_rollout():
    """One live server: JSON + SSE sampling across both models (the JSON
    x0 the host copy of the engine's), typed HTTP errors, metrics /
    stats / health, and a rollout driven entirely over the wire."""
    import aiohttp
    from repro_torch.serving.gateway import start_gateway, stop_gateway
    from repro_torch.serving.gateway.core import wire_event

    _, core = _gateways({"base": A, "alt": B})
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert wire_event({"event": "preview", "x0": x, "step": 2}) == {
        "event": "preview", "step": 2,
        "x0": {"shape": [2, 3], "data": [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]}}

    async def scenario():
        runner, bridge, port = await start_gateway(core, port=0)
        url = f"http://127.0.0.1:{port}"
        try:
            async with aiohttp.ClientSession() as sess:
                async with sess.get(f"{url}/v1/models") as r:
                    models = await r.json()
                assert sorted(models) == ["alt", "base"]
                async with sess.post(f"{url}/v1/sample", json={
                        "model": "base", "S": 4, "seed": 0}) as r:
                    assert r.status == 200
                    body = await r.json()
                assert body["event"] == "result"
                assert body["x0"]["shape"] == [DIM]
                assert len(body["x0"]["data"]) == DIM
                kinds = []
                async with sess.post(f"{url}/v1/sample", json={
                        "model": "alt", "S": 6, "seed": 1,
                        "stream": True, "preview_every": 2}) as r:
                    assert r.headers["Content-Type"].startswith(
                        "text/event-stream")
                    async for raw in r.content:
                        line = raw.decode().strip()
                        if line.startswith("event: "):
                            kinds.append(line.split(": ", 1)[1])
                assert kinds[0] == "accepted" and kinds[-1] == "result"
                assert kinds.count("preview") >= 2
                async with sess.post(f"{url}/v1/sample", json={
                        "model": "ghost", "S": 4}) as r:
                    assert r.status == 404
                    assert (await r.json())["error"] == "unknown-model"
                async with sess.post(f"{url}/v1/sample", json={
                        "S": "ten"}) as r:
                    assert r.status == 400
                async with sess.post(f"{url}/v1/sample",
                                     data=b"{not json") as r:
                    assert r.status == 400
                async with sess.post(
                        f"{url}/v1/models/base/rollout") as r:
                    assert r.status == 409
                await bridge.acall(core.registry.stage, "base", T_PARAMS[C])
                async with sess.post(
                        f"{url}/v1/models/base/rollout") as r:
                    assert r.status == 200
                    assert (await r.json())["status"] == "rolling"
                for _ in range(200):
                    async with sess.get(f"{url}/v1/models") as r:
                        models = await r.json()
                    if models["base"]["version"] == 2:
                        break
                    await asyncio.sleep(0.02)
                assert models["base"]["version"] == 2
                async with sess.post(f"{url}/v1/sample", json={
                        "model": "base", "S": 3, "seed": 2}) as r:
                    assert r.status == 200
                async with sess.get(f"{url}/v1/stats") as r:
                    st = await r.json()
                assert set(st) == set(GATEWAY_STATS_KEYS)
                assert all(p["compiled_ticks"] == 1
                           for p in st["fleet"]["pools"])
                async with sess.get(f"{url}/metrics") as r:
                    text = await r.text()
                assert "gateway_requests_total" in text
                assert 'tier="gateway"' in text
                async with sess.get(f"{url}/healthz") as r:
                    assert (await r.json())["status"] == "ok"
                async with sess.get(f"{url}/v1/debug/flight/0") as r:
                    assert r.status == 404       # built without probes
                async with sess.get(f"{url}/v1/debug/flight/x") as r:
                    assert r.status == 400
        finally:
            await stop_gateway(runner, bridge)

    asyncio.run(scenario())
