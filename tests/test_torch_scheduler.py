"""The port's continuous-batching scheduler against the JAX package's.

Both engines serve the same requests on the CPU (the JAX Pallas kernels in
interpret mode, as its own tests run them; the port's wrappers take their
plain versions) and get the same x_T through
``SampleRequest(resume=SlotCheckpoint(k=0, x_rows=...))``.  The eps model
is the analytic one of ``test_scheduler.py`` with mu = 0, written as ONE
multiply by a float32 per-timestep factor, so both frameworks compute it
to the same bits.

Tolerances:
  * queue order, expiries, drops, reject codes, span events, the per-tick
    seed stream, ``_states()`` columns and layouts: exact.
  * ``slot_tile_step``, deterministic order 1 without preview: bitwise (the
    plain per-row step emulates XLA:CPU's FMAs).
  * ``slot_tile_step`` stochastic / clip / preview / order 2-3: 8 float32
    ulps of max|out| (Box–Muller's libm differs by an ulp; the
    Adams–Bashforth combine may contract differently).
  * engine against engine, per request x0: 1e-5 of max(|x0|, |x_T|) — the
    same arithmetic carried through up to 12 ticks.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import StepStates as JStepStates
from repro.core import make_schedule as j_make_schedule
from repro.core.sampler import sample_step as j_sample_step
from repro.core.sampler import slot_tile_step as j_slot_tile_step
from repro.kernels.sampler_step import ops as jops
from repro.kernels.sampler_step.kernel import _GOLDEN, _fmix32
from repro.obs import ListSink as JListSink
from repro.obs import Observability as JObs
from repro.sampling import SamplerPlan as JPlan
from repro.sampling.specs import TauSpec as JTau
from repro.serving import errors as jerrors
from repro.serving.scheduler import AdmissionQueue as JQueue
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import SampleRequest as JReq
from repro.serving.scheduler import SlotCheckpoint as JCk
from repro_torch.core import (StepStates, make_schedule, sample_step,
                              slot_tile_step, step_table)
from repro_torch.core.sampler import SamplerConfig
from repro_torch.kernels.sampler_step import ops as tops
from repro_torch.kernels.sampler_step.ref import GOLDEN, fmix32_u32
from repro_torch.obs import ListSink, Observability
from repro_torch.sampling import SamplerPlan
from repro_torch.sampling.specs import TauSpec
from repro_torch.serving import (AdmissionQueue, ContinuousBatchingEngine,
                                 DiffusionSampler, RejectCode, RequestError,
                                 SampleRequest, SlotCheckpoint)

F32_ULP = float(np.finfo(np.float32).eps)
STEP_ULPS = 8
ENGINE_TOL_OF_SCALE = 1e-5
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)
COEFS = ("c_x0", "c_dir", "c_noise", "sqrt_a_t", "sqrt_1m_a_t")


# ---------------------------------------------------------------- models
def _factor(s=1.0):
    """float32 eps factor per timestep: eps = x * f[t] is the analytic
    model's mu = 0 case, one rounding in either framework."""
    a = TSCH.alpha_bar.double().numpy()
    return (np.sqrt(1 - a) / (1 - a + a * s * s)).astype(np.float32)


def _eps_pair(slot_aware: bool):
    f = _factor()
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    if slot_aware:
        def jeps(x2, t):
            return x2 * jnp.repeat(jf[t], x2.shape[0] // t.shape[0])[:, None]

        def teps(x2, t):
            return x2 * tf[t.long()].repeat_interleave(
                x2.shape[0] // t.shape[0])[:, None]
        jeps.slot_tile_aware = teps.slot_tile_aware = True
        return jeps, teps

    def jeps(x, t):
        return x * jf[t].reshape((-1,) + (1,) * (x.ndim - 1))

    def teps(x, t):
        return x * tf[t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
    return jeps, teps


# ------------------------------------------------------- errors and queue
def test_reject_codes_equal_jax():
    assert ([(c.name, c.value) for c in RejectCode]
            == [(c.name, c.value) for c in jerrors.RejectCode])
    for c in RejectCode:
        j = jerrors.RejectCode[c.name]
        assert c.http_status == j.http_status
        e, je = (RequestError(c, "m", retry_after_s=3),
                 jerrors.RequestError(j, "m", retry_after_s=3))
        assert isinstance(e, ValueError)
        assert e.status == je.status and e.payload() == je.payload()


def test_queue_edf_pop_expiry_and_backpressure_equal_jax():
    """A virtual-clock replay of submits, pops, requeues and removals:
    the same pops, expiries and refusals in the same order."""
    rs = np.random.RandomState(0)
    jq, tq = JQueue(max_depth=6), AdmissionQueue(max_depth=6)
    log = {"j": [], "t": []}
    for step in range(60):
        now = float(step)
        op = rs.randint(4)
        if op <= 1:
            rid = step
            dl = (None if rs.rand() < 0.3
                  else now + float(rs.randint(0, 12)))
            for key, q, R in (("j", jq, JReq), ("t", tq, SampleRequest)):
                log[key].append(("submit", rid,
                                 q.submit(R(request_id=rid, deadline=dl),
                                          now)))
        elif op == 2:
            requeue = rs.rand() < 0.2
            for key, q in (("j", jq), ("t", tq)):
                req, missed = q.pop(now)
                log[key].append(("pop", None if req is None
                                 else req.request_id,
                                 [m.request_id for m in missed]))
                if req is not None and requeue:
                    q.requeue(req, now)
        else:
            mod = int(rs.randint(2, 5))
            for key, q in (("j", jq), ("t", tq)):
                log[key].append(("remove", [
                    r.request_id for r in q.remove_if(
                        lambda r: r.request_id % mod == 0)]))
    assert log["t"] == log["j"]
    for key, q in (("j", jq), ("t", tq)):
        log[key].append(([r.request_id for r in q.pending_requests()],
                         q.submitted, q.rejected, q.expired, len(q)))
        log[key].append([r.request_id for r in q.drain_pending()])
    assert log["t"] == log["j"] and len(tq) == 0


# ------------------------------------------------- seed stream, layouts
def test_tick_seed_stream_bitwise():
    rs = np.random.RandomState(1)
    seeds = rs.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ks = rs.randint(0, 1000, 4096).astype(np.uint32)
    want = np.asarray(_fmix32(seeds ^ (ks * _GOLDEN)))
    got = fmix32_u32(seeds ^ (ks * np.uint32(GOLDEN)))
    assert GOLDEN == int(_GOLDEN)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rps", [1, 8, 16])
def test_expand_slot_coefs_and_derive_row_seeds_bitwise(rps):
    rs = np.random.RandomState(rps)
    coefs = rs.rand(5, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tops.expand_slot_coefs(torch.from_numpy(coefs), rps).numpy(),
        np.asarray(jops.expand_slot_coefs(jnp.asarray(coefs), rps)))
    seeds = rs.randint(-2 ** 31, 2 ** 31, 5).astype(np.int32)
    np.testing.assert_array_equal(
        tops.derive_row_seeds(torch.from_numpy(seeds), rps).numpy(),
        np.asarray(jops.derive_row_seeds(jnp.asarray(seeds), rps)))


# -------------------------------------------------------- slot_tile_step
STEP_CASES = {
    "det": dict(),
    "stochastic": dict(stochastic=True),
    "clip": dict(clip_x0=1.0),
    "preview": dict(want_x0=True),
    "order2": dict(order=2),
    "order3-stochastic-preview": dict(order=3, stochastic=True,
                                      want_x0=True),
}


def _random_states(B, order, rs):
    """Slot states drawn from real plan rows (each slot its own plan and
    position; multistep plans are deterministic), seeds random, AB
    weights from the plans' tables."""
    cols = {k: np.zeros(B, np.float32) for k in COEFS}
    t = np.zeros(B, np.int32)
    w = np.zeros((B, order), np.float32)
    for b in range(B):
        o = order if b % 2 == 0 else 1     # order-1 slots ride along
        tab = SamplerPlan.build(TSCH, TauSpec(
            kind=("uniform", "quadratic")[b % 2], S=int(rs.randint(3, 30))),
            sigma=float(b % 3) / 2 if o == 1 else 0.0, order=o).steps()
        k = int(rs.randint(len(tab["t"])))
        t[b] = tab["t"][k]
        for c in COEFS:
            cols[c][b] = tab[c][k]
        w[b, :tab["solver_w"].shape[1]] = tab["solver_w"][k]
    seed = rs.randint(-2 ** 31, 2 ** 31, B).astype(np.int32)
    return t, cols, seed, w


@pytest.mark.parametrize("slot_aware", [True, False],
                         ids=["slot-aware", "adapter"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_slot_tile_step_vs_jax(case, slot_aware):
    kw = dict(STEP_CASES[case])
    order = kw.pop("order", 1)
    B, shape = 3, (7, 23)
    rs = np.random.RandomState(5)
    t, cols, seed, w = _random_states(B, order, rs)
    x = rs.randn(B, *shape).astype(np.float32)
    x2 = np.array(jops.to_slot_tile_layout(jnp.asarray(x))[0])
    hist = (rs.randn(order - 1, *x2.shape).astype(np.float32)
            if order > 1 else None)
    jstates = JStepStates(
        t=jnp.asarray(t), **{c: jnp.asarray(cols[c]) for c in COEFS},
        seed=jnp.asarray(seed),
        solver_w=jnp.asarray(w) if order > 1 else None)
    tstates = StepStates(
        t=torch.from_numpy(t), **{c: torch.from_numpy(cols[c])
                                  for c in COEFS},
        seed=torch.from_numpy(seed),
        solver_w=torch.from_numpy(w) if order > 1 else None)
    jeps, teps = _eps_pair(slot_aware)
    want = j_slot_tile_step(
        jeps, jnp.asarray(x2), jstates, shape,
        hist2=None if hist is None else jnp.asarray(hist), **kw)
    got = slot_tile_step(
        teps, torch.from_numpy(x2), tstates, shape,
        hist2=None if hist is None else torch.from_numpy(hist), **kw)
    want = [np.asarray(a) for a in _flat(want)]
    got = [a.numpy() for a in _flat(got)]
    assert len(want) == len(got) == 1 + kw.get("want_x0", False) + (
        order > 1)
    for g, wv in zip(got, want):
        if case == "det":
            np.testing.assert_array_equal(g, wv)
        else:
            tol = STEP_ULPS * F32_ULP * max(np.abs(wv).max(), 1.0)
            assert np.abs(g - wv).max() <= tol, case


def _flat(o):
    """(out | (out, x0)) or ((out | (out, x0)), hist) -> list of arrays."""
    o = o if isinstance(o, tuple) else (o,)
    return [a for v in o for a in (v if isinstance(v, tuple) else (v,))]


def test_sample_step_replays_tile_resident_run_bitwise():
    """Driving ``sample_step`` over a request's ``step_table`` reproduces
    the whole tile-resident run bit for bit (eta=0), and each step equals
    JAX ``sample_step`` bitwise (one multiply of eps, the same FMAs)."""
    cfg = SamplerConfig(S=12, tau_kind="quadratic")
    jeps, teps = _eps_pair(slot_aware=False)
    x_T = np.random.RandomState(3).randn(1, 7, 23).astype(np.float32)
    ref = cfg.to_plan(TSCH).run(teps, torch.from_numpy(x_T),
                                backend="tile_resident")
    tab = step_table(TSCH, cfg)
    x, jx = torch.from_numpy(x_T), jnp.asarray(x_T)
    for k in range(cfg.S):
        row = {c: np.array([tab[c][k]], np.float32) for c in COEFS}
        t = np.array([tab["t"][k]], np.int32)
        x = sample_step(TSCH, teps, x, StepStates(
            t=torch.from_numpy(t),
            **{c: torch.from_numpy(v) for c, v in row.items()}))
        jx = j_sample_step(JSCH, jeps, jx, JStepStates(
            t=jnp.asarray(t), **{c: jnp.asarray(v) for c, v in row.items()}))
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert torch.equal(x, ref)


# -------------------------------------------------- engine against engine
def _x_rows(shape, rid):
    x = np.random.RandomState(1000 + rid).randn(1, *shape).astype(np.float32)
    return x, np.array(jops.to_slot_tile_layout(jnp.asarray(x))[0])


def _requests(spec, shape, J: bool):
    """The request list for one engine; spec rows (rid, S, eta, tau, order,
    deadline, preview_every)."""
    R, Ck, Plan, Tau, sch = ((JReq, JCk, JPlan, JTau, JSCH) if J else
                             (SampleRequest, SlotCheckpoint, SamplerPlan,
                              TauSpec, TSCH))
    out, previews = [], []
    for rid, S, eta, tau, order, dl, pe in spec:
        _, rows = _x_rows(shape, rid)
        rows = rows if J else torch.from_numpy(rows)
        plan = (Plan.build(sch, Tau(kind=tau, S=S), sigma=eta, order=order)
                if order > 1 else None)
        out.append(R(request_id=rid, S=S, eta=eta, tau_kind=tau, plan=plan,
                     seed=rid, deadline=dl, preview_every=pe,
                     on_preview=lambda i, k, x0: previews.append(
                         (i, k, np.asarray(x0))),
                     resume=Ck(request_id=rid, k=0, x_rows=rows,
                               hist_rows=None)))
    return out, previews


def _drive(eng, reqs, n_submit_first):
    """Submit some requests at t=0, tick, submit the rest mid-flight, and
    tick to the end on a virtual clock; returns (results by id, per-tick
    residency)."""
    results, resident = {}, []
    for r in reqs[:n_submit_first]:
        if not eng.submit(r, now=0.0):
            results[r.request_id] = ("rejected",)
    now = 0.0
    late = list(reqs[n_submit_first:])
    while len(eng.queue) or eng.active or late:
        now += 1.0
        if now == 3.0:
            for r in late:
                if not eng.submit(r, now=now):
                    results[r.request_id] = ("rejected",)
            late = []
        for res in eng.tick(now=now):
            results[res.request_id] = res
        resident.append([(b, q.request_id)
                         for b, q in eng.resident_requests()])
    return results, resident


ENGINE_CASES = {
    # mixed S, tau, eta and order on one stochastic multistep engine, with
    # a queue bound and deadlines that expire in the queue
    "mixed": (dict(stochastic=True, max_order=3, max_queue=7), 3, [
        (0, 6, 0.0, "uniform", 1, None, 0),
        (1, 9, 0.0, "quadratic", 2, None, 0),
        (2, 4, 0.0, "quadratic", 3, None, 0),
        (3, 12, 0.5, "uniform", 1, 2.5, 0),
        (4, 5, 0.0, "uniform", 2, None, 0),
        (5, 7, 1.0, "uniform", 1, 0.5, 0),
        (6, 8, 0.0, "quadratic", 1, 40.0, 0),
        (7, 3, 0.0, "uniform", 3, None, 0),
        (8, 10, 0.0, "quadratic", 3, None, 0),
        (9, 4, 0.0, "uniform", 1, None, 0),
        (10, 6, 0.0, "uniform", 2, 3.5, 0),
        (11, 5, 1.0, "uniform", 1, None, 0),
    ]),
    "clip": (dict(clip_x0=1.0), 2, [
        (0, 5, 0.0, "uniform", 1, None, 0),
        (1, 8, 0.0, "quadratic", 1, None, 0),
        (2, 3, 0.0, "uniform", 1, None, 0),
        (3, 6, 0.0, "quadratic", 1, None, 0),
    ]),
    "preview": (dict(preview=True, stochastic=True), 2, [
        (0, 7, 0.0, "uniform", 1, None, 2),
        (1, 9, 1.0, "quadratic", 1, None, 3),
        (2, 4, 0.0, "uniform", 1, None, 1),
        (3, 6, 1.0, "uniform", 1, None, 0),
    ]),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax_engine(case):
    kw, slots, spec = ENGINE_CASES[case]
    shape = (7, 23)
    jeps, teps = _eps_pair(slot_aware=False)
    jreqs, jprev = _requests(spec, shape, J=True)
    treqs, tprev = _requests(spec, shape, J=False)
    jobs, tobs = JObs(), Observability()
    jsink, tsink = jobs.add_sink(JListSink()), tobs.add_sink(ListSink())
    jeng = JEngine(JSCH, jeps, shape, slots=slots, obs=jobs, **kw)
    teng = ContinuousBatchingEngine(TSCH, teps, shape, slots=slots,
                                    device="cpu", obs=tobs, **kw)
    first = len(spec) * 2 // 3
    jres, jresident = _drive(jeng, jreqs, first)
    tres, tresident = _drive(teng, treqs, first)
    assert sorted(tres) == sorted(jres) == sorted(s[0] for s in spec)
    assert tresident == jresident              # slot assignment, tick by tick
    js, ts = jeng.stats(), teng.stats()
    for key in ("ticks", "completed", "dropped", "deadline_missed",
                "previews_sent", "occupancy", "slot_steps", "queue_rejected",
                "compiled_ticks", "mega_tick", "tick_variant"):
        assert ts[key] == js[key], key
    assert ts["compiled_ticks"] == 1
    assert set(ts) <= set(js)
    for rid, j in jres.items():
        t = tres[rid]
        if j == ("rejected",):
            assert t == ("rejected",)
            continue
        assert (t.dropped, t.deadline_missed, t.S, t.previews, t.admit_t,
                t.finish_t) == (j.dropped, j.deadline_missed, j.S,
                                j.previews, j.admit_t, j.finish_t)
        if j.x0 is None:
            assert t.x0 is None
            continue
        x_T, _ = _x_rows(shape, rid)
        scale = max(np.abs(j.x0).max(), np.abs(x_T).max())
        assert t.x0.shape == shape
        assert np.abs(t.x0.numpy() - j.x0).max() <= ENGINE_TOL_OF_SCALE * scale
    # the same span events: kinds, clock, slots, waits, plan digests
    assert tsink.events == jsink.events and len(tsink.events) > 3 * len(spec)
    assert [p[:2] for p in tprev] == [p[:2] for p in jprev]
    for t, j in zip(tprev, jprev):
        assert np.abs(t[2] - j[2]).max() <= ENGINE_TOL_OF_SCALE * max(
            np.abs(j[2]).max(), 1.0)
    if case == "mixed":   # the case exercises what it claims to
        assert js["dropped"] >= 2 and js["queue_rejected"] >= 1
        assert any(r != ("rejected",) and r.dropped and r.deadline_missed
                   for r in jres.values())


def test_states_bitwise_vs_jax_engine_over_churn():
    """The per-tick slot states (t, the five coefficient columns, seeds and
    AB weights) equal the JAX engine's bitwise while slots retire and
    refill, idle slots included."""
    jeps, teps = _eps_pair(slot_aware=False)
    shape = (16,)
    spec = [(i, S, eta, tau, order, None, 0) for i, (S, eta, tau, order)
            in enumerate([(3, 1.0, "uniform", 1), (7, 0.0, "quadratic", 3),
                          (2, 0.0, "uniform", 2), (5, 1.0, "quadratic", 1),
                          (4, 0.0, "uniform", 2), (6, 0.0, "uniform", 3)])]
    engines = []
    for J in (True, False):
        reqs, _ = _requests(spec, shape, J=J)
        eng = (JEngine(JSCH, jeps, shape, slots=4, stochastic=True,
                       max_order=3) if J else
               ContinuousBatchingEngine(TSCH, teps, shape, slots=4,
                                        stochastic=True, max_order=3,
                                        device="cpu"))
        for r in reqs:
            eng.submit(r, now=0.0)
        engines.append(eng)
    jeng, teng = engines
    n = 0
    while jeng.active or len(jeng.queue):
        n += 1
        jeng._admit(float(n), [])
        teng._admit(float(n), [])
        js, ts = jeng._states(), teng._states()
        for f in ("t",) + COEFS + ("seed", "solver_w"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        jeng.tick(now=float(n))
        teng.tick(now=float(n))
    assert n == teng.ticks > 7 and teng.active == 0


def test_engine_compiled_once_under_churn():
    _, teps = _eps_pair(slot_aware=True)
    eng = ContinuousBatchingEngine(TSCH, teps, (100,), slots=3,
                                   stochastic=True, max_order=2,
                                   device="cpu")
    rng = np.random.RandomState(0)
    for wave in range(3):
        for i in range(5):
            eng.submit(SampleRequest(
                request_id=wave * 10 + i, S=int(rng.randint(2, 12)),
                eta=float(i % 2), tau_kind=("quadratic" if i % 2 else
                                            "linear"), seed=i))
        res = eng.run()
        assert all(torch.isfinite(r.x0).all() for r in res)
    assert eng._traces == 1 and eng.stats()["compiled_ticks"] == 1
    assert eng.completed == 15


@pytest.mark.parametrize("max_order", [1, 2])
def test_snapshot_write_back_resume_is_bitwise(max_order):
    """A slot checkpointed mid-flight and resumed in a fresh engine ends on
    the uninterrupted eta=0 output bit for bit."""
    _, teps = _eps_pair(slot_aware=False)
    shape = (7, 23)
    plan = SamplerPlan.build(TSCH, 10, order=max_order)

    def engine():
        return ContinuousBatchingEngine(TSCH, teps, shape, slots=2,
                                        max_order=max_order, device="cpu")

    ref = engine().serve([SampleRequest(request_id=0, plan=plan, seed=4)])
    eng = engine()
    eng.submit(SampleRequest(request_id=0, plan=plan, seed=4), now=0.0)
    for i in range(4):
        eng.tick(now=float(i + 1))
    ck = eng.snapshot_slots()[0]
    assert ck.k == 4 and ck.request_id == 0
    # writing the snapshot back into its own slot changes nothing
    b = eng.resident_requests()[0][0]
    eng.write_slot_rows(b, ck.x_rows, ck.hist_rows)
    (req,) = eng.evict_residents()
    assert eng.active == 0
    req.resume = ck
    fresh = engine()
    fresh.submit(req, now=10.0)
    res = fresh.run()
    assert fresh.stats()["resumed"] == 1
    assert torch.equal(res[0].x0, ref[0].x0)


def test_cancel_and_stats_keys():
    _, teps = _eps_pair(slot_aware=False)
    eng = ContinuousBatchingEngine(TSCH, teps, (16,), slots=1, device="cpu")
    for i in range(3):
        eng.submit(SampleRequest(request_id=i, S=4), now=0.0)
    eng.tick(now=1.0)
    assert eng.cancel(0, now=1.5) and eng.cancel(2, now=1.5)
    assert not eng.cancel(7)
    res = eng.run()
    assert [r.request_id for r in res] == [1]
    s = eng.stats()
    assert s["cancelled"] == 2 and s["completed"] == 1
    eng.reset_stats()
    assert eng.stats()["ticks"] == 0 and eng.stats()["compiled_ticks"] == 1


# -------------------------------------------------- defaults and refusals
def test_continuous_and_engine_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, teps = _eps_pair(slot_aware=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(TSCH, teps, (16,), slots=2)
    svc = DiffusionSampler(TSCH, teps, (16,), batch_size=2, device="cpu")
    eng = svc.continuous(slots=3, max_order=2)
    assert eng.device.type == "cpu" and eng.slots == 3
    with pytest.raises(RuntimeError, match="CUDA"):
        svc.continuous(slots=2, device=None)


def test_not_ported_arguments_raise():
    """The engine's ``mesh=`` (sharded pools) on a simulated (2, 1) CPU
    mesh: the rows split over the data axis, x0 bitwise the unsharded
    engine's (the step is per row); a device other than the mesh's
    first, or a block off B2's 8-row granule, raises."""
    from repro_torch.launch.mesh import make_host_mesh
    _, teps = _eps_pair(slot_aware=False)
    cpu2 = [torch.device("cpu")] * 2
    mesh = make_host_mesh(devices=cpu2)
    eng = ContinuousBatchingEngine(TSCH, teps, (16,), slots=2, device="cpu",
                                   mesh=mesh)
    ref = ContinuousBatchingEngine(TSCH, teps, (16,), slots=2, device="cpu")
    reqs = [SampleRequest(request_id=i, S=4, seed=i) for i in range(3)]
    got = {r.request_id: r.x0 for r in eng.serve(reqs)}
    assert all(torch.equal(got[r.request_id], r.x0) for r in ref.serve(reqs))
    st = eng.stats()
    assert st["mesh"] == {"data": 2, "model": 1} and st["state_sharded"]
    with pytest.raises(ValueError, match="first device"):
        ContinuousBatchingEngine(TSCH, teps, (16,), slots=2, mesh=mesh,
                                 device="meta")
    with pytest.raises(ValueError, match="8-row granule"):
        ContinuousBatchingEngine(TSCH, teps, (16,), slots=3, device="cpu",
                                 mesh=make_host_mesh(devices=cpu2 * 3))


def test_request_refusals_carry_jax_codes():
    _, teps = _eps_pair(slot_aware=False)
    eng = ContinuousBatchingEngine(TSCH, teps, (16,), slots=2, device="cpu")
    cases = [
        (SampleRequest(request_id=0, eta=1.0),
         RejectCode.STOCHASTIC_UNSUPPORTED),
        (SampleRequest(request_id=1, S=0), RejectCode.BAD_STEPS),
        (SampleRequest(request_id=2, plan=SamplerPlan.build(TSCH, 4, x0=1.0)),
         RejectCode.CLIP_MISMATCH),
        (SampleRequest(request_id=3, plan=SamplerPlan.build(TSCH, 4,
                                                            order=2)),
         RejectCode.ORDER_UNSUPPORTED),
        (SampleRequest(request_id=4, plan=SamplerPlan.build(
            make_schedule("cosine", 1000), 4)),
         RejectCode.SCHEDULE_MISMATCH),
    ]
    for req, code in cases:
        with pytest.raises(RequestError) as e:
            eng.submit(req)
        assert e.value.code is code and e.value.status == 400
    assert len(eng.queue) == 0
