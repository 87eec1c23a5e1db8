"""The port's device-probe tier, flight recorder and weight hot-swap
against the JAX package's.

The same seeded numpy inputs go through JAX ``device_frame`` and the
port's; engines on both sides serve the same requests on a virtual clock
with the analytic eps model of ``test_torch_scheduler.py`` (eps = x * f[t],
one rounding in either framework) and the same x_T; the JAX engine runs
its Pallas kernels in interpret mode, the port takes its plain versions.

Tolerances:
  * probe frames: NaN positions exact; values within 4 float32 ulps of
    each column's max magnitude (the reductions sum in another order).
    On an order-2 engine the Adams–Bashforth state itself differs between
    the frameworks by a few ulps after its first mixed step (the combine
    rounds differently; ``test_torch_scheduler.py`` holds a step to 8
    ulps), so its frames are held to 8 ulps of each column's scale.
  * probes-off against a probe-less engine, and a swapped engine against
    a fresh one built on the new weights: bitwise.
  * flight JSONL, attribution and weight-corruption verdicts: exact.
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import obs as jobs
from repro.core import StepStates as JStepStates
from repro.core import make_schedule as j_make_schedule
from repro.kernels.sampler_step import ops as jops
from repro.obs.probes import device_frame as j_device_frame
from repro.sampling import SamplerPlan as JPlan
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import SampleRequest as JReq
from repro.serving.scheduler import SlotCheckpoint as JCk
from repro_torch import obs, prng
from repro_torch.core import StepStates, make_schedule
from repro_torch.obs.probes import device_frame
from repro_torch.obs.schema import FLIGHT_FRAME_KEYS, PROBE_COLUMNS
from repro_torch.sampling import SamplerPlan
from repro_torch.serving import (ContinuousBatchingEngine, SampleRequest,
                                 SlotCheckpoint)

F32_ULP = float(np.finfo(np.float32).eps)
FRAME_ULPS = 4
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)
SHAPE = (7, 23)
COL = {c: i for i, c in enumerate(PROBE_COLUMNS)}


def _factor(scale=1.0):
    a = TSCH.alpha_bar.double().numpy()
    return (scale * np.sqrt(1 - a) / (1 - a + a * 0.25)).astype(np.float32)


def _eps_pair():
    jf, tf = jnp.asarray(_factor()), torch.from_numpy(_factor())

    def jeps(x, t):
        return x * jf[t].reshape((-1,) + (1,) * (x.ndim - 1))

    def teps(x, t):
        return x * tf[t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
    return jeps, teps


def _x_rows(rid):
    x = np.random.RandomState(500 + rid).randn(1, *SHAPE).astype(np.float32)
    return np.array(jops.to_slot_tile_layout(jnp.asarray(x))[0])


def _requests(spec, J: bool):
    """(rid, S, order, submit time) rows -> requests with the same x_T."""
    R, Ck, Plan, sch = ((JReq, JCk, JPlan, JSCH) if J else
                        (SampleRequest, SlotCheckpoint, SamplerPlan, TSCH))
    out = []
    for rid, S, order, _ in spec:
        rows = _x_rows(rid)
        out.append(R(request_id=rid, seed=rid,
                     plan=Plan.build(sch, S, order=order),
                     resume=Ck(request_id=rid, k=0, hist_rows=None,
                               x_rows=rows if J else torch.from_numpy(rows))))
    return out


def _assert_frame_close(got, want, what="", ulps=FRAME_ULPS):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape == (want.shape[0], len(PROBE_COLUMNS))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    for c in range(want.shape[1]):
        w = want[:, c][~np.isnan(want[:, c])]
        if w.size:
            tol = ulps * F32_ULP * max(np.abs(w).max(), 1e-30)
            g = got[:, c][~np.isnan(got[:, c])]
            assert np.abs(g - w).max() <= tol, (what, PROBE_COLUMNS[c])


# ------------------------------------------------------------ device_frame
FLAGS = list(itertools.product([True, False], repeat=4))


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["".join("1" if f else "0" for f in fl)
                              for fl in FLAGS])
def test_device_frame_matches_jax(flags):
    eps_norm, x0_stats, finite, defect = flags
    rs = np.random.RandomState(sum(2 ** i for i, f in enumerate(flags) if f))
    B, rps, n_live = 4, 3, 3 * 256 - 37
    x_in, x_new, eps, prev = (rs.randn(B * rps, 256).astype(np.float32)
                              for _ in range(4))
    x_new[rps + 1, 7] = np.nan          # slot 1 goes non-finite
    x_new[3 * rps, 0] = np.inf          # slot 3 too
    x_new[2 * rps + 2, 255] = np.nan    # slot 2: only in the padding
    sa = rs.uniform(0.05, 1.0, B).astype(np.float32)
    s1 = np.sqrt(1 - sa ** 2).astype(np.float32)
    sa[3], s1[3] = 1.0, 0.0             # an idle slot's row
    t = rs.randint(1, 1000, B).astype(np.int32)
    zeros = np.zeros(B, np.float32)
    jspec, tspec = (jobs.ProbeSpec(*flags), obs.ProbeSpec(*flags))
    assert tspec.describe() == jspec.describe()
    jst = JStepStates(t=jnp.asarray(t), c_x0=jnp.asarray(zeros),
                      c_dir=jnp.asarray(zeros), c_noise=jnp.asarray(zeros),
                      sqrt_a_t=jnp.asarray(sa), sqrt_1m_a_t=jnp.asarray(s1))
    tst = StepStates(t=torch.from_numpy(t), c_x0=torch.from_numpy(zeros),
                     c_dir=torch.from_numpy(zeros),
                     c_noise=torch.from_numpy(zeros),
                     sqrt_a_t=torch.from_numpy(sa),
                     sqrt_1m_a_t=torch.from_numpy(s1))
    for with_prev in (True, False):
        want = j_device_frame(jspec, jnp.asarray(x_in), jnp.asarray(x_new),
                              jnp.asarray(eps),
                              jnp.asarray(prev) if with_prev else None, jst,
                              rps=rps, n_live=n_live)
        got = device_frame(tspec, torch.from_numpy(x_in),
                           torch.from_numpy(x_new), torch.from_numpy(eps),
                           torch.from_numpy(prev) if with_prev else None,
                           tst, rps=rps, n_live=n_live)
        assert got.dtype == torch.float32
        _assert_frame_close(got.numpy(), np.asarray(want), f"prev={with_prev}")
    if finite:
        fin = got[:, COL["finite_frac"]].numpy()
        assert fin[0] == fin[2] == 1.0 and fin[1] < 1.0 and fin[3] < 1.0


def test_normalize_probes_and_spec():
    assert obs.ProbeSpec() == obs.ProbeSpec() and hash(obs.ProbeSpec())
    from repro_torch.obs.probes import normalize_probes
    assert normalize_probes(None) is normalize_probes(False) is None
    assert normalize_probes(True) == obs.ProbeSpec()
    spec = obs.ProbeSpec(defect=False)
    assert normalize_probes(spec) is spec
    with pytest.raises(TypeError):
        normalize_probes("yes")
    assert obs.ProbeSpec(False, False, False, False).describe() == "none"


# ------------------------------------------------ probed engine vs JAX's
PROBE_REPLAY = {  # (rid, S, order, submit time)
    1: [(0, 5, 1, 0.0), (1, 3, 1, 0.0), (2, 4, 1, 0.0), (3, 6, 1, 0.3),
        (4, 2, 1, 0.3)],
    2: [(0, 5, 2, 0.0), (1, 3, 1, 0.0), (2, 4, 2, 0.0), (3, 6, 2, 0.3),
        (4, 2, 1, 0.3)],
}


@pytest.mark.parametrize("order", [1, 2])
def test_probed_engine_matches_jax(order):
    spec = PROBE_REPLAY[order]
    jeps, teps = _eps_pair()
    jfl, tfl = jobs.FlightRecorder(64, pool_id=3), obs.FlightRecorder(
        64, pool_id=3)
    jeng = JEngine(JSCH, jeps, SHAPE, slots=2, max_order=order,
                   probes=True, flight=jfl, pool_id=3)
    teng = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2,
                                    max_order=order, probes=True,
                                    flight=tfl, pool_id=3, device="cpu")
    results = []
    for eng, J in ((jeng, True), (teng, False)):
        reqs, res, now = list(zip(_requests(spec, J), spec)), {}, 0.0
        while reqs or len(eng.queue) or eng.active:
            for r, s in [p for p in reqs if p[1][3] <= now]:
                eng.submit(r, now=now)
            reqs = [p for p in reqs if p[1][3] > now]
            now = round(now + 0.1, 9)
            res.update((r.request_id, r) for r in eng.tick(now=now))
        results.append(res)
    jres, tres = results
    jfr, tfr = jfl.frames(), tfl.frames()
    assert len(tfr) == len(jfr) == teng.ticks == jeng.ticks > 5
    for t, j in zip(tfr, jfr):
        assert {k: t[k] for k in ("tick", "now", "pool", "slots")} == \
            {k: j[k] for k in ("tick", "now", "pool", "slots")}
        _assert_frame_close(t["values"], j["values"], f"tick {j['tick']}",
                            FRAME_ULPS if order == 1 else 8)
    assert teng.last_frame["slots"] == jeng.last_frame["slots"]
    assert sorted(tres) == sorted(jres) == list(range(len(spec)))
    for rid, j in jres.items():
        tq, jq = tres[rid].quality, j.quality
        assert tq.keys() == jq.keys() and tq["frames"] == jq["frames"]
        assert tq["finite_frac_min"] == jq["finite_frac_min"] == 1.0
        for k in ("eps_rms_last", "defect_max", "defect_mean"):
            assert (tq[k] is None) == (jq[k] is None), k
            if jq[k] is not None:
                assert abs(tq[k] - jq[k]) <= 16 * F32_ULP * abs(jq[k]), k
    ts, js = teng.stats(), jeng.stats()
    for key in ("probes", "probe_frames", "compiled_ticks", "ticks",
                "completed"):
        assert ts[key] == js[key], key
    assert ts["probe_finite_min"] == js["probe_finite_min"] == 1.0
    assert abs(ts["probe_defect_max"] - js["probe_defect_max"]) <= (
        FRAME_ULPS * F32_ULP * js["probe_defect_max"])


def _serve(eng, reqs, t0=0.0):
    for r in reqs:
        eng.submit(r, now=t0)
    out, now = {}, t0
    while eng.active or len(eng.queue):
        now += 0.1
        out.update((r.request_id, r) for r in eng.tick(now=now))
    return out


@pytest.mark.parametrize("kw", [dict(), dict(stochastic=True, max_order=2,
                                             preview=True)],
                         ids=["det", "stoch-order2-preview"])
def test_probes_off_bitwise_and_at_most_two_tick_functions(kw):
    _, teps = _eps_pair()

    def reqs():
        return [SampleRequest(request_id=i, S=3 + i, seed=i,
                              eta=float(i % 2) if kw else 0.0,
                              plan=None) for i in range(5)]

    def engine(**extra):
        return ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2,
                                        device="cpu", **kw, **extra)
    plain = _serve(engine(), reqs())
    on_eng = engine(probes=True)
    on = _serve(on_eng, reqs())
    off_eng = engine(probes=True)
    off_eng.set_probes(False)
    off = _serve(off_eng, reqs())
    for rid, r in plain.items():
        assert torch.equal(on[rid].x0, r.x0) and torch.equal(off[rid].x0,
                                                             r.x0)
        assert r.quality is None and off[rid].quality is None
        assert on[rid].quality["frames"] == r.S
    assert on_eng.stats()["compiled_ticks"] == 1
    assert off_eng.stats()["compiled_ticks"] == 1
    assert off_eng.stats()["probes"] == "off"
    for on_ in (True, False, True, False):
        on_eng.set_probes(on_)
        _serve(on_eng, reqs(), t0=10.0)
    assert on_eng.stats()["compiled_ticks"] == 2
    assert on_eng.stats()["probes"] == "off"
    on_eng.set_probes(True)
    assert on_eng.stats()["probes"] == on_eng.probe_spec.describe()


def test_set_probes_without_spec_and_mega_plus_probes_raise():
    _, teps = _eps_pair()
    eng = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2, device="cpu")
    with pytest.raises(RuntimeError, match="probes"):
        eng.set_probes(True)
    eng.set_probes(False)
    assert eng.stats()["probes"] is None
    from repro_torch.diffusion_lm import model as tdlm
    from repro_torch.models.common import ArchConfig
    cfg = tdlm.DiffusionLMConfig(
        arch=ArchConfig(name="t", family="dense", n_layers=2, d_model=64,
                        n_heads=2, n_kv_heads=2, d_ff=128, vocab=50),
        time_dim=32)
    params = tdlm.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    eps = tdlm.make_tile_eps_fn(params, cfg, 2, 64)
    shape = (64, cfg.latent_dim)
    with pytest.raises(ValueError, match="mega") as e:
        ContinuousBatchingEngine(TSCH, eps, shape, slots=2, probes=True,
                                 device="cpu")
    jmsg = ("probes are unavailable on the mega tick variant: the eps "
            "evaluation never leaves the fused megastep kernel")
    assert str(e.value).startswith(jmsg)
    eng = ContinuousBatchingEngine(TSCH, eps, shape, slots=2, probes=True,
                                   use_mega=False, device="cpu")
    assert not eng.use_mega and eng.probe_spec is not None
    res = eng.serve([SampleRequest(request_id=0, S=3)])
    assert res[0].quality["frames"] == 3


# ------------------------------------------------------- flight recorder
def _frame(tick, values, slots_map, pool=0):
    return {"tick": tick, "now": 0.001 * tick, "pool": pool,
            "slots": slots_map, "values": values}


def _row(eps_rms=1.0, finite=1.0, defect=0.01):
    r = [0.0] * len(PROBE_COLUMNS)
    r[COL["eps_rms"]], r[COL["finite_frac"]], r[COL["defect"]] = (
        eps_rms, finite, defect)
    return r


def _ent(rid, k, slot=0):
    return {"slot": slot, "request_id": rid, "k": k}


FRAME_SETS = {
    "nonfinite": [_frame(0, [_row(), _row()], [None, None]),
                  _frame(1, [_row(finite=0.5), _row()],
                         [None, _ent(4, 2, 1)]),
                  _frame(2, [_row(), _row(finite=0.75)],
                         [None, _ent(4, 3, 1)]),
                  _frame(3, [_row(eps_rms=float("nan"), finite=0.25),
                             _row()], [_ent(7, 0), _ent(4, 4, 1)])],
    "smooth": [_frame(i, [_row(eps_rms=1.0 + 0.1 * i)], [_ent(5, i)])
               for i in range(6)],
    "jump": [_frame(i, [_row(eps_rms=1.0 + 0.1 * i)], [_ent(5, i)])
             for i in range(6)] + [_frame(6, [_row(eps_rms=9.0)],
                                          [_ent(5, 6)])],
    "new-request": [_frame(0, [_row(eps_rms=0.1)], [_ent(1, 0)]),
                    _frame(1, [_row(eps_rms=5.0)], [_ent(2, 0)])],
}


@pytest.mark.parametrize("case", list(FRAME_SETS))
def test_flight_ring_dump_and_verdicts_equal_jax(case, tmp_path):
    frames = FRAME_SETS[case]
    assert obs.attribute_nonfinite(frames) == \
        jobs.attribute_nonfinite(frames)
    for factor in (3.0, 10.0):
        assert (obs.detect_weight_corruption(frames, factor=factor)
                == jobs.detect_weight_corruption(frames, factor=factor))
    tfl = obs.FlightRecorder(4, pool_id=2, out_dir=str(tmp_path / "t"))
    jfl = jobs.FlightRecorder(4, pool_id=2, out_dir=str(tmp_path / "j"))
    for fr in frames:
        tfl.record(fr)
        jfl.record(fr)
    assert tfl.frames() == jfl.frames() == frames[-4:]
    assert tfl.snapshot() == jfl.snapshot()
    tpath = tfl.dump("quarantine", error="boom", pump=42, x=float("inf"))
    jpath = jfl.dump("quarantine", error="boom", pump=42, x=float("inf"))
    assert tpath.endswith("flight_pool2_quarantine_000.jsonl")
    for path in (tpath, jpath):     # each package reads the other's dump
        th, tf = obs.read_flight(path)
        jh, jf = jobs.read_flight(path)
        assert (th, tf) == (jh, jf)
    th, tf = obs.read_flight(tpath)
    jh, jf = jobs.read_flight(jpath)
    assert tf == jf and th.pop("wall_time") and jh.pop("wall_time")
    assert th == jh and th["context"]["x"] is None
    assert tfl.dumps == 1 and tfl.dump_paths == [tpath]


def test_flight_recorder_edges(tmp_path):
    fl = obs.FlightRecorder(3, pool_id=1)
    assert fl.dump("anything") is None          # no out_dir: ring only
    with pytest.raises(ValueError):
        obs.FlightRecorder(0)
    bare = tmp_path / "noheader.jsonl"
    bare.write_text('{"record": "frame", "tick": 0}\n')
    with pytest.raises(ValueError, match="header"):
        obs.read_flight(str(bare))


def test_engine_feeds_its_flight_ring(tmp_path):
    _, teps = _eps_pair()
    fl = obs.FlightRecorder(16, pool_id=0, out_dir=str(tmp_path))
    eng = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2, probes=True,
                                   flight=fl, pool_id=0, device="cpu")
    _serve(eng, [SampleRequest(request_id=i, S=4, seed=i) for i in range(3)])
    assert len(fl.frames()) == eng.stats()["probe_frames"] == eng.ticks
    header, frames = obs.read_flight(fl.dump("test"))
    assert header["pool"] == 0 and header["attribution"] is None
    assert all(set(f) == FLIGHT_FRAME_KEYS for f in frames)
    assert all(math.isfinite(v) for f in frames for row in f["values"]
               for v in row[:5] if v is not None)


# ------------------------------------------------------ weight hot-swap
def _param_eps_pair():
    """eps(params, x, t) = x * params["f"][t] * params["s"][0]["g"]."""
    def jeps(p, x, t):
        return x * (p["f"][t] * p["s"][0]["g"]).reshape(
            (-1,) + (1,) * (x.ndim - 1))

    def teps(p, x, t):
        return x * (p["f"][t.long()] * p["s"][0]["g"]).reshape(
            (-1,) + (1,) * (x.dim() - 1))
    return jeps, teps


def _params(scale):
    return {"f": torch.from_numpy(_factor(scale)),
            "s": [{"g": torch.tensor(1.0)}]}


def test_install_eps_params_equals_fresh_engine_bitwise():
    _, teps = _param_eps_pair()

    def reqs(base):
        return [SampleRequest(request_id=base + i, S=3 + i, seed=i)
                for i in range(3)]
    eng = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2,
                                   eps_params=_params(1.0), device="cpu",
                                   probes=True)
    first = _serve(eng, reqs(0))
    n = eng.stats()["compiled_ticks"]
    eng.install_eps_params(_params(0.5))
    assert eng.weight_installs == 1 and eng.stats()["compiled_ticks"] == n
    swapped = _serve(eng, reqs(10))
    fresh = _serve(ContinuousBatchingEngine(
        TSCH, teps, SHAPE, slots=2, eps_params=_params(0.5), device="cpu",
        probes=True), reqs(10))
    assert eng.stats()["compiled_ticks"] == n
    for rid, r in fresh.items():
        assert torch.equal(swapped[rid].x0, r.x0)
        assert not torch.equal(swapped[rid].x0, first[rid - 10].x0)
    eng.reset_stats()
    assert eng.weight_installs == 1


def test_install_eps_params_refusals_match_jax():
    jeps, teps = _param_eps_pair()
    jplain, tplain = _eps_pair()
    jp = {"f": jnp.asarray(_factor()), "s": [{"g": jnp.float32(1.0)}]}
    jeng = JEngine(JSCH, jeps, SHAPE, slots=2, eps_params=jp)
    teng = ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2,
                                    eps_params=_params(1.0), device="cpu")
    with pytest.raises(RuntimeError) as je:
        JEngine(JSCH, jplain, SHAPE, slots=2).install_eps_params(jp)
    with pytest.raises(RuntimeError) as te:
        ContinuousBatchingEngine(TSCH, tplain, SHAPE, slots=2,
                                 device="cpu").install_eps_params({})
    assert str(te.value) == str(je.value)
    bad = [({"f": jp["f"][:10], "s": jp["s"]},
            {"f": _params(1.0)["f"][:10], "s": _params(1.0)["s"]}),
           ({"f": jp["f"].astype(jnp.bfloat16), "s": jp["s"]},
            {"f": _params(1.0)["f"].bfloat16(), "s": _params(1.0)["s"]})]
    for jbad, tbad in bad:
        with pytest.raises(ValueError) as je:
            jeng.install_eps_params(jbad)
        with pytest.raises(ValueError) as te:
            teng.install_eps_params(tbad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="structure differs"):
        jeng.install_eps_params({"f": jp["f"]})
    with pytest.raises(ValueError, match="structure differs") as te:
        teng.install_eps_params({"f": _params(1.0)["f"]})
    assert "only in resident: [('s', 'list[0]', 'g')]" in str(te.value)
    assert teng.weight_installs == 0
    with pytest.raises(ValueError, match="eps_params"):
        ContinuousBatchingEngine(TSCH, teps, SHAPE, slots=2, use_mega=True,
                                 eps_params=_params(1.0), device="cpu")
