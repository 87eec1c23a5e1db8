"""The port's trajectory autotuner (``repro_torch.autoplan``: objective, DP
search, refinement, executor, plan bank) and its serving glue (the
scheduler's ``plan_bank`` / ``auto_plan`` admission and
``DiffusionSampler(plan_bank=)``) against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides; the
forward-process noise is drawn the port's way (``prng.normal`` of the
config's seed, JAX's draw) and injected into JAX's functions.  Eps models, each written in both
frameworks: the closed-form eps of N(mu, s^2) data on shape (2,) / (8,)
(``tests/test_autoplan.py``'s analytic model), and the elementwise mu = 0
case eps = x * f[t] on (8, 8, 3) images (the feature path).

Tolerances:
  * ``make_grid``, DP taus on one shared table, the DP objective: bitwise;
    refinement and search decisions under a deterministic scorer (a
    function of the plan's coefficient table, bitwise equal in both
    packages): the same plan specs, scores and trial counts;
  * the ELBO table inside ``build_objective``: the same +-inf pattern and
    finite entries at rtol 1e-6;
  * ``step_doubling_defect``: adjacent pairs exactly 0 and the same zero
    pattern on both sides; entries at rtol 2e-3 and a median relative
    difference of at most 1e-5.  A defect is the mean square of the gap
    between two nearly equal jumped states (the one-jump and the two-jump
    state, up to 157x |x_t| after a jump from t = 1000 to 0), so an ulp
    of difference in a jump is amplified; XLA:CPU contracts multiply-adds
    into FMAs where PyTorch rounds twice.  Against a float64 evaluation of
    the same formula JAX's own float32 defect is up to 1.4e-3 relative
    off on these inputs, the port's up to 1.8e-3;
    ``test_step_doubling_defect_vs_float64`` holds the port to twice the
    reference's own distance;
  * ``PlanExecutor``: a deterministic plan bitwise against the port's
    ``tile_resident`` and ``eager``, a stochastic one bitwise against
    ``eager`` (one threefry key: JAX's noise); 4 float32 ulps of
    max(|x_T|, |x_0|) against JAX's ``PlanExecutor``, stochastic
    candidates included;
  * ``PlanBank``: JSON equal key for key across the packages; ``best`` /
    ``select`` outcomes equal;
  * engine: NFE picks, counters and span events equal to the JAX engine's;
    x0 within 1e-5 of max(|x0|, |x_T|) of the JAX engine's (as in
    ``test_torch_scheduler.py``) and within 4 float32 ulps of scale of
    JAX's ``jnp`` oracle on one x_T.
"""
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import autoplan as jap
from repro import eval as jeval
from repro.autoplan import objective as jobj
from repro.core import make_schedule as j_make_schedule
from repro.kernels.sampler_step import ops as jops
from repro.obs import ListSink as JListSink
from repro.obs import Observability as JObs
from repro.sampling import SamplerPlan as JPlan
from repro.sampling import SigmaSpec as JSigma
from repro.sampling import TauSpec as JTau
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import SampleRequest as JReq
from repro.serving.scheduler import SlotCheckpoint as JCk
from repro_torch import prng
from repro_torch import autoplan as tap
from repro_torch.autoplan import objective as tobj
from repro_torch.core import SamplerConfig, make_schedule
from repro_torch.obs import ListSink, Observability
from repro_torch.sampling import SamplerPlan, SigmaSpec, TauSpec
from repro_torch.serving import (ContinuousBatchingEngine, DiffusionSampler,
                                 RejectCode, RequestError, SampleRequest,
                                 SlotCheckpoint)

F32_TOL = 2.0 ** -21            # 4 float32 ulps of scale
ENGINE_TOL_OF_SCALE = 1e-5
DEFECT_RTOL, DEFECT_MEDIAN_RTOL = 2e-3, 1e-5
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)
MU, SD = 2.0, 0.5


# ---------------------------------------------------------------- models
def toy_eps_pair(mu=MU, s=SD):
    """The closed-form eps of N(mu, s^2) data, in JAX and in PyTorch."""
    def jeps(x, t):
        a = JSCH.alpha_bar[t].reshape((-1,) + (1,) * (x.ndim - 1))
        return (x - jnp.sqrt(a) * mu) * jnp.sqrt(1 - a) / (1 - a + a * s * s)

    def teps(x, t):
        a = TSCH.alpha_bar.to(x.device)[t.long()].reshape(
            (-1,) + (1,) * (x.dim() - 1))
        return ((x - torch.sqrt(a) * mu) * torch.sqrt(1 - a)
                / (1 - a + a * s * s))
    return jeps, teps


def image_eps_pair(s=SD):
    """eps = x * f[t]: elementwise, one float32 multiply on either side."""
    a = TSCH.alpha_bar.double().numpy()
    f = (np.sqrt(1 - a) / (1 - a + a * s * s)).astype(np.float32)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)

    def jeps(x, t):
        return x * jf[t].reshape((-1,) + (1,) * (x.ndim - 1))

    def teps(x, t):
        return x * tf.to(x.device)[t.long()].reshape(
            (-1,) + (1,) * (x.dim() - 1))
    return jeps, teps


MODELS = {"toy": (toy_eps_pair, (16, 2), MU),
          "image": (image_eps_pair, (3, 8, 8, 3), 0.0)}


def _rand(seed, *shape, loc=0.0, scale=1.0):
    rs = np.random.RandomState(seed)
    return (loc + scale * rs.randn(*shape)).astype(np.float32)


def _port_noise(seed, shape):
    """The forward-process noise ``build_objective`` draws on the CPU."""
    return prng.normal(prng.PRNGKey(seed, "cpu"), shape)


def _assert_elbo_match(t, j):
    """Finite entries at rtol 1e-6 of their mse-scaled part: row 0 holds
    the decoder's log-normalizer on top, a constant that can cancel most
    of the entry."""
    np.testing.assert_array_equal(t.grid, j.grid)
    np.testing.assert_array_equal(t.nodes, j.nodes)
    const = 0.5 * np.log(2.0 * np.pi * j.recon_sigma ** 2)
    for a, b in ((t.trans, j.trans), (t.prior, j.prior)):
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        if a.ndim == 2:
            a, b = a.copy(), b.copy()
            a[0, 1:] -= const
            b[0, 1:] -= const
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6)
    np.testing.assert_allclose(t.mse, j.mse, rtol=1e-6)


def _assert_defect_match(dt, dj):
    assert dt.shape == dj.shape and dt.dtype == np.float64
    np.testing.assert_array_equal(dt == 0.0, dj == 0.0)
    for j in range(1, dt.shape[0]):              # adjacent pairs: exactly 0
        assert dt[j - 1, j] == 0.0 == dj[j - 1, j]
    nz = dj != 0.0
    rel = np.abs(dt - dj)[nz] / np.abs(dj[nz])
    assert rel.max() <= DEFECT_RTOL, rel.max()
    assert np.median(rel) <= DEFECT_MEDIAN_RTOL, np.median(rel)


# --------------------------------------------------------------- objective
def test_make_grid_bitwise():
    for T, size, kind in itertools.product(
            (1000, 50, 10), (2, 7, 16, 48, 64), ("uniform", "quadratic")):
        want = jobj.make_grid(T, size, kind)
        got = tap.make_grid(T, size, kind)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown grid_kind"):
        tap.make_grid(1000, 8, "cubic")


def test_objective_config_validation_matches_jax():
    for kw in (dict(grid_size=1), dict(grid_kind="cubic"),
               dict(quality_weight=-1.0)):
        with pytest.raises(ValueError) as je:
            jap.ObjectiveConfig(**kw)
        with pytest.raises(ValueError) as te:
            tap.ObjectiveConfig(**kw)
        assert str(te.value) == str(je.value)
    assert (dataclasses.asdict(tap.ObjectiveConfig())
            == dataclasses.asdict(jap.ObjectiveConfig()))


@pytest.mark.parametrize("model", list(MODELS))
def test_step_doubling_defect_matches_jax(model):
    pair, shape, loc = MODELS[model]
    jeps, teps = pair()
    grid = tap.make_grid(1000, 8 if model == "toy" else 6, "quadratic")
    x0 = _rand(0, *shape, loc=loc, scale=0.5)
    noise = _rand(1, len(grid), *shape)
    kw = dict(pair_chunk=7, chunk=3)            # several chunks of each
    dj = jobj.step_doubling_defect(JSCH, jeps, jnp.asarray(x0), grid,
                                   jnp.asarray(noise), **kw)
    dt = tobj.step_doubling_defect(TSCH, teps, torch.from_numpy(x0), grid,
                                   torch.from_numpy(noise), **kw)
    _assert_defect_match(dt, dj)
    assert dt[0, -1] > 0.0                      # a long jump bends
    # the default chunking gives the same table
    np.testing.assert_array_equal(
        tobj.step_doubling_defect(TSCH, teps, torch.from_numpy(x0), grid,
                                  torch.from_numpy(noise)), dt)


def _defect64(x0, grid, noise):
    """The toy model's defect in float64 numpy, pair by pair."""
    ab = TSCH.alpha_bar.double().numpy()

    def eps(x, t):
        a = ab[t]
        return (x - np.sqrt(a) * MU) * np.sqrt(1 - a) / (1 - a + a * SD * SD)

    def jump(x, e, t_from, t_to):
        a_f, a_to = ab[t_from], ab[t_to]
        return (np.sqrt(a_to) / np.sqrt(a_f) * x
                + (np.sqrt(1 - a_to) - np.sqrt(a_to / a_f)
                   * np.sqrt(1 - a_f)) * e)

    G = len(grid)
    nodes = np.concatenate([[0], grid])
    out = np.zeros((G + 1, G + 1))
    for j in range(2, G + 1):
        a = ab[grid[j - 1]]
        x_t = np.sqrt(a) * x0 + np.sqrt(1 - a) * noise[j - 1]
        e_t = eps(x_t, grid[j - 1])
        for i in range(j - 1):
            tm = grid[(i + j) // 2 - 1]
            x_m = jump(x_t, e_t, nodes[j], tm)
            gap = (jump(x_t, e_t, nodes[j], nodes[i])
                   - jump(x_m, eps(x_m, tm), tm, nodes[i]))
            out[i, j] = np.mean(gap ** 2)
    return out


def test_step_doubling_defect_vs_float64():
    """Both float32 defects against the float64 formula: the port is no
    farther from it than twice the reference's own distance."""
    jeps, teps = toy_eps_pair()
    grid = tap.make_grid(1000, 8, "quadratic")
    x0 = _rand(0, 16, 2, loc=MU, scale=0.5)
    noise = _rand(1, len(grid), 16, 2)
    exact = _defect64(x0.astype(np.float64), grid, noise.astype(np.float64))
    dj = jobj.step_doubling_defect(JSCH, jeps, jnp.asarray(x0), grid,
                                   jnp.asarray(noise))
    dt = tobj.step_doubling_defect(TSCH, teps, torch.from_numpy(x0), grid,
                                   torch.from_numpy(noise))
    nz = exact > 0
    rel_j = np.abs(dj - exact)[nz] / exact[nz]
    rel_t = np.abs(dt - exact)[nz] / exact[nz]
    assert rel_t.max() <= 2 * rel_j.max() + 1e-5
    assert np.median(rel_t) <= DEFECT_MEDIAN_RTOL
    assert np.median(rel_j) <= DEFECT_MEDIAN_RTOL


@pytest.mark.parametrize("model", list(MODELS))
def test_build_objective_matches_jax(model):
    """The port draws the noise; fed to JAX's _eps_table /
    transition_elbo_table / step_doubling_defect it gives the same
    tables.  x0 rows beyond cfg.batch are dropped on both sides."""
    pair, shape, loc = MODELS[model]
    jeps, teps = pair()
    cfg = tap.ObjectiveConfig(grid_size=7, batch=shape[0], chunk=3, seed=5,
                              eta=0.9, recon_sigma=0.2)
    x0 = _rand(2, shape[0] + 2, *shape[1:], loc=loc, scale=0.5)
    got = tap.build_objective(TSCH, teps, torch.from_numpy(x0), cfg)

    grid = jap.make_grid(1000, cfg.grid_size, cfg.grid_kind)
    jx0 = jnp.asarray(x0[:cfg.batch])
    noise = jnp.asarray(_port_noise(cfg.seed, (len(grid),) + shape).numpy())
    table = jobj._eps_table(JSCH, jeps, jx0, grid, noise, cfg.chunk)
    jelbo = jeval.transition_elbo_table(
        JSCH, jeps, jx0, grid=grid, eta=cfg.eta,
        recon_sigma=cfg.recon_sigma, noise=noise,
        mse=jeval.elbo.eps_mse(table[1], noise))
    jdefect = jobj.step_doubling_defect(JSCH, jeps, jx0, grid, noise,
                                        eps_table=table)
    _assert_elbo_match(got.elbo, jelbo)
    _assert_defect_match(got.defect, jdefect)
    assert got.config is cfg and got.quality_weight == 1.0
    np.testing.assert_array_equal(got.cost, got.elbo.trans + got.defect)
    np.testing.assert_array_equal(got.nodes, np.concatenate([[0], grid]))
    # a caller's key draws the same noise; quality_weight 0 drops the
    # defect
    again = tap.build_objective(TSCH, teps, torch.from_numpy(x0), cfg,
                                rng=prng.PRNGKey(5, "cpu"))
    np.testing.assert_array_equal(again.cost, got.cost)
    elbo_only = tap.build_objective(
        TSCH, teps, torch.from_numpy(x0),
        dataclasses.replace(cfg, quality_weight=0.0))
    assert elbo_only.defect is None
    np.testing.assert_array_equal(elbo_only.cost, got.elbo.trans)


# ------------------------------------------------------------------ search
def _toy_table(grid_size=10, batch=32, seed=0):
    _, teps = toy_eps_pair()
    x0 = torch.from_numpy(_rand(seed, batch, 2, loc=MU, scale=0.5))
    return tap.build_objective(
        TSCH, teps, x0, tap.ObjectiveConfig(grid_size=grid_size, batch=batch,
                                            seed=seed))


def _as_jax_table(t):
    """The JAX ObjectiveTable holding the port table's very arrays."""
    elbo = jeval.TransitionTable(**{
        f.name: getattr(t.elbo, f.name)
        for f in dataclasses.fields(t.elbo)})
    return jobj.ObjectiveTable(
        elbo=elbo, defect=t.defect, quality_weight=t.quality_weight,
        config=jap.ObjectiveConfig(**dataclasses.asdict(t.config)))


def test_dp_search_matches_jax_on_one_table():
    t = _toy_table(grid_size=12)
    j = _as_jax_table(t)
    budgets = (1, 2, 3, 5, 8, 30)
    got, want = tap.dp_search(t, budgets), jap.dp_search(j, budgets)
    assert sorted(got) == sorted(want) == list(budgets)
    for S in budgets:
        assert got[S].taus == want[S].taus and got[S].S == want[S].S
        assert got[S].objective == want[S].objective      # bitwise float64
        assert got[S].tau_spec(T=1000).taus == got[S].taus
    assert got[30].S == 12                    # budgets clamp to the grid
    objs = [got[S].objective for S in (2, 5, 8)]
    assert objs[0] >= objs[1] >= objs[2]      # more budget never hurts
    for bad in ((), (0, 3)):
        with pytest.raises(ValueError) as je:
            jap.dp_search(j, bad)
        with pytest.raises(ValueError) as te:
            tap.dp_search(t, bad)
        assert str(te.value) == str(je.value)


def test_dp_matches_brute_force_enumeration():
    """Exact optimality: DP == min over ALL C(G, S) sub-sequences."""
    tab = _toy_table(grid_size=7)
    cost, prior, nodes = tab.cost, tab.prior, tab.nodes
    G = len(nodes) - 1
    dp = tap.dp_search(tab, (1, 2, 3, 4))
    for S in (1, 2, 3, 4):
        best = np.inf
        for combo in itertools.combinations(range(1, G + 1), S):
            c = prior[combo[-1]] + cost[0, combo[0]]
            for a, b in zip(combo, combo[1:]):
                c += cost[a, b]
            best = min(best, c)
        np.testing.assert_allclose(dp[S].objective, best, rtol=1e-12)
        np.testing.assert_allclose(tab.path_cost(dp[S].taus),
                                   dp[S].objective, rtol=1e-12)


def _table_score(plan):
    """A deterministic scorer of the plan's coefficient table alone (the
    table is bitwise equal in both packages): prefers a little noise and
    the second order, so refinement has moves to make."""
    st = plan.steps()
    return float(abs(float(np.mean(st["c_noise"])) - 0.05)
                 + 0.01 * float(np.sum(st["c_dir"]))
                 + 0.003 / plan.order)


def _spec(plan):
    sig = plan.sigma
    clip = plan.x0.clip if hasattr(plan, "x0") else plan.clip_x0
    return (tuple(plan.tau.taus), sig.kind, sig.eta, sig.etas, sig.sigmas,
            plan.order, clip)


@pytest.mark.parametrize("per_step,passes,clip", [
    (False, 1, None), (True, 1, None), (True, 2, 1.0)])
def test_refine_plan_matches_jax(per_step, passes, clip):
    taus = (20, 60, 150, 400, 1000)
    kw = dict(eta_grid=(0.0, 0.25, 0.5, 1.0), orders=(1, 2, 3),
              per_step_eta=per_step, passes=passes)
    tplan, ts, tn = tap.refine_plan(TSCH, taus, _table_score,
                                    tap.RefineConfig(**kw), clip=clip)
    jplan, js, jn = jap.refine_plan(JSCH, taus, _table_score,
                                    jap.RefineConfig(**kw), clip=clip)
    assert _spec(tplan) == _spec(jplan)
    assert (ts, tn) == (js, jn) and tn > 1
    assert ts <= _table_score(SamplerPlan.build(
        TSCH, TauSpec.explicit(taus), x0=clip))
    if tplan.stochastic:
        assert tplan.order == 1
    for bad in (dict(orders=(0,)), dict(eta_grid=(-0.1,)), dict(passes=0)):
        with pytest.raises(ValueError) as je:
            jap.RefineConfig(**bad)
        with pytest.raises(ValueError) as te:
            tap.RefineConfig(**bad)
        assert str(te.value) == str(je.value)


def _strip_walls(d):
    d = json.loads(json.dumps(d))
    d["search_config"]["wall_s"] = None
    for e in d["entries"]:
        e["wall_s"] = None
    return d


@pytest.mark.parametrize("refine", [None, dict(eta_grid=(0.0, 0.5),
                                               orders=(1, 2))])
def test_search_bank_matches_jax(refine):
    t = _toy_table(grid_size=10)
    j = _as_jax_table(t)
    tcfg = tap.SearchConfig(budgets=(3, 5), refine=(
        None if refine is None else tap.RefineConfig(**refine)))
    jcfg = jap.SearchConfig(budgets=(3, 5), refine=(
        None if refine is None else jap.RefineConfig(**refine)))
    score = None if refine is None else _table_score
    tb = tap.search_bank(TSCH, t, tcfg, score_fn=score, model_digest="m")
    jb = jap.search_bank(JSCH, j, jcfg, score_fn=score, model_digest="m")
    assert tb.nfes == jb.nfes == (3, 5)
    assert _strip_walls(tb.to_json()) == _strip_walls(jb.to_json())
    rec = tap.search_plans(TSCH, t, tcfg, score_fn=score)
    for S, r in rec.items():
        assert r["dp"].taus == tuple(tb.entries[(3, 5).index(S)].meta[
            "dp_taus"]) and r["wall_s"] >= 0.0


# ---------------------------------------------------------------- executor
def _plans(sch, J: bool):
    """Five candidates at S = 4 over three distinct statics, one at S = 2."""
    Plan, Tau = (JPlan, JTau) if J else (SamplerPlan, TauSpec)
    return [Plan.build(sch, tau=Tau.explicit(t)) for t in
            [(5, 50, 500, 1000), (1, 2, 3, 4), (7, 70, 700, 999)]] + [
        Plan.build(sch, tau=Tau.explicit((10, 100, 400, 900)), order=2),
        Plan.build(sch, tau=4, sigma=1.0)]


@pytest.mark.parametrize("model", list(MODELS))
def test_executor_bitwise_to_tile_resident_and_eager(model):
    pair, shape, _ = MODELS[model]
    _, teps = pair()
    ex = tap.PlanExecutor(teps)
    x_T = torch.from_numpy(_rand(3, *shape))
    cands = _plans(TSCH, J=False) + [
        SamplerPlan.build(TSCH, tau=TauSpec.explicit((3, 30, 300, 1000)),
                          x0=1.0),
        SamplerPlan.build(TSCH, tau=5, sigma=SigmaSpec.schedule(
            [0.0, 0.5, 0.0, 1.0, 0.25]))]
    for plan in cands:
        gen = (lambda: prng.PRNGKey(9, "cpu")) if \
            plan.stochastic else (lambda: None)
        out = ex.run(plan, x_T, gen())
        want = plan.run(teps, x_T, gen(), backend="eager")
        assert torch.equal(out, want), plan
        if not plan.stochastic:
            assert torch.equal(out, plan.run(teps, x_T,
                                             backend="tile_resident"))
    assert ex.calls == len(cands)
    bf = x_T.bfloat16()
    assert torch.equal(ex.run(cands[0], bf),
                       cands[0].run(teps, bf, backend="tile_resident"))


def test_executor_one_build_per_statics():
    """Five candidates over three statics build three rollouts; a new S
    builds exactly one more; a stochastic plan needs a key, with JAX's
    message."""
    jeps, teps = toy_eps_pair()
    ex, jex = tap.PlanExecutor(teps), jap.PlanExecutor(jeps)
    x_T = _rand(4, 16, 2)
    cands, jcands = _plans(TSCH, J=False), _plans(JSCH, J=True)
    gen = prng.PRNGKey(1, "cpu")
    for p in cands:
        ex.run(p, torch.from_numpy(x_T), gen if p.stochastic else None)
    statics = {(p.S, p.order, p.stochastic, p.x0.clip) for p in cands}
    assert len(statics) == 3
    assert ex.traces == ex.compiled == 3 and ex.calls == 5
    ex.run(SamplerPlan.build(TSCH, tau=TauSpec.explicit((10, 1000))),
           torch.from_numpy(x_T))
    assert ex.traces == ex.compiled == 4
    ex.run(cands[0], torch.from_numpy(x_T[:8]))          # another shape
    assert ex.traces == 5
    with pytest.raises(ValueError) as te:
        ex.run(cands[-1], torch.from_numpy(x_T))
    with pytest.raises(ValueError) as je:
        jex.run(jcands[-1], jnp.asarray(x_T))
    assert str(te.value) == str(je.value) and "needs rng" in str(te.value)


@pytest.mark.parametrize("model", list(MODELS))
def test_executor_matches_jax_executor(model):
    pair, shape, _ = MODELS[model]
    jeps, teps = pair()
    ex, jex = tap.PlanExecutor(teps), jap.PlanExecutor(jeps)
    x_T = _rand(5, *shape)
    for tp, jp in zip(_plans(TSCH, J=False)[:4], _plans(JSCH, J=True)[:4]):
        got = ex.run(tp, torch.from_numpy(x_T)).numpy()
        want = np.asarray(jex.run(jp, jnp.asarray(x_T)))
        scale = max(np.abs(want).max(), np.abs(x_T).max())
        assert np.abs(got - want).max() <= F32_TOL * scale
    assert ex.traces == jex.traces == 2


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("seed", [0, 9])
def test_executor_stochastic_matches_jax_executor(model, seed):
    """A stochastic candidate scored by both executors on one x_T and one
    key agrees to 4 float32 ulps of max(|x_T|, |x_0|): both draw ``normal``
    of ``split(rng, S)``."""
    pair, shape, _ = MODELS[model]
    jeps, teps = pair()
    ex, jex = tap.PlanExecutor(teps), jap.PlanExecutor(jeps)
    x_T = _rand(6, *shape)
    plans = [(Plan.build(sch, tau=4, sigma=1.0),
              Plan.build(sch, tau=5, sigma=Sig.schedule(
                  [0.0, 0.5, 0.0, 1.0, 0.25])))
             for Plan, sch, Sig in ((SamplerPlan, TSCH, SigmaSpec),
                                    (JPlan, JSCH, JSigma))]
    for tp, jp in zip(*plans):
        assert tp.stochastic and jp.stochastic
        got = ex.run(tp, torch.from_numpy(x_T),
                     prng.PRNGKey(seed, "cpu")).numpy()
        want = np.asarray(jex.run(jp, jnp.asarray(x_T),
                                  jax.random.PRNGKey(seed)))
        scale = max(np.abs(want).max(), np.abs(x_T).max())
        assert np.abs(got - want).max() <= F32_TOL * scale


# ---------------------------------------------------------------- PlanBank
def _toy_bank(J: bool):
    P, T, Sig = (JPlan, JTau, JSigma) if J else (SamplerPlan, TauSpec,
                                                 SigmaSpec)
    sch = JSCH if J else TSCH
    bank = (jap if J else tap).PlanBank(sch, search_config={"note": "test"},
                                        model_digest="t")
    bank.add_plan(P.build(sch, tau=T.explicit([50, 300, 1000])), score=0.3)
    bank.add_plan(P.build(sch, tau=T.explicit([20, 60, 150, 400, 700, 1000]),
                          order=2), score=0.2, objective=1.5,
                  meta={"dp_taus": [20, 1000]})
    bank.add_plan(P.build(
        sch, tau=T.explicit([5, 15, 30, 60, 100, 180, 300, 450, 650, 1000]),
        sigma=Sig.schedule([0.0] * 9 + [0.5])), score=0.1)
    bank.add_entry((jap if J else tap).BankEntry(
        nfe=2, taus=(9, 900), sigma=Sig.explicit([0.0, 0.02]), clip=1.0,
        baselines={"uniform": 0.4}))
    bank.add_entry((jap if J else tap).BankEntry(
        nfe=4, taus=(9, 90, 500, 900), sigma=Sig.ddpm(sigma_hat=True)))
    return bank


def test_bank_json_loads_in_either_package(tmp_path):
    jb, tb = _toy_bank(J=True), _toy_bank(J=False)
    assert tb.to_json() == jb.to_json()
    jp, tp = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jb.save(jp)
    tb.save(tp)
    with open(jp) as f, open(tp) as g:
        assert f.read() == g.read()
    from_jax = tap.PlanBank.load(jp, TSCH)
    from_port = jap.PlanBank.load(tp, JSCH)
    assert from_jax.to_json() == jb.to_json()
    assert from_port.to_json() == tb.to_json()
    for nfe in tb.nfes:
        a, b = from_jax.plan(nfe).steps(), from_port.plan(nfe).steps()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert from_jax.plan(nfe) == tb.plan(nfe)
    assert from_jax.plan(6) is from_jax.plan(6)


def test_bank_validation_matches_jax(tmp_path):
    tb, jb = _toy_bank(J=False), _toy_bank(J=True)
    p = str(tmp_path / "bank.json")
    tb.save(p)
    with pytest.raises(ValueError) as te:
        tap.PlanBank.load(p, make_schedule("cosine", 1000))
    with pytest.raises(ValueError) as je:
        jap.PlanBank.load(p, j_make_schedule("cosine", T=1000))
    assert str(te.value) == str(je.value)
    assert "different noise schedule" in str(te.value)
    d = json.loads(open(p).read())
    d["format"] = "nope"
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="not a PlanBank artifact"):
        tap.PlanBank.load(bad, TSCH)
    cases = [
        lambda m: m[0].add_entry(m[1].BankEntry(nfe=2, taus=(5, 2000))),
        lambda m: m[0].add_entry(m[1].BankEntry(nfe=3, taus=(5, 10))),
        lambda m: m[0].add_plan(m[2].build(m[3], tau=10)),
        lambda m: m[0].plan(7),
    ]
    for case in cases:
        with pytest.raises((ValueError, KeyError)) as te:
            case((tb, tap, SamplerPlan, TSCH))
        with pytest.raises((ValueError, KeyError)) as je:
            case((jb, jap, JPlan, JSCH))
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="different noise schedule"):
        tb.add_plan(SamplerPlan.build(make_schedule("cosine", 1000),
                                      tau=TauSpec.explicit([5, 1000])))


def test_bank_best_and_select_match_jax():
    tb, jb = _toy_bank(J=False), _toy_bank(J=True)
    unset_t, unset_j = tap.bank._UNSET, jap.bank._UNSET
    filters = [dict(), dict(deterministic=True), dict(deterministic=False),
               dict(max_order=1), dict(deterministic=True, max_order=1),
               dict(clip=None), dict(clip=1.0),
               dict(deterministic=True, max_order=1, clip=2.0)]
    S = lambda p: None if p is None else p.S  # noqa: E731
    for flt in filters:
        tflt = {k: v for k, v in flt.items()}
        for max_nfe in (None, 1, 3, 5, 7, 100):
            assert S(tb.best(max_nfe, **tflt)) == S(jb.best(max_nfe, **flt))
        assert ([e.nfe for e in tb.compatible(**tflt)]
                == [e.nfe for e in jb.compatible(**flt)])
        for head, per, margin in itertools.product(
                (float("inf"), 0.0, 0.1, 0.25, 0.95, 1.0, 2.0),
                (None, 0.0, 0.1, 0.3), (0.9, 1.0)):
            tout, jout = [], []
            tp = tb.select(head, per, margin,
                           on_outcome=lambda o, p: tout.append((o, S(p))),
                           **tflt)
            jp = jb.select(head, per, margin,
                           on_outcome=lambda o, p: jout.append((o, S(p))),
                           **flt)
            assert S(tp) == S(jp) and tout == jout and len(tout) == 1
    assert repr(unset_t) == repr(unset_j) == "<unset>"
    # the JAX test's own cases
    bank = tb
    assert bank.best().S == 10 and bank.best(max_nfe=7).S == 6
    assert bank.select(1.0, 0.1, margin=0.9).S == 6
    assert bank.select(0.1, 0.1).S == 2 and bank.select(1.0, None).S == 2


# ---------------------------------------------------- scheduler integration
def _auto_requests(J: bool, shape, x_rows):
    Req, Ck = (JReq, JCk) if J else (SampleRequest, SlotCheckpoint)
    rows = {rid: (jnp.asarray(r) if J else torch.from_numpy(r))
            for rid, r in x_rows.items()}
    explicit = (JPlan if J else SamplerPlan).build(
        JSCH if J else TSCH, tau=(JTau if J else TauSpec).explicit(
            [10, 500, 1000]))

    def ck(rid):
        return Ck(request_id=rid, k=0, x_rows=rows[rid], hist_rows=None)
    return [
        # headroom 0.95 s, fit = floor(0.95 * 0.9 / 0.1) = 8 -> the 6-row
        Req(request_id=0, auto_plan=True, deadline=10.95, seed=1,
            resume=ck(0)),
        # headroom 0.25 s, fit = 2 -> nothing fits -> the smallest (3)
        Req(request_id=1, auto_plan=True, deadline=10.25, seed=2,
            resume=ck(1)),
        # no deadline -> the quality end of the deterministic frontier (6)
        Req(request_id=2, auto_plan=True, seed=3, resume=ck(2)),
        # an explicit plan rides along in the same tick
        Req(request_id=3, plan=explicit, seed=4, resume=ck(3)),
    ]


def _jax_bank():
    bank = jap.PlanBank(JSCH)
    for b in _jax_bank_plans():
        bank.add_plan(b)
    return bank


def _jax_bank_plans():
    return [JPlan.build(JSCH, tau=JTau.explicit([50, 300, 1000])),
            JPlan.build(JSCH, tau=JTau.explicit([20, 60, 150, 400, 700,
                                                 1000]), order=2),
            JPlan.build(JSCH, tau=JTau.explicit(
                [5, 15, 30, 60, 100, 180, 300, 450, 650, 1000]),
                sigma=JSigma.schedule([0.0] * 9 + [0.5]))]


def _port_bank():
    bank = tap.PlanBank(TSCH)
    bank.add_plan(SamplerPlan.build(TSCH, tau=TauSpec.explicit(
        [50, 300, 1000])))
    bank.add_plan(SamplerPlan.build(TSCH, tau=TauSpec.explicit(
        [20, 60, 150, 400, 700, 1000]), order=2))
    bank.add_plan(SamplerPlan.build(TSCH, tau=TauSpec.explicit(
        [5, 15, 30, 60, 100, 180, 300, 450, 650, 1000]),
        sigma=SigmaSpec.schedule([0.0] * 9 + [0.5])))
    return bank


def _replay(eng):
    clock, res = 10.0, []
    while len(eng.queue) or eng.active:
        res.extend(eng.tick(now=clock))
        clock += 0.01
    return {r.request_id: r for r in res}


def test_engine_virtual_clock_replay_matches_jax_engine():
    """JAX's replay (test_autoplan.py) on both engines with one x_T per
    request: NFE picks [6, 3, 6, 3], one tick function, three bank
    selections, a frozen EWMA, the same span events (``select`` with its
    outcome included), and x0 against the JAX engine and the JAX ``jnp``
    oracle."""
    jeps, teps = toy_eps_pair()
    shape = (8,)
    x_T = {rid: _rand(100 + rid, 1, *shape) for rid in range(4)}
    x_rows = {rid: np.array(jops.to_slot_tile_layout(jnp.asarray(x))[0])
              for rid, x in x_T.items()}
    jobs, tobs = JObs(), Observability()
    jsink, tsink = jobs.add_sink(JListSink()), tobs.add_sink(ListSink())
    jeng = JEngine(JSCH, jeps, shape, slots=4, plan_bank=_jax_bank(),
                   max_order=2, tick_ewma_alpha=0.0, obs=jobs)
    teng = ContinuousBatchingEngine(TSCH, teps, shape, slots=4,
                                    plan_bank=_port_bank(), max_order=2,
                                    tick_ewma_alpha=0.0, obs=tobs,
                                    device="cpu")
    for eng, J in ((jeng, True), (teng, False)):
        eng.tick_ewma_s = 0.1                  # frozen by alpha = 0
        for r in _auto_requests(J, shape, x_rows):
            eng.submit(r, now=10.0)
    jres, tres = _replay(jeng), _replay(teng)
    assert [tres[i].nfe for i in range(4)] == [6, 3, 6, 3]
    assert [jres[i].nfe for i in range(4)] == [6, 3, 6, 3]
    assert [tres[i].auto_plan for i in range(4)] == [True, True, True, False]
    np.testing.assert_allclose(tres[0].deadline_headroom_s, 0.95)
    np.testing.assert_allclose(tres[1].deadline_headroom_s, 0.25)
    assert tres[2].deadline_headroom_s is None
    assert not any(r.deadline_missed for r in tres.values())
    ts, js = teng.stats(), jeng.stats()
    assert ts["compiled_ticks"] == 1 and ts["bank_selected"] == 3
    assert ts["plan_bank"] == 3 and ts["tick_ewma_s"] == 0.1
    for key in ("ticks", "completed", "bank_selected", "plan_bank",
                "tick_ewma_s", "slot_steps", "compiled_ticks"):
        assert ts[key] == js[key], key
    assert tsink.events == jsink.events
    selects = [e for e in tsink.events if e["ev"] == "select"]
    # EDF admission: request 1 (deadline 10.25) first, then 0, then 2
    assert [(e["req"], e["outcome"]) for e in selects] == [
        (1, "degraded"), (0, "fit"), (2, "quality")]
    for rid in range(4):
        scale = max(np.abs(jres[rid].x0).max(), np.abs(x_T[rid]).max())
        assert (np.abs(tres[rid].x0.numpy() - np.asarray(jres[rid].x0)).max()
                <= ENGINE_TOL_OF_SCALE * scale)
    # the bank-selected eta=0 order-1 row against the JAX jnp oracle
    want = np.asarray(_jax_bank().plan(3).run(
        jeps, jnp.asarray(x_T[1]), backend="jnp"))[0]
    scale = max(np.abs(want).max(), np.abs(x_T[1]).max())
    assert np.abs(tres[1].x0.numpy() - want).max() <= F32_TOL * scale
    reg = tobs.registry
    assert reg.get("engine_bank_outcome_total", outcome="fit").value == 1
    assert reg.get("engine_bank_nfe_total", nfe=6).value == 2
    assert reg.get("engine_bank_nfe_total", nfe=3).value == 1


def test_engine_auto_plan_validation_matches_jax():
    jeps, teps = toy_eps_pair()
    cases = []
    jeng = JEngine(JSCH, jeps, (8,), slots=2)
    teng = ContinuousBatchingEngine(TSCH, teps, (8,), slots=2, device="cpu")
    cases.append((jeng, teng, {}, RejectCode.NO_PLAN_BANK))
    jeng = JEngine(JSCH, jeps, (8,), slots=2, plan_bank=_jax_bank())
    teng = ContinuousBatchingEngine(TSCH, teps, (8,), slots=2, device="cpu",
                                    plan_bank=_port_bank())
    assert teng._bank_candidates() == jeng._bank_candidates() == 1
    cases.append((jeng, teng, "plan", RejectCode.AUTO_PLAN_CONFLICT))
    det_o1 = tap.PlanBank(TSCH)
    det_o1.add_plan(SamplerPlan.build(TSCH, tau=TauSpec.explicit(
        [20, 1000]), order=2))
    jdet = jap.PlanBank(JSCH)
    jdet.add_plan(JPlan.build(JSCH, tau=JTau.explicit([20, 1000]), order=2))
    cases.append((JEngine(JSCH, jeps, (8,), slots=2, plan_bank=jdet),
                  ContinuousBatchingEngine(TSCH, teps, (8,), slots=2,
                                           device="cpu", plan_bank=det_o1),
                  {}, RejectCode.BANK_INCOMPATIBLE))
    for jeng, teng, extra, code in cases:
        jkw = dict(plan=jeng.plan_bank.plan(3)) if extra == "plan" else {}
        tkw = dict(plan=teng.plan_bank.plan(3)) if extra == "plan" else {}
        with pytest.raises(RequestError) as te:
            teng.submit(SampleRequest(request_id=0, auto_plan=True, **tkw),
                        now=0.0)
        with pytest.raises(ValueError) as je:
            jeng.submit(JReq(request_id=0, auto_plan=True, **jkw), now=0.0)
        assert te.value.code is code and te.value.status == 400
        assert te.value.code.value == je.value.code.value
        assert str(te.value) == str(je.value)
        assert len(teng.queue) == 0
    with pytest.raises(ValueError, match="different noise schedule"):
        ContinuousBatchingEngine(make_schedule("cosine", 1000), teps, (8,),
                                 slots=2, device="cpu",
                                 plan_bank=_port_bank())


def test_engine_stochastic_bank_rows_need_stochastic_engine():
    _, teps = toy_eps_pair()
    for stochastic, nfe in ((False, 3), (True, 10)):
        eng = ContinuousBatchingEngine(TSCH, teps, (8,), slots=2,
                                       plan_bank=_port_bank(),
                                       stochastic=stochastic,
                                       tick_ewma_alpha=0.0, device="cpu")
        eng.tick_ewma_s = 1e-9                # everything "fits"
        eng.submit(SampleRequest(request_id=0, auto_plan=True, seed=1),
                   now=0.0)
        res = eng.run(now_fn=lambda: 0.0)
        assert [r.nfe for r in res] == [nfe] and eng.completed == 1
        assert np.isfinite(res[0].x0.numpy()).all()


def test_engine_tick_ewma_alpha_and_conservative_first_pick():
    """Before a measured tick a deadline request gets the smallest row;
    the first tick is not folded into the EWMA, later ones are, with the
    engine's alpha."""
    _, teps = toy_eps_pair()
    eng = ContinuousBatchingEngine(TSCH, teps, (8,), slots=2, device="cpu",
                                   plan_bank=_port_bank(),
                                   tick_ewma_alpha=0.5, select_margin=0.5)
    assert eng.select_margin == 0.5 and eng.tick_ewma_alpha == 0.5
    assert eng.stats()["tick_ewma_s"] is None
    eng.submit(SampleRequest(request_id=0, auto_plan=True, deadline=1e9),
               now=0.0)
    eng.tick()
    assert eng.stats()["tick_ewma_s"] is None      # the build tick
    res = eng.run()
    assert res[0].nfe == 3
    assert eng.stats()["tick_ewma_s"] > 0.0
    assert eng.obs.registry.get("engine_bank_outcome_total",
                                outcome="conservative").value == 1


# ------------------------------------------------- DiffusionSampler glue
def test_diffusion_sampler_auto_bank_plan_and_config():
    _, teps = toy_eps_pair()
    bank = _port_bank()
    svc = DiffusionSampler(TSCH, teps, (8,), batch_size=4, device="cpu",
                           plan_bank=bank, tile_resident=True)
    assert svc.bank_plan().S == 10 and svc.bank_plan(max_nfe=7).S == 6
    assert svc.bank_plan(max_nfe=1).S == 3          # degrade to smallest
    out, st = svc.serve(6, "auto", seed=3)
    assert out.shape == (6, 8) and st["net_evals_per_sample"] == 10
    again, _ = svc.serve(6, bank.best(), seed=3)
    assert torch.equal(out, again)
    got, _ = svc.sample_batch("auto", prng.PRNGKey(2, "cpu"))
    assert got.shape == (4, 8)
    cfg = SamplerConfig(S=7, eta=0.5, tau_kind="quadratic")
    a, st = svc.serve(5, cfg, seed=1)
    b, _ = svc.serve(5, cfg.to_plan(TSCH), seed=1)
    assert torch.equal(a, b) and st["net_evals_per_sample"] == 7
    eng = svc.continuous(slots=2)
    assert eng.plan_bank is bank and eng.stats()["plan_bank"] == 3
    assert svc.continuous(slots=2, plan_bank=None).plan_bank is None
    bare = DiffusionSampler(TSCH, teps, (8,), batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="no plan bank"):
        bare.serve(2, "auto")
    with pytest.raises(ValueError, match="the plan bank is empty"):
        DiffusionSampler(TSCH, teps, (8,), batch_size=4, device="cpu",
                         plan_bank=tap.PlanBank(TSCH)).bank_plan()
    with pytest.raises(ValueError, match="different noise schedule"):
        DiffusionSampler(make_schedule("cosine", 1000), teps, (8,),
                         batch_size=4, device="cpu", plan_bank=bank)
