"""The port's schedules and SamplerPlan tables against the JAX package.

The coefficient table is float64 numpy math cast once to float32 in both
packages, so every column must be BITWISE equal, and so must the schedule
digest and alpha_bar.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.core import schedules as jsched
from repro.core import solver as jsolver
from repro.sampling import plan as jplan
from repro.sampling import specs as jspecs
from repro_torch.core import schedules as tsched
from repro_torch.core import solver as tsolver
from repro_torch.sampling import plan as tplan
from repro_torch.sampling import specs as tspecs

T = 1000


def _specs(mod, case):
    """(tau, sigma, x0, order) of one case, built from module ``mod``."""
    S = 10
    taus_expl = (3, 40, 41, 200, 333, 500, 640, 777, 901, 1000)
    base = dict(tau=mod.TauSpec.uniform(S), sigma=mod.SigmaSpec.ddim(),
                x0=mod.X0Policy.none(), order=1)
    if case == "quadratic":
        base["tau"] = mod.TauSpec.quadratic(S)
    elif case == "explicit_tau":
        base["tau"] = mod.TauSpec.explicit(taus_expl)
    elif case == "eta_schedule":
        base["sigma"] = mod.SigmaSpec.schedule(np.linspace(0.0, 1.0, S))
    elif case.startswith("eta"):
        base["sigma"] = mod.SigmaSpec.from_eta(float(case[3:]))
    elif case == "explicit_sigma":
        ab = np.asarray(jsched.make_schedule("linear", T).alpha_bar,
                        np.float64)
        tau = jsched.make_tau(T, S)
        a_s = ab[np.concatenate([[0], tau[:-1]])]
        base["sigma"] = mod.SigmaSpec.explicit(0.5 * np.sqrt(1.0 - a_s))
    elif case == "sigma_hat":
        base["sigma"] = mod.SigmaSpec.ddpm(sigma_hat=True)
    elif case == "clip":
        base["x0"] = mod.X0Policy.clipped(1.0)
    elif case.startswith("order"):
        base["order"] = int(case[5:])
    return base


CASES = ["uniform", "quadratic", "explicit_tau", "eta0", "eta0.5", "eta1",
         "eta_schedule", "explicit_sigma", "sigma_hat", "clip", "order1",
         "order2", "order3", "order4"]


@pytest.mark.parametrize("kind", ["linear", "cosine", "scaled_linear"])
def test_alpha_bar_bitwise(kind):
    ref = np.asarray(jsched.make_schedule(kind, T).alpha_bar)
    got = tsched.make_schedule(kind, T).alpha_bar.numpy()
    assert got.dtype == np.float32 and ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("kind", ["linear", "quadratic"])
@pytest.mark.parametrize("S", [1, 10, 50, 999])
def test_make_tau_equal(kind, S):
    np.testing.assert_array_equal(tsched.make_tau(T, S, kind),
                                  jsched.make_tau(T, S, kind))


@pytest.mark.parametrize("case", CASES)
def test_steps_table_bitwise(case):
    jp = jplan.SamplerPlan(schedule=jsched.make_schedule("linear", T),
                           **_specs(jspecs, case))
    tp = tplan.SamplerPlan(schedule=tsched.make_schedule("linear", T),
                           **_specs(tspecs, case))
    ref, got = jp.steps(), tp.steps()
    assert set(ref) == set(got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k
    assert (tp.S, tp.stochastic) == (jp.S, jp.stochastic)


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedule_digest_equal(kind):
    js, ts = jsched.make_schedule(kind, T), tsched.make_schedule(kind, T)
    assert tplan._schedule_digest(ts) == jplan._schedule_digest(js)
    tp = tplan.SamplerPlan.build(ts, 10)
    assert tp.schedule_digest() == jplan.SamplerPlan.build(js, 10) \
        .schedule_digest()
    assert hash(tp) == hash(tplan.SamplerPlan.build(ts, 10))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_warmup_weights_and_mix_history(order):
    S = 6
    np.testing.assert_array_equal(tsolver.warmup_weights(S, order),
                                  jsolver.warmup_weights(S, order))
    rs = np.random.RandomState(order)
    eps = rs.randn(4, 5).astype(np.float32)
    hist = rs.randn(max(order - 1, 1), 4, 5).astype(np.float32)
    w = np.asarray(jsolver.warmup_weights(S, order)[-1], np.float32)
    jh = jnp.asarray(hist[: order - 1]) if order > 1 else None
    th = torch.from_numpy(hist[: order - 1]) if order > 1 else None
    je, jh2 = jsolver.mix_history(jnp.asarray(eps), jh, jnp.asarray(w),
                                  order)
    te, th2 = tsolver.mix_history(torch.from_numpy(eps), th,
                                  torch.from_numpy(w), order)
    # a few float32 ulps: XLA may contract the combine into FMAs
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=4 * np.finfo(np.float32).eps
                               * float(np.abs(np.asarray(je)).max()))
    if order > 1:
        np.testing.assert_array_equal(th2.numpy(), np.asarray(jh2))


def test_mega_backend_raises_not_implemented():
    """'mega' is ported: an eps model without a mega_spec runs the
    tile-resident loop instead of raising; an unknown backend and k_fuse
    on another backend raise."""
    from repro_torch.sampling import backends as tback
    tp = tplan.SamplerPlan.build(tsched.make_schedule("linear", T), 4)
    x = torch.linspace(-1.0, 1.0, 4).reshape(1, 4)
    eps = lambda x, t: 0.5 * x  # noqa: E731
    mega = tp.run(eps, x, backend="mega")
    assert "mega_spec" in tback.run_mega.last_reason
    torch.testing.assert_close(mega, tp.run(eps, x, backend="tile_resident"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown backend"):
        tp.run(eps, x, backend="jnp")
    with pytest.raises(ValueError, match="k_fuse"):
        tp.run(eps, x, backend="tile_resident", k_fuse=2)


def test_stochastic_plan_needs_generator():
    tp = tplan.SamplerPlan.build(tsched.make_schedule("linear", T), 4,
                                 sigma=1.0)
    with pytest.raises(ValueError, match="needs rng"):
        tp.run(lambda x, t: x, torch.zeros(1, 4), backend="eager")
