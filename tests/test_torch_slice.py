"""The whole slice — SamplerPlan -> step loop -> x_0 over the U-Net — in
the port against the JAX package, on the same x_T and the same weights.

Stochastic plans: the JAX backends draw their per-step int32 seeds from
the rng (``backends.py:129`` scalar, ``:194-197`` per slot); the test
draws the same seeds and hands them to the port's inner loops, so both
sides add the same software-PRNG noise stream.

Tolerances (float32):
  * port vs JAX: 1e-4 of the larger of max|x_0| and max|x_T| — the two
    U-Nets agree to ~1e-6 of their output scale per evaluation (see
    test_torch_unet.py) and the loop carries that difference through S
    steps (measured: 6e-7 of max|x_0| unclipped, 6e-5 with clip=1, where
    x_0 is bounded but the states before it are not);
  * port 'tile_resident' vs port 'eager' at eta=0: bitwise — on the CPU
    both run the same plain step arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.core import schedules as jsched
from repro.models import unet as junet
from repro.sampling import plan as jplan
from repro.serving import engine as jengine
from repro_torch import prng
from repro_torch import interop
from repro_torch.core import schedules as tsched
from repro_torch.kernels.sampler_step import kernel as tk
from repro_torch.kernels.sampler_step import ops as tops
from repro_torch.models import unet as tunet
from repro_torch.sampling import backends as tback
from repro_torch.sampling import plan as tplan
from repro_torch.serving import DiffusionSampler

S = 4
SHAPE = (8, 8, 3)
B = 2
TOL_OF_SCALE = 1e-4
CFG = tunet.UNetConfig(in_channels=3, base_width=16, width_mults=(1, 2),
                       n_res_blocks=1, attn_levels=(1,), time_dim=32)
JCFG = junet.UNetConfig(in_channels=3, base_width=16, width_mults=(1, 2),
                        n_res_blocks=1, attn_levels=(1,), time_dim=32)
PLANS = {"eta0": dict(sigma=0.0), "eta1": dict(sigma=1.0),
         "clip": dict(sigma=0.0, x0=1.0)}


@pytest.fixture(scope="module")
def models():
    """JAX eps_fn (jitted) and the port's eps_fn on the same weights."""
    tree = junet.init_params(jax.random.PRNGKey(0), JCFG)
    rs = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: (rs.randn(*np.shape(a)) / np.sqrt(np.prod(np.shape(a)[:-1]))
                   if np.ndim(a) > 1 else np.asarray(a)).astype(np.float32),
        tree)
    model = tunet.UNet(CFG, device="cpu")
    model.load_state_dict(interop.unet_params_from_jax(tree, CFG))
    jfwd = jax.jit(lambda x, t: junet.forward(tree, JCFG, x, t))
    return jfwd, tunet.make_eps_fn(model.eval())


@pytest.fixture(scope="module")
def x_T():
    return np.random.RandomState(7).randn(B, *SHAPE).astype(np.float32)


def _plans(name):
    kw = PLANS[name]
    return (jplan.SamplerPlan.build(jsched.make_schedule("linear", 1000), S,
                                    **kw),
            tplan.SamplerPlan.build(tsched.make_schedule("linear", 1000), S,
                                    **kw))


def _assert_close(got, want, x_T):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), float(np.abs(x_T).max()))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL_OF_SCALE * scale, (err, scale)


@pytest.mark.parametrize("name", list(PLANS))
def test_tile_resident_matches_jax(models, x_T, name):
    jfwd, eps_fn = models
    jp, tp = _plans(name)
    rng = jax.random.PRNGKey(11)
    want = jp.run(jfwd, jnp.asarray(x_T), rng, backend="tile_resident")
    x = torch.from_numpy(x_T)
    if tp.stochastic:
        seeds = np.asarray(jax.random.randint(
            rng, (S,), 0, np.iinfo(np.int32).max, dtype=jnp.int32))
        x2, n = tops.to_tile_layout(x)
        got = tops.from_tile_layout(
            tback._loop_tiles(tp, eps_fn, x2, torch.from_numpy(seeds.copy()),
                              n, x.shape), n, x.shape)
    else:
        got = tp.run(eps_fn, x, backend="tile_resident")
    assert got.shape == x.shape and torch.isfinite(got).all()
    _assert_close(got, want, x_T)


@pytest.mark.parametrize("name", list(PLANS))
def test_rows_matches_jax(models, x_T, name):
    jfwd, eps_fn = models
    jp, tp = _plans(name)
    rng = jax.random.PRNGKey(12)
    want = jp.run(jfwd, jnp.asarray(x_T), rng, backend="rows")
    x = torch.from_numpy(x_T)
    if tp.stochastic:
        seeds = np.asarray(jax.random.randint(
            rng, (S, B), 0, np.iinfo(np.int32).max, dtype=jnp.int32))
        x2, n = tops.to_slot_tile_layout(x)
        got = tops.from_slot_tile_layout(
            tback._loop_rows(tp, eps_fn, x2, torch.from_numpy(seeds.copy()),
                             n, x.shape), n, x.shape)
    else:
        got = tp.run(eps_fn, x, backend="rows")
    assert got.shape == x.shape and torch.isfinite(got).all()
    _assert_close(got, want, x_T)


def test_eager_matches_jax_jnp(models, x_T):
    jfwd, eps_fn = models
    jp, tp = _plans("eta0")
    want = jp.run(jfwd, jnp.asarray(x_T), None, backend="jnp")
    _assert_close(tp.run(eps_fn, torch.from_numpy(x_T), backend="eager"),
                  want, x_T)


@pytest.mark.parametrize("name", ["eta0", "clip"])
def test_tile_resident_equals_eager_bitwise(models, x_T, name):
    _, eps_fn = models
    _, tp = _plans(name)
    x = torch.from_numpy(x_T)
    a = tp.run(eps_fn, x, backend="tile_resident")
    b = tp.run(eps_fn, x, backend="eager")
    assert torch.equal(a, b)


def test_kernel_backends_draw_seeds_from_the_generator(models, x_T):
    """Stochastic runs are reproducible from the key's seed and differ
    across seeds; the CPU path counts no kernel launches."""
    _, eps_fn = models
    _, tp = _plans("eta1")
    x = torch.from_numpy(x_T)
    launches = tk.sampler_step_2d.launches
    runs = [tp.run(eps_fn, x, prng.PRNGKey(s, "cpu"),
                   backend="tile_resident") for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert tk.sampler_step_2d.launches == launches


def test_diffusion_sampler_serve(models):
    _, eps_fn = models
    _, tp = _plans("eta0")
    svc = DiffusionSampler(tsched.make_schedule("linear", 1000), eps_fn,
                           SHAPE, batch_size=4, bucket_sizes=(2, 4),
                           tile_resident=True, device="cpu")
    jsvc = jengine.DiffusionSampler(
        jsched.make_schedule("linear", 1000), lambda x, t: x, SHAPE,
        batch_size=4, bucket_sizes=(2, 4), tile_resident=True)
    assert svc._chunk_plan(5) == jsvc._chunk_plan(5) == [4, 2]
    out, stats = svc.serve(5, tp, seed=3)
    assert out.shape == (5,) + SHAPE and torch.isfinite(out).all()
    assert set(stats) == {"batches", "first_batch_s", "steady_batch_s",
                          "samples_per_s", "net_evals_per_sample", "dtype",
                          "compiled_programs", "donated"}
    _, jstats = jsvc.serve(5, jplan.SamplerPlan.build(
        jsched.make_schedule("linear", 1000), 2))
    assert set(stats) == set(jstats)
    # one program key per (plan, bucket): the 4 and the 2 of [4, 2]
    assert stats["compiled_programs"] == jstats["compiled_programs"] == 2
    assert stats["donated"] is False
    assert stats["batches"] == 2 and stats["net_evals_per_sample"] == S
    assert stats["dtype"] == "float32"
    again, st2 = svc.serve(5, tp, seed=3)
    assert torch.equal(out, again) and st2["compiled_programs"] == 2
    assert svc.serve(0, tp)[1]["compiled_programs"] == 2


def test_diffusion_sampler_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionSampler(tsched.make_schedule("linear", 1000),
                         lambda x, t: x, SHAPE, batch_size=2)
