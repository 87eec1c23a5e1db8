"""One integer seed gives the JAX package's result: every draw site of the
port's diffusion path (``repro_torch.prng``'s threefry) against JAX's.

The integer draws are held bitwise: the per-step kernel seeds
(``randint``), the keys each site splits, training's t.  The normals
(x_T, the eager noise, training's eps) are held as ``test_torch_prng.py``
holds them, to NORMAL_ULPS = 4 float32 ulps of max(|z|, 1) (bitwise on
the CPU the tests were written on).  What runs on them is held as the
slice tests hold it, on the CPU (JAX's Pallas kernels in interpret mode,
the port's wrappers on their plain versions):

  * the elementwise eps models (the closed form of N(mu, s^2) data, and
    eps = x * f[t]): STEP_ULPS = 8 float32 ulps of max(|x_T|, |x_0|) per
    step, S steps in all (the stochastic kernels' Box-Muller libm and
    XLA's contraction of the noise add differ from the port's by an ulp);
  * the narrow U-Net (converted weights): TOL_OF_SCALE = 1e-4 of scale,
    the trajectory tolerance of ``test_torch_slice.py``;
  * the scheduler: 1e-5 of max(|x0|, |x_T|), as ``test_torch_scheduler``;
  * diffusion-LM tokens: equal (argmax of the rounding head);
  * the training loss at 4 ulps; ``build_objective`` and the ELBO at
    rtol 1e-6 (``test_torch_autoplan.py``'s ELBO tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import core as jcore
from repro.autoplan import ObjectiveConfig as JObjCfg
from repro.autoplan import build_objective as j_build_objective
from repro.diffusion_lm import model as jdlm
from repro.eval import transition_elbo_table as j_elbo
from repro.models import unet as junet
from repro.models.common import ArchConfig as JArch
from repro.sampling import SamplerPlan as JPlan
from repro.serving import DiffusionSampler as JSampler
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import SampleRequest as JReq
from repro_torch import core as tcore
from repro_torch import interop, prng
from repro_torch.autoplan import ObjectiveConfig, build_objective
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.eval import transition_elbo_table
from repro_torch.models import unet as tunet
from repro_torch.models.common import ArchConfig as TArch
from repro_torch.sampling import SamplerPlan
from repro_torch.sampling import backends as tback
from repro_torch.serving import (ContinuousBatchingEngine, DiffusionSampler,
                                 SampleRequest)

F32_ULP = float(np.finfo(np.float32).eps)
NORMAL_ULPS = 4
STEP_ULPS = 8
TOL_OF_SCALE = 1e-4
ENGINE_TOL_OF_SCALE = 1e-5
INT32_MAX = np.iinfo(np.int32).max
JSCH = jcore.make_schedule("linear", T=1000)
TSCH = tcore.make_schedule("linear", 1000)
S = 10
UCFG = dict(in_channels=3, base_width=16, width_mults=(1,), n_res_blocks=1,
            attn_levels=(), time_dim=32)


def _toy_pair(mu=2.0, s=0.5):
    def jeps(x, t):
        a = JSCH.alpha_bar[t].reshape((-1,) + (1,) * (x.ndim - 1))
        return (x - jnp.sqrt(a) * mu) * jnp.sqrt(1 - a) / (1 - a + a * s * s)

    def teps(x, t):
        a = TSCH.alpha_bar.to(x.device)[t.long()].reshape(
            (-1,) + (1,) * (x.dim() - 1))
        return ((x - torch.sqrt(a) * mu) * torch.sqrt(1 - a)
                / (1 - a + a * s * s))
    return jeps, teps


def _factor_pair(s=1.0):
    """eps = x * f[t], one float32 multiply on either side."""
    a = TSCH.alpha_bar.double().numpy()
    f = (np.sqrt(1 - a) / (1 - a + a * s * s)).astype(np.float32)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)

    def jeps(x, t):
        return x * jf[t].reshape((-1,) + (1,) * (x.ndim - 1))

    def teps(x, t):
        return x * tf[t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
    return jeps, teps


@pytest.fixture(scope="module")
def unet_pair():
    """A narrow U-Net on both sides: the JAX init redrawn at fan-in scale
    from a numpy seed, carried over by ``interop``."""
    jcfg, tcfg = junet.UNetConfig(**UCFG), tunet.UNetConfig(**UCFG)
    tree = junet.init_params(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: (rs.randn(*np.shape(a)) / np.sqrt(np.prod(np.shape(a)[:-1]))
                   if np.ndim(a) > 1 else np.asarray(a)).astype(np.float32),
        tree)
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(interop.unet_params_from_jax(tree, tcfg))
    jfwd = jax.jit(lambda x, t: junet.forward(tree, jcfg, x, t))
    return jfwd, tunet.make_eps_fn(model.eval())


def _assert_close(got, want, tol, *also):
    want = np.asarray(want)
    scale = max([float(np.abs(want).max())]
                + [float(np.abs(np.asarray(a)).max()) for a in also])
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _assert_normals_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    spacing = np.maximum(np.abs(want), 1.0) * F32_ULP
    assert float((np.abs(got - want) / spacing).max()) <= NORMAL_ULPS


def _stoch_plans():
    return (JPlan.build(JSCH, tau=S, sigma=1.0),
            SamplerPlan.build(TSCH, tau=S, sigma=1.0))


# ------------------------------------------------------- kernel seeds
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1], ids=str)
def test_kernel_seeds_bitwise(seed):
    """tile_resident's (S,) and rows' (S, B) int32 seeds are JAX's."""
    key = prng.PRNGKey(seed, "cpu")
    for size in ((S,), (S, 5)):
        want = jax.random.randint(jax.random.PRNGKey(seed), size, 0,
                                  INT32_MAX, dtype=jnp.int32)
        got = tback._draw_seeds(key, size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ plan.run
@pytest.mark.parametrize("backend", ["eager", "tile_resident", "rows"])
def test_stochastic_plan_run_one_key(backend):
    """A stochastic plan.run from PRNGKey(7): JAX's trajectory ('jnp' for
    the port's 'eager', the kernel backends against their JAX twins)."""
    jeps, teps = _toy_pair()
    jp, tp = _stoch_plans()
    x_T = np.random.RandomState(1).randn(6, 256 + 40).astype(np.float32)
    jback_name = "jnp" if backend == "eager" else backend
    want, jtraj = jp.run(jeps, jnp.asarray(x_T), jax.random.PRNGKey(7),
                         backend=jback_name, return_trajectory=True)
    got, traj = tp.run(teps, torch.from_numpy(x_T), prng.PRNGKey(7, "cpu"),
                       backend=backend, return_trajectory=True)
    for k in range(S + 1):
        _assert_close(traj[k], jtraj[k], STEP_ULPS * F32_ULP * max(k, 1),
                      x_T)
    np.testing.assert_array_equal(got.numpy(), traj[-1].numpy())
    other = tp.run(teps, torch.from_numpy(x_T), prng.PRNGKey(8, "cpu"),
                   backend=backend)
    assert float((other - got).abs().max()) > 1e-3


def test_core_sample_and_ddpm_shim_one_key():
    """core.sample (and the ddpm shim through it) draws its step noise
    from split(rng, S) as JAX's core.sample does."""
    from repro.core.sampler import SamplerConfig as JCfg
    jeps, teps = _toy_pair()
    x_T = np.random.RandomState(2).randn(8, 2).astype(np.float32)
    want = jcore.sample(JSCH, jeps, jnp.asarray(x_T),
                        JCfg(S=S, eta=1.0), jax.random.PRNGKey(3))
    got = tcore.sample(TSCH, teps, torch.from_numpy(x_T),
                       tcore.SamplerConfig(S=S, eta=1.0),
                       prng.PRNGKey(3, "cpu"))
    _assert_close(got, want, STEP_ULPS * F32_ULP * S, x_T)


# ------------------------------------------------------------ serving
def test_serve_one_seed_two_chunks(unet_pair):
    """DiffusionSampler.serve(6, eta=1 plan, seed=7) over the chunks
    [4, 2]: x_T and the per-chunk keys are JAX's, the samples within the
    U-Net tolerance."""
    jfwd, teps = unet_pair
    jp, tp = _stoch_plans()
    shape = (8, 8, 3)
    jsvc = JSampler(JSCH, jfwd, shape, batch_size=4, bucket_sizes=(2, 4),
                    tile_resident=True)
    tsvc = DiffusionSampler(TSCH, teps, shape, batch_size=4,
                            bucket_sizes=(2, 4), tile_resident=True,
                            device="cpu")
    assert tsvc._chunk_plan(6) == [4, 2]
    want, _ = jsvc.serve(6, jp, seed=7)
    got, stats = tsvc.serve(6, tp, seed=7)
    assert stats["batches"] == 2 and got.shape == (6,) + shape
    _assert_close(got, want, TOL_OF_SCALE)
    # the first chunk's x_T: split(split(PRNGKey(7))[1])[0], bitwise
    _, sub = jax.random.split(jax.random.PRNGKey(7))
    k1, _ = jax.random.split(sub)
    jx = jax.random.normal(k1, (4,) + shape)
    _, tsub = prng.split(prng.PRNGKey(7, "cpu"))
    tk1, _ = prng.split(tsub)
    tx = prng.normal(tk1, (4,) + shape)
    _assert_normals_close(tx.numpy(), jx)


def test_scheduler_request_one_seed():
    """One stochastic request with seed 7 and no injected x_T: the slot's
    x_T is JAX's, x0 within the engine tolerance."""
    jeps, teps = _factor_pair()
    shape = (7, 23)
    jeng = JEngine(JSCH, jeps, shape, slots=2, stochastic=True)
    teng = ContinuousBatchingEngine(TSCH, teps, shape, slots=2,
                                    stochastic=True, device="cpu")
    _assert_normals_close(teng._draw_xT(7).numpy(), jeng._xT_fn(7))
    jeng.submit(JReq(request_id=0, S=6, eta=1.0, seed=7), now=0.0)
    teng.submit(SampleRequest(request_id=0, S=6, eta=1.0, seed=7), now=0.0)
    jres, tres = [], []
    now = 0.0
    while jeng.active or len(jeng.queue):
        now += 1.0
        jres += jeng.tick(now=now)
        tres += teng.tick(now=now)
    assert len(jres) == len(tres) == 1
    x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1,) + shape))
    _assert_close(tres[0].x0.numpy(), jres[0].x0, ENGINE_TOL_OF_SCALE, x_T)


# ------------------------------------------------------- diffusion-LM
def test_diffusion_lm_generate_one_key():
    """generate(rng): k_init, k_samp = split(rng); x_T = normal(k_init);
    tokens equal to JAX's for a stochastic and a deterministic sampler."""
    arch = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=50)
    jcfg = jdlm.DiffusionLMConfig(arch=JArch(name="t", family="dense",
                                             **arch), time_dim=32,
                                  latent_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=TArch(name="t", family="dense",
                                             **arch), time_dim=32,
                                  latent_dim=32)
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    for eta in (0.0, 1.0):
        want = jdlm.generate(jp, jcfg, JSCH, jax.random.PRNGKey(5), 2, 64,
                             sampler=jcore.SamplerConfig(S=4, eta=eta))
        got = tdlm.generate(tp, tcfg, TSCH, prng.PRNGKey(5, "cpu"), 2, 64,
                            sampler=tcore.SamplerConfig(S=4, eta=eta),
                            device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- training
@pytest.mark.parametrize("seed", [0, 11], ids=str)
def test_training_loss_one_key(seed):
    """core.diffusion.training_loss(rng): (t, eps) from split(rng) are
    JAX's, the loss within 4 ulps."""
    jeps, teps = _toy_pair()
    x0 = (2.0 + 0.5 * np.random.RandomState(3).randn(64, 2)).astype(
        np.float32)
    want = float(jcore.training_loss(JSCH, jeps, jnp.asarray(x0),
                                     jax.random.PRNGKey(seed)))
    got = float(tcore.training_loss(TSCH, teps, torch.from_numpy(x0),
                                    prng.PRNGKey(seed, "cpu")))
    assert abs(got - want) <= 4 * F32_ULP * abs(want)


# ---------------------------------------------- autotuner and the ELBO
def _assert_table_close(t, j):
    const = 0.5 * np.log(2.0 * np.pi * j.recon_sigma ** 2)
    a, b = t.trans.copy(), j.trans.copy()
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    a[0, 1:] -= const
    b[0, 1:] -= const
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6)
    np.testing.assert_allclose(t.mse, j.mse, rtol=1e-6)


def test_build_objective_noise_is_jax_for_one_seed():
    """build_objective with no rng draws normal(PRNGKey(cfg.seed)): the
    ELBO table equals JAX's, and so does the bank's cost where the defect
    is off."""
    jeps, teps = _toy_pair()
    x0 = (2.0 + 0.5 * np.random.RandomState(4).randn(16, 2)).astype(
        np.float32)
    kw = dict(grid_size=8, batch=16, quality_weight=0.0, seed=13)
    want = j_build_objective(JSCH, jeps, jnp.asarray(x0), JObjCfg(**kw))
    got = build_objective(TSCH, teps, torch.from_numpy(x0),
                          ObjectiveConfig(**kw))
    _assert_table_close(got.elbo, want.elbo)


def test_elbo_noise_is_jax_for_one_key():
    jeps, teps = _toy_pair()
    x0 = (2.0 + 0.5 * np.random.RandomState(5).randn(8, 2)).astype(
        np.float32)
    want = j_elbo(JSCH, jeps, jnp.asarray(x0), jax.random.PRNGKey(2),
                  grid=[10, 100, 500, 900])
    got = transition_elbo_table(TSCH, teps, torch.from_numpy(x0),
                                prng.PRNGKey(2, "cpu"),
                                grid=[10, 100, 500, 900])
    _assert_table_close(got, want)
