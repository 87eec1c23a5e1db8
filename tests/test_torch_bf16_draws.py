"""bfloat16 through the port against the JAX package: JAX's 16-bit draws.

  * ``prng.normal`` / ``prng.uniform`` in bfloat16 (and float16) are
    ``jax.random.normal`` / ``uniform`` in that dtype, bitwise: a bfloat16
    draw takes 8 random bits an element (128 values), so a draw in which
    every byte value occurs holds the whole map.  float32 stays the
    default, unchanged.
  * Every site that JAX draws in the state's dtype draws bfloat16 for a
    bfloat16 state, bitwise against JAX's draw of the same key: the
    service's x_T, the scheduler's x_T, ``core.training_loss``'s eps, the
    eager sampler's step noise and the diffusion-LM training eps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mega as mega_trunks
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import core as jcore
from repro.kernels.sampler_step import ops as jtile_ops
from repro_torch import core as tcore
from repro_torch import prng
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.serving import ContinuousBatchingEngine, DiffusionSampler

JDT = {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
JSCH = jcore.make_schedule("linear", T=1000)
TSCH = tcore.make_schedule("linear", 1000)


def _bits(x) -> np.ndarray:
    """The bit patterns of a 16-bit float array (torch or JAX)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# ------------------------------------------------------------- the draws
@pytest.mark.parametrize("seed,shape", [(3, (4096,)), (0, (4, 64, 32))],
                         ids=["every-byte", "4x64x32"])
@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_16bit_normal_and_uniform_are_jax_bitwise(dt, seed, shape):
    key = prng.PRNGKey(seed, "cpu")
    jkey = jax.random.PRNGKey(seed)
    got = prng.normal(key, shape, dtype=TDT[dt])
    assert got.dtype == TDT[dt] and tuple(got.shape) == shape
    np.testing.assert_array_equal(
        _bits(got), _bits(jax.random.normal(jkey, shape, JDT[dt])))
    got = prng.uniform(key, shape, -2.0, 3.0, dtype=TDT[dt])
    np.testing.assert_array_equal(
        _bits(got), _bits(jax.random.uniform(jkey, shape, JDT[dt], -2.0,
                                             3.0)))
    if shape == (4096,):          # every byte value: the whole bfloat16 map
        low = prng.random_bits(key, shape) & 0xFF
        assert len(torch.unique(low)) == 256
        if dt == "bf16":
            assert len(torch.unique(prng.normal(key, shape,
                                                dtype=TDT[dt]))) == 128


def test_float32_stays_the_default_and_unchanged():
    key = prng.PRNGKey(5, "cpu")
    a = prng.normal(key, (3, 70))
    b = prng.normal(key, (3, 70), dtype=torch.float32)
    assert a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    u = prng.uniform(key, (3, 70), dtype=torch.float64)
    torch.testing.assert_close(u, prng.uniform(key, (3, 70)).double(),
                               rtol=0, atol=0)
    with pytest.raises(TypeError, match="floats"):
        prng.normal(key, (2,), dtype=torch.int32)


# ---------------------------------------------------------- draw sites
def _zero_eps(seen):
    def eps(x, t):
        seen.append(x.clone())
        return torch.zeros_like(x)
    return eps


def test_service_x_T_is_jax_bfloat16_draw():
    """DiffusionSampler.sample_batch: k1, k2 = split(rng); x_T =
    normal(k1, (batch,) + shape, the service's dtype)."""
    shape = (4, 8)
    seen = []
    svc = DiffusionSampler(TSCH, _zero_eps(seen), shape, batch_size=2,
                           dtype=torch.bfloat16, device="cpu")
    svc.sample_batch(tcore.SamplerConfig(S=2), prng.PRNGKey(9, "cpu"))
    k1, _ = jax.random.split(jax.random.PRNGKey(9))
    want = jax.random.normal(k1, (2,) + shape, jnp.bfloat16)
    assert seen[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(seen[0]), _bits(want))


def test_scheduler_x_T_is_jax_bfloat16_draw():
    """A bfloat16 engine's slot x_T against the JAX engine's draw."""
    from repro.serving.scheduler import ContinuousBatchingEngine as JEngine

    def jeps(x, t):
        return jnp.zeros_like(x)
    shape = (16, 32)
    jeng = JEngine(JSCH, jeps, shape, slots=2, dtype=jnp.bfloat16)
    teng = ContinuousBatchingEngine(TSCH, _zero_eps([]), shape, slots=2,
                                    dtype=torch.bfloat16, device="cpu")
    for seed in (7, 123):
        got = teng._draw_xT(seed)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(jeng._xT_fn(seed)))
    want = jtile_ops.to_slot_tile_layout(jax.random.normal(
        jax.random.PRNGKey(7), (1,) + shape, jnp.bfloat16))[0]
    np.testing.assert_array_equal(_bits(teng._draw_xT(7)), _bits(want))


def test_core_training_loss_draws_bfloat16_eps(monkeypatch):
    """core.training_loss: k_t, k_e = split(rng); eps = normal(k_e,
    x0.shape, x0.dtype)."""
    from repro_torch.core import diffusion as tdiff
    seen = {}

    def spy(schedule, eps_fn, x0, t, noise, weights=None):
        seen["noise"] = noise
        return torch.zeros(())
    monkeypatch.setattr(tdiff, "simple_loss", spy)
    x0 = torch.randn(6, 5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tdiff.training_loss(TSCH, _zero_eps([]), x0, prng.PRNGKey(4, "cpu"))
    _, k_e = jax.random.split(jax.random.PRNGKey(4))
    want = jax.random.normal(k_e, (6, 5), jnp.bfloat16)
    np.testing.assert_array_equal(_bits(seen["noise"]), _bits(want))


def test_eager_sampler_step_noise_is_jax_bfloat16_draw():
    """core.sample with eta > 0 on a bfloat16 state: step i's noise is
    normal(split(rng, S)[i], x.shape, bfloat16), as in JAX's scan."""
    noises = []

    def step(x, eps, noise, *c):
        noises.append(noise)
        return x
    x_T = torch.zeros(3, 4, dtype=torch.bfloat16)
    tcore.sample(TSCH, _zero_eps([]), x_T, tcore.SamplerConfig(S=3, eta=1.0),
                 prng.PRNGKey(8, "cpu"), step_impl=step)
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    assert len(noises) == 3
    for i, got in enumerate(noises):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bits(got), _bits(jax.random.normal(keys[i], (3, 4),
                                                jnp.bfloat16)))


def test_diffusion_lm_training_eps_is_jax_bfloat16_draw(monkeypatch):
    """diffusion_lm.training_loss over bfloat16 weights: x0 is bfloat16,
    and so is its eps, normal(split(rng)[1], x0.shape, bfloat16)."""
    jcfg, tcfg, jp, tp = mega_trunks.trunk(16)
    tp16 = mega_trunks.cast(tp, torch.bfloat16)
    seen = {}
    real = tdlm.q_sample

    def spy(schedule, x0, t, noise):
        seen["noise"] = noise
        return real(schedule, x0, t, noise)
    monkeypatch.setattr(tdlm, "q_sample", spy)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50, (2, 64)).astype(np.int32))
    tdlm.training_loss(tp16, tcfg, TSCH, tokens, prng.PRNGKey(6, "cpu"),
                       remat=False)
    _, k_e = jax.random.split(jax.random.PRNGKey(6))
    want = jax.random.normal(k_e, (2, 64, mega_trunks.LATENT), jnp.bfloat16)
    np.testing.assert_array_equal(_bits(seen["noise"]), _bits(want))
