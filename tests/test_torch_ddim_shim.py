"""The retired StepImpl shim (``repro_torch.kernels.ddim_step.ops.
fused_ddim_step``) and the legacy ``core.sample(step_impl=...)`` loop,
against the JAX package's (``repro/kernels/ddim_step/ops.py``,
``repro/core/sampler.py:232-273``).

The shim runs the deterministic sampler-step kernel (B1; its plain
version on the CPU) over the tile layout and adds c_noise * noise outside,
as JAX's does; each call warns DeprecationWarning.  Inputs are made with
numpy from a seed.  Tolerance: 4 float32 ulps of scale (2**-21 of the
largest magnitude of the inputs and the output) for one step; 1e-5 of
scale over a whole legacy loop, whose S steps carry the one-step gap (the
eps model is elementwise).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import core as jcore
from repro.kernels.ddim_step.ops import fused_ddim_step as jshim
from repro_torch import core as tcore
from repro_torch import prng
from repro_torch.kernels.ddim_step import fused_ddim_step as tshim
from repro_torch.kernels.sampler_step import kernel as sk

F32_TOL = 2.0 ** -21
LOOP_TOL = 1e-5
JSCH = jcore.make_schedule("linear", T=1000)
TSCH = tcore.make_schedule("linear", 1000)


def _coefs(t, s):
    ab = np.asarray(JSCH.alpha_bar)
    a_t, a_s = ab[t], ab[s]
    return [np.float32(v) for v in (np.sqrt(a_s), np.sqrt(1 - a_s) * 0.9,
                                    np.sqrt(1 - a_s) * 0.3, np.sqrt(a_t),
                                    np.sqrt(1 - a_t))]


@pytest.mark.parametrize("shape", [(4, 8, 8, 3), (3, 5, 7), (2, 1024)])
@pytest.mark.parametrize("with_noise", [False, True])
def test_shim_matches_jax_shim(shape, with_noise):
    r = np.random.RandomState(sum(shape))
    x, eps, noise = (r.randn(*shape).astype(np.float32) for _ in range(3))
    c = _coefs(700, 600)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = tshim(torch.from_numpy(x), torch.from_numpy(eps),
                    torch.from_numpy(noise) if with_noise else None, *c)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(jshim(jnp.asarray(x), jnp.asarray(eps),
                                jnp.asarray(noise) if with_noise else None,
                                *c))
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = max(np.abs(want).max(), np.abs(x).max(), np.abs(eps).max())
    assert np.abs(got.numpy() - want).max() <= F32_TOL * scale


def test_shim_is_the_deterministic_step_plus_noise():
    """Bitwise: the shim is sampler_step_2d with c_noise 0 on the tile
    layout, plus c_noise * noise; its coefficients may be 0-dim tensors."""
    r = np.random.RandomState(9)
    x, eps, noise = (torch.from_numpy(r.randn(2, 256).astype(np.float32))
                     for _ in range(3))
    c = _coefs(500, 400)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = tshim(x, eps, noise, *(torch.tensor(v) for v in c))
    pad = torch.zeros(6, 256)
    det = sk.sampler_step_2d(torch.cat([x, pad]), torch.cat([eps, pad]),
                             [c[0], c[1], 0.0, c[3], c[4]])[:2]
    assert torch.equal(got, det + torch.tensor(c[2]) * noise)


@pytest.mark.parametrize("eta,clip", [(0.0, None), (0.0, 1.0), (1.0, None),
                                      (0.5, 1.0)])
def test_sample_step_impl_matches_jax(eta, clip):
    """core.sample(step_impl=fused_ddim_step) against JAX's legacy loop:
    the same coefficients, the same normal of split(rng, S) noise, a
    DeprecationWarning from sample and from every shim call."""
    x = np.random.RandomState(4).randn(3, 8, 8, 3).astype(np.float32)
    cfg = dict(S=6, eta=eta, clip_x0=clip)
    with pytest.warns(DeprecationWarning) as rec:
        got, traj = tcore.sample(
            TSCH, lambda x, t: 0.4 * x, torch.from_numpy(x),
            tcore.SamplerConfig(**cfg), prng.PRNGKey(11, "cpu"),
            step_impl=tshim, return_trajectory=True)
    msgs = [str(w.message) for w in rec]
    assert any("step_impl" in m for m in msgs)
    assert sum("fused_ddim_step" in m for m in msgs) == 6
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, jtraj = jcore.sample(JSCH, lambda x, t: 0.4 * x,
                                   jnp.asarray(x), jcore.SamplerConfig(**cfg),
                                   jax.random.PRNGKey(11), step_impl=jshim,
                                   return_trajectory=True)
    want, jtraj = np.asarray(want), np.asarray(jtraj)
    assert traj.shape == jtraj.shape == (7,) + x.shape
    assert torch.equal(traj[0], torch.from_numpy(x))
    assert torch.equal(traj[-1], got)
    scale = max(np.abs(jtraj).max(), 1.0)
    assert np.abs(traj.numpy() - jtraj).max() <= LOOP_TOL * scale


def test_default_step_impl_is_the_plan_path_and_silent():
    """Without step_impl, sample is the plan's eager run (no warning); the
    tile-resident flag ignores step_impl, as in JAX."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 256).astype(
        np.float32))
    cfg = tcore.SamplerConfig(S=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        a = tcore.sample(TSCH, lambda x, t: 0.1 * x, x, cfg)
        b = tcore.sample(TSCH, lambda x, t: 0.1 * x, x, cfg,
                         tile_resident=True, step_impl=tshim)
    assert torch.equal(a, cfg.to_plan(TSCH).run(lambda x, t: 0.1 * x, x))
    assert torch.equal(b, cfg.to_plan(TSCH).run(
        lambda x, t: 0.1 * x, x, backend="tile_resident"))
    with pytest.raises(ValueError, match="needs rng"):
        tcore.sample(TSCH, lambda x, t: x, x, tcore.SamplerConfig(S=2,
                                                                  eta=1.0),
                     step_impl=tshim)
