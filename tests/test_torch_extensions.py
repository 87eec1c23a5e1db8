"""The port's v-prediction and classifier-free-guidance adapters
(``repro_torch.core.extensions``) against the JAX package's
(``repro/core/extensions.py``), and their use on the sampler's tile path.

Inputs are made with numpy from a seed and handed to both sides; t spans
the schedule (1 and T included).  Tolerance: 4 float32 ulps of scale
(2**-21 of the largest magnitude of the inputs and the output): both sides
run the same float32 operations, but XLA:CPU may contract a multiply-add
that PyTorch rounds twice.  A CFG or v-prediction eps served through
``DiffusionSampler(tile_resident=True)`` (B1's plain version on the CPU)
is held to the JAX service at the U-Net trajectory tolerance 1e-4 of
scale.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import core as jcore
from repro.sampling import SamplerPlan as JPlan
from repro.serving import DiffusionSampler as JSampler
from repro_torch import core as tcore
from repro_torch.sampling import SamplerPlan
from repro_torch.serving import DiffusionSampler

F32_TOL = 2.0 ** -21            # 4 float32 ulps of scale
TOL_OF_SCALE = 1e-4
JSCH = jcore.make_schedule("linear", T=1000)
TSCH = tcore.make_schedule("linear", 1000)
SHAPE = (5, 3, 4)


def _inputs(seed):
    r = np.random.RandomState(seed)
    a, b = (r.randn(*SHAPE).astype(np.float32) * 2 for _ in range(2))
    t = np.array([1, 250, 999, 1000, 500], np.int32)
    return a, b, t


def _close(got, want, *inputs):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(np.abs(want).max(), *(np.abs(x).max() for x in inputs))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= F32_TOL * scale


@pytest.mark.parametrize("name", ["v_from_eps_x0", "eps_from_v",
                                  "x0_from_v", "v_training_target"])
@pytest.mark.parametrize("seed", [0, 1])
def test_v_adapters_match_jax(name, seed):
    a, b, t = _inputs(seed)
    if name == "v_from_eps_x0":             # (schedule, t, eps, x0)
        jargs, targs = (t, a, b), (torch.from_numpy(t), torch.from_numpy(a),
                                   torch.from_numpy(b))
    elif name == "v_training_target":       # (schedule, x0, t, noise)
        jargs, targs = (a, t, b), (torch.from_numpy(a), torch.from_numpy(t),
                                   torch.from_numpy(b))
    else:                                   # (schedule, x_t, t, v)
        jargs, targs = (a, t, b), (torch.from_numpy(a), torch.from_numpy(t),
                                   torch.from_numpy(b))
    want = getattr(jcore, name)(JSCH, *(jnp.asarray(x) for x in jargs))
    got = getattr(tcore, name)(TSCH, *targs)
    _close(got, want, a, b)


def test_v_round_trip_recovers_eps_and_x0():
    """eps_from_v and x0_from_v invert v_from_eps_x0 at x_t = q_sample."""
    x0, eps, t = (torch.from_numpy(v) for v in _inputs(2))
    xt = tcore.q_sample(TSCH, x0, t, eps)
    v = tcore.v_from_eps_x0(TSCH, t, eps, x0)
    scale = float(max(x0.abs().max(), eps.abs().max()))
    assert float((tcore.eps_from_v(TSCH, xt, t, v) - eps).abs().max()) \
        <= 8 * F32_TOL * scale
    assert float((tcore.x0_from_v(TSCH, xt, t, v) - x0).abs().max()) \
        <= 8 * F32_TOL * scale


@pytest.mark.parametrize("guidance", [0.0, 1.0, 3.5])
def test_cfg_and_v_eps_fns_match_jax(guidance):
    x, _, t = _inputs(3)

    def pair(c):
        return (lambda xx, tt: jnp.tanh(c * xx)), \
            (lambda xx, tt: torch.tanh(c * xx))

    (jc, tc), (ju, tu) = pair(0.7), pair(-0.3)
    want = jcore.cfg_eps_fn(jc, ju, guidance)(jnp.asarray(x), jnp.asarray(t))
    got = tcore.cfg_eps_fn(tc, tu, guidance)(torch.from_numpy(x),
                                             torch.from_numpy(t))
    _close(got, want, x)
    want = jcore.eps_fn_from_v_fn(JSCH, jc)(jnp.asarray(x), jnp.asarray(t))
    got = tcore.eps_fn_from_v_fn(TSCH, tc)(torch.from_numpy(x),
                                           torch.from_numpy(t))
    _close(got, want, x)


@pytest.mark.parametrize("kind", ["cfg", "v"])
def test_adapters_serve_on_the_tile_path_like_jax(kind):
    """A CFG eps and a v-prediction eps served through the tile-resident
    service (B1 per step) give the JAX service's samples for one seed."""
    def models(J):
        tanh = jnp.tanh if J else torch.tanh
        cond = (lambda x, t: 0.8 * tanh(x))
        unc = (lambda x, t: 0.3 * x)
        core, sch = (jcore, JSCH) if J else (tcore, TSCH)
        if kind == "cfg":
            return core.cfg_eps_fn(cond, unc, 2.0)
        return core.eps_fn_from_v_fn(sch, cond)

    shape = (8, 8, 3)
    svc = DiffusionSampler(TSCH, models(False), shape, batch_size=4,
                           tile_resident=True, device="cpu")
    jsvc = JSampler(JSCH, models(True), shape, batch_size=4,
                    tile_resident=True)
    got, _ = svc.serve(4, SamplerPlan.build(TSCH, 10), seed=5)
    want, _ = jsvc.serve(4, JPlan.build(JSCH, 10), seed=5)
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= TOL_OF_SCALE * max(
        np.abs(want).max(), 1.0)
