"""The paper's encode / decode / interpolation path of the port against the
JAX package (paper §4.3 and Table 2, §5.3 and Fig. 6), and the forward
process of ``core/diffusion.py``.

Two eps models, each on both sides with the same parameters:
  * the 2-D toy model of ``tests/test_sampler_plan.py`` (elementwise in x:
    the closed-form eps of a Gaussian), written in both frameworks;
  * a narrow U-Net (base width 16, one level, one res block), the weights
    the JAX ``init_params`` gives, redrawn at fan-in scale from a numpy seed
    (as in ``test_torch_slice.py``) and carried over by ``interop``.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances, relative to the larger of the output's and the input's
largest magnitude:
  * 4 float32 ulps (2**-21) where the model is elementwise: both sides run
    the same float32 operations, but XLA:CPU may contract a multiply-add
    that PyTorch rounds twice;
  * TOL_OF_SCALE = 1e-4 through the U-Net, the trajectory tolerance of
    ``test_torch_slice.py`` (the two U-Nets agree to ~1e-6 of their output
    per evaluation, and the loop carries that through S steps).
Between two port backends that run the same arithmetic, and for
``traj[0]`` / ``traj[-1]`` against x_T / x_0, the test is bitwise.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import core as jcore
from repro import diffusion_lm as jdlm
from repro.models import unet as junet
from repro.models.common import ArchConfig as JArch
from repro.sampling import SamplerPlan as JPlan
from repro.sampling import TauSpec as JTau
from repro_torch import prng
from repro_torch import core as tcore
from repro_torch import interop
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.models import unet as tunet
from repro_torch.models.common import ArchConfig as TArch
from repro_torch.sampling import SamplerPlan, TauSpec
from repro_torch.sampling import backends as tback

F32_TOL = 2.0 ** -21            # 4 float32 ulps of scale
TOL_OF_SCALE = 1e-4
JSCH = jcore.make_schedule("linear", T=1000)
TSCH = tcore.make_schedule("linear", 1000)
UCFG = dict(in_channels=3, base_width=16, width_mults=(1,), n_res_blocks=1,
            attn_levels=(), time_dim=32)
SHAPES = {"toy": (2,), "unet": (8, 8, 3)}
BATCH = {"toy": 16, "unet": 2}
PLANS = {"uniform": dict(tau=10), "quadratic": dict(tau="quadratic"),
         "order2": dict(tau=10, order=2)}


def _toy_pair(mu=2.0, s=0.5):
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


@pytest.fixture(scope="module")
def models():
    """name -> (JAX eps_fn, port eps_fn, tolerance of scale)."""
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
    return {"toy": _toy_pair() + (F32_TOL,),
            "unet": (jfwd, tunet.make_eps_fn(model.eval()), TOL_OF_SCALE)}


def _data(name, seed=3):
    """Data-like x_0: around the toy model's mean, or image-scale."""
    x = np.random.RandomState(seed).randn(BATCH[name], *SHAPES[name])
    return (2.0 + 0.5 * x if name == "toy" else x).astype(np.float32)


def _plans(case):
    kw = dict(PLANS[case])
    if kw["tau"] == "quadratic":
        return (JPlan.build(JSCH, tau=JTau.quadratic(10)),
                SamplerPlan.build(TSCH, tau=TauSpec.quadratic(10)))
    return JPlan.build(JSCH, **kw), SamplerPlan.build(TSCH, **kw)


def _close(got, want, tol, *also):
    """max|got - want| <= tol * the largest magnitude of want and ``also``."""
    want = np.asarray(want)
    scale = max([float(np.abs(want).max())]
                + [float(np.abs(np.asarray(a)).max()) for a in also])
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (err, tol * scale)


# ------------------------------------------------------- encode / decode
@pytest.mark.parametrize("case", list(PLANS))
@pytest.mark.parametrize("name", ["toy", "unet"])
def test_encode_matches_jax(models, name, case):
    jeps, teps, tol = models[name]
    jp, tp = _plans(case)
    x0 = _data(name)
    want = jp.encode(jeps, jnp.asarray(x0))
    got = tp.encode(teps, torch.from_numpy(x0))
    assert got.shape == x0.shape and got.dtype == torch.float32
    _close(got, want, tol, x0)


@pytest.mark.parametrize("case", list(PLANS))
@pytest.mark.parametrize("name", ["toy", "unet"])
def test_eager_decode_matches_jax(models, name, case):
    """Decode one latent (JAX's encoding, handed to both sides)."""
    jeps, teps, tol = models[name]
    jp, tp = _plans(case)
    z = np.array(jp.encode(jeps, jnp.asarray(_data(name))))
    want = jp.run(jeps, jnp.asarray(z))
    got = tp.run(teps, torch.from_numpy(z), backend="eager")
    _close(got, want, tol, z)


@pytest.mark.parametrize("case", list(PLANS))
@pytest.mark.parametrize("name", ["toy", "unet"])
def test_round_trip_matches_jax(models, name, case):
    """Paper Table 2: encode then decode, each side on its own."""
    jeps, teps, tol = models[name]
    jp, tp = _plans(case)
    x0 = _data(name)
    want = jp.run(jeps, jp.encode(jeps, jnp.asarray(x0)))
    x = torch.from_numpy(x0)
    got = tp.run(teps, tp.encode(teps, x), backend="tile_resident")
    _close(got, want, tol, x0)


@pytest.mark.parametrize("name", ["toy", "unet"])
def test_encode_ignores_sigma_spec(models, name):
    jeps, teps, tol = models[name]
    x = torch.from_numpy(_data(name))
    z0 = SamplerPlan.build(TSCH, tau=10).encode(teps, x)
    z1 = SamplerPlan.build(TSCH, tau=10, sigma=1.0).encode(teps, x)
    assert torch.equal(z0, z1)
    want = JPlan.build(JSCH, tau=10, sigma=1.0).encode(jeps,
                                                       jnp.asarray(x.numpy()))
    _close(z1, want, tol, x)


@pytest.mark.parametrize("name", ["toy", "unet"])
def test_functional_encode_decode_match_jax(models, name):
    """core.ode.encode / decode against JAX's core.encode / decode."""
    jeps, teps, tol = models[name]
    x0 = _data(name)
    jz = jcore.encode(JSCH, jeps, jnp.asarray(x0), S=8)
    z = tcore.encode(TSCH, teps, torch.from_numpy(x0), S=8)
    _close(z, jz, tol, x0)
    zn = np.array(jz)
    _close(tcore.decode(TSCH, teps, torch.from_numpy(zn), S=8),
           jcore.decode(JSCH, jeps, jnp.asarray(zn), S=8), tol, zn)


# ----------------------------------------------------- return_trajectory
@pytest.mark.parametrize("backend", ["eager", "tile_resident", "rows",
                                     "mega"])
@pytest.mark.parametrize("name", ["toy", "unet"])
def test_return_trajectory(models, name, backend):
    jeps, teps, tol = models[name]
    jp, tp = _plans("uniform")
    x_T = np.random.RandomState(5).randn(BATCH[name], *SHAPES[name]).astype(
        np.float32)
    x = torch.from_numpy(x_T)
    x0, traj = tp.run(teps, x, backend=backend, return_trajectory=True)
    assert traj.shape == (tp.S + 1,) + x.shape
    assert torch.equal(traj[0], x) and torch.equal(traj[-1], x0)
    assert torch.equal(x0, tp.run(teps, x, backend=backend))
    jbackend = "jnp" if backend == "eager" else backend
    _, jtraj = jp.run(jeps, jnp.asarray(x_T), backend=jbackend,
                      return_trajectory=True)
    _close(traj, jtraj, tol, x_T)


def test_mega_trajectory_runs_the_tile_resident_loop():
    """A mega-eligible trunk with return_trajectory: the JAX rule runs the
    tile-resident scan; the port records why."""
    arch = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                vocab=50)
    jcfg = jdlm.DiffusionLMConfig(arch=JArch(name="t", family="dense",
                                             **arch), time_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=TArch(name="t", family="dense",
                                             **arch), time_dim=32)
    jparams = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    eps = tdlm.make_tile_eps_fn(tp, tcfg, 2, 64)
    plan = SamplerPlan.build(TSCH, 4)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 64, tcfg.latent_dim).astype(np.float32))
    x0, traj = plan.run(eps, x, backend="mega", return_trajectory=True)
    assert "trajectory" in tback.run_mega.last_reason
    x0_t, traj_t = plan.run(eps, x, backend="tile_resident",
                            return_trajectory=True)
    assert torch.equal(traj, traj_t) and torch.equal(x0, x0_t)
    plan.run(eps, x, backend="mega")
    assert tback.run_mega.last_reason == "ok"


# --------------------------------------------------------- interpolation
@pytest.mark.parametrize("alpha", [0.3, [0.0, 0.25, 0.5, 1.0]],
                         ids=["scalar", "vector"])
@pytest.mark.parametrize("name", ["toy", "unet"])
def test_slerp_matches_jax(name, alpha):
    rs = np.random.RandomState(9)
    a, b = (rs.randn(*SHAPES[name]).astype(np.float32) for _ in range(2))
    want = jcore.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(alpha))
    got = tcore.slerp(torch.from_numpy(a), torch.from_numpy(b), alpha)
    assert got.shape == np.shape(want)
    _close(got, want, 4 * F32_TOL, a, b)      # sin/arccos: a few ulps more
    if np.ndim(alpha):
        assert torch.allclose(got[0], torch.from_numpy(a), atol=1e-6)
        assert torch.allclose(got[-1], torch.from_numpy(b), atol=1e-6)


@pytest.mark.parametrize("n", [2, 5])
def test_slerp_grid_matches_jax(n):
    corners = np.random.RandomState(4).randn(4, 8, 8, 3).astype(np.float32)
    want = jcore.slerp_grid(jnp.asarray(corners), n)
    got = tcore.slerp_grid(torch.from_numpy(corners), n)
    assert got.shape == (n, n, 8, 8, 3)
    _close(got, want, 4 * F32_TOL, corners)


def test_decode_of_a_slerp_path_hits_its_endpoints(models):
    """Paper Fig. 6: decode the slerp path between two encodings as one
    batch; its endpoints are the decodes of the two latents."""
    jeps, teps, tol = models["unet"]
    plan = SamplerPlan.build(TSCH, 8)
    z = plan.encode(teps, torch.from_numpy(_data("unet")))
    path = tcore.slerp(z[0], z[1], torch.linspace(0, 1, 5))
    out = plan.run(teps, path, backend="tile_resident")
    ends = plan.run(teps, z, backend="tile_resident")
    for got, want in ((out[0], ends[0]), (out[-1], ends[1])):
        _close(got, want, TOL_OF_SCALE)
    jz = JPlan.build(JSCH, 8).encode(jeps, jnp.asarray(_data("unet")))
    jout = JPlan.build(JSCH, 8).run(
        jeps, jcore.slerp(jz[0], jz[1], jnp.linspace(0, 1, 5)))
    _close(out, jout, tol, z.numpy())


# ------------------------------------------------------ core/diffusion.py
def _diffusion_inputs():
    rs = np.random.RandomState(11)
    x0 = rs.randn(4, 8, 8, 3).astype(np.float32)
    noise = rs.randn(4, 8, 8, 3).astype(np.float32)
    t = np.array([1, 250, 600, 1000], np.int32)
    s = np.array([0, 200, 300, 999], np.int32)
    return x0, noise, t, s


DIFFUSION_FNS = {
    "q_sample": lambda m, sch, x0, n, t, s: m.q_sample(sch, x0, t, n),
    "predict_x0": lambda m, sch, x0, n, t, s: m.predict_x0(sch, x0, t, n),
    "predict_x0_clip": lambda m, sch, x0, n, t, s: m.predict_x0(
        sch, x0, t, n, clip=1.0),
    "eps_from_x0": lambda m, sch, x0, n, t, s: m.eps_from_x0(sch, x0, t, n),
    "posterior_sigma": lambda m, sch, x0, n, t, s: m.posterior_sigma(
        sch, t, s, 0.7),
    "sigma_hat": lambda m, sch, x0, n, t, s: m.sigma_hat(sch, t, s),
}


@pytest.mark.parametrize("fn", list(DIFFUSION_FNS))
def test_diffusion_functions_match_jax(fn):
    x0, noise, t, s = _diffusion_inputs()
    f = DIFFUSION_FNS[fn]
    want = f(jcore, JSCH, jnp.asarray(x0), jnp.asarray(noise),
             jnp.asarray(t), jnp.asarray(s))
    got = f(tcore, TSCH, torch.from_numpy(x0), torch.from_numpy(noise),
            torch.from_numpy(t), torch.from_numpy(s))
    assert got.shape == np.shape(want)
    _close(got, want, F32_TOL)


def test_gamma_weights_match_jax():
    sigma = np.linspace(0.1, 1.0, 1000).astype(np.float32)
    want = jcore.gamma_weights(JSCH, jnp.asarray(sigma), 3072)
    got = tcore.gamma_weights(TSCH, torch.from_numpy(sigma), 3072)
    assert got.shape == (1000,)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["toy", "unet"])
def test_simple_loss_matches_jax(models, name, weighted):
    jeps, teps, tol = models[name]
    rs = np.random.RandomState(12)
    x0 = rs.randn(BATCH[name], *SHAPES[name]).astype(np.float32)
    noise = rs.randn(*x0.shape).astype(np.float32)
    t = rs.randint(1, 1001, BATCH[name]).astype(np.int32)
    w = np.linspace(0.5, 2.0, 1000).astype(np.float32) if weighted else None
    want = jcore.simple_loss(JSCH, jeps, jnp.asarray(x0), jnp.asarray(t),
                             jnp.asarray(noise),
                             None if w is None else jnp.asarray(w))
    got = tcore.simple_loss(TSCH, teps, torch.from_numpy(x0),
                            torch.from_numpy(t), torch.from_numpy(noise),
                            None if w is None else torch.from_numpy(w))
    assert got.dim() == 0
    _close(got, want, tol)


def test_training_loss_draws_from_the_generator(models):
    """training_loss is simple_loss at (t, eps) drawn from the key as JAX
    draws them (``k_t, k_e = split(rng)``, randint and normal), within 4
    ulps (the normals' tolerance in ``test_torch_prng.py``): the same seed
    gives that loss, another seed another."""
    _, teps, _ = models["toy"]
    x0 = torch.from_numpy(_data("toy"))
    loss = lambda seed: tcore.training_loss(  # noqa: E731
        TSCH, teps, x0, prng.PRNGKey(seed, "cpu"))
    k_t, k_e = jax.random.split(jax.random.PRNGKey(4))
    t = torch.from_numpy(np.asarray(
        jax.random.randint(k_t, (x0.shape[0],), 1, TSCH.T + 1)))
    noise = torch.from_numpy(np.asarray(jax.random.normal(k_e, x0.shape)))
    want = tcore.simple_loss(TSCH, teps, x0, t, noise)
    assert float(abs(loss(4) - want)) <= F32_TOL * float(want)
    assert not torch.equal(loss(5), want)


# ------------------------------------------------ probability flow, views
@pytest.mark.parametrize("tau_kind", ["linear", "quadratic"])
@pytest.mark.parametrize("name", ["toy", "unet"])
def test_probability_flow_sample_matches_jax(models, name, tau_kind):
    jeps, teps, tol = models[name]
    x_T = np.random.RandomState(6).randn(BATCH[name], *SHAPES[name]).astype(
        np.float32)
    want = jcore.probability_flow_sample(JSCH, jeps, jnp.asarray(x_T), S=10,
                                         tau_kind=tau_kind)
    got = tcore.probability_flow_sample(TSCH, teps, torch.from_numpy(x_T),
                                        S=10, tau_kind=tau_kind)
    _close(got, want, tol, x_T)


@pytest.mark.parametrize("cfg", [dict(S=10), dict(S=7, eta=0.5),
                                 dict(S=20, tau_kind="quadratic"),
                                 dict(S=10, eta=1.0, sigma_hat=True)],
                         ids=["ddim", "eta0.5", "quadratic", "sigma_hat"])
def test_trajectory_coefficients_bitwise(cfg):
    want = jcore.trajectory_coefficients(JSCH, jcore.SamplerConfig(**cfg))
    got = tcore.trajectory_coefficients(TSCH, tcore.SamplerConfig(**cfg))
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k


# ------------------------------------------------------------- the shims
SHIMS = {
    "ddim_sample": (lambda m, sch, eps, x, gen: m.ddim_sample(
        sch, eps, x, S=10), lambda sch: dict(tau=10)),
    "ddpm_sample": (lambda m, sch, eps, x, gen: m.ddpm_sample(
        sch, eps, x, gen, S=10), lambda sch: dict(tau=10, sigma=1.0)),
    "multistep_sample": (lambda m, sch, eps, x, gen: m.multistep_sample(
        sch, eps, x, S=10, order=2), lambda sch: dict(tau=10, order=2)),
}


@pytest.mark.parametrize("shim", list(SHIMS))
def test_shims_warn_and_equal_their_plan(models, shim):
    jeps, teps, tol = models["toy"]
    call, plan_kw = SHIMS[shim]
    x_T = np.random.RandomState(8).randn(16, 2).astype(np.float32)
    x = torch.from_numpy(x_T)
    with pytest.warns(DeprecationWarning, match=shim):
        got = call(tcore, TSCH, teps, x, prng.PRNGKey(2, "cpu"))
    plan = SamplerPlan.build(TSCH, **plan_kw(TSCH))
    want = plan.run(teps, x, prng.PRNGKey(2, "cpu")
                    if plan.stochastic else None)
    assert torch.equal(got, want)
    if not plan.stochastic:      # JAX's noise is its own: compare eta=0 only
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            jwant = call(jcore, JSCH, jeps, jnp.asarray(x_T),
                         jax.random.PRNGKey(2))
        _close(got, jwant, tol, x_T)


def test_core_exports_what_jax_core_exports():
    """The names JAX's core exports from the modules this package ports."""
    ported = {"q_sample", "predict_x0", "eps_from_x0", "posterior_sigma",
              "sigma_hat", "gamma_weights", "simple_loss", "training_loss",
              "trajectory_coefficients", "ddim_sample", "ddpm_sample",
              "encode", "decode", "probability_flow_sample",
              "multistep_sample", "slerp", "slerp_grid"}
    assert ported <= set(jcore.__all__) and ported <= set(tcore.__all__)
    assert all(callable(getattr(tcore, n)) for n in ported)


def test_decode_counts_no_launch_on_the_cpu(models):
    """On CPU tensors decode runs the plain step; nothing is launched."""
    from repro_torch.kernels.sampler_step import kernel
    _, teps, _ = models["toy"]
    n0 = kernel.sampler_step_2d.launches
    tcore.decode(TSCH, teps, torch.from_numpy(_data("toy")), S=5)
    assert kernel.sampler_step_2d.launches == n0

