"""float16 through the port's sampler against the JAX package, on the CPU.

JAX's public API reaches float16 in three ways, and each runs in the port
and matches JAX here (the port's wrappers take their plain versions on the
CPU; JAX's Pallas kernels run in interpret mode, as its own tests run them):

  * ``DiffusionSampler(..., dtype=float16, tile_resident=True).serve`` over
    a narrow U-Net, deterministic and eta = 1: x_T is JAX's float16 draw,
    each step the scalar step kernel (B1) on a float16 state and the
    model's float32 eps.  JAX's U-Net refuses a float16 input over float32
    weights (``lax.conv`` takes one dtype), so on both sides the eps model
    is the U-Net on the state promoted to float32, the type JAX's
    promotion of the pair gives.
  * ``ContinuousBatchingEngine(dtype=float16)`` is in
    ``test_torch_scheduler.py`` (its ``float16`` engine case).
  * The diffusion-LM: ``init_params(key, cfg, float16)`` is JAX's bitwise;
    ``plan.run(backend='mega')`` on a float16 state over float32, bfloat16
    and float16 weights (a float32, a float32 and a float16 trunk, as
    JAX promotes them) against JAX's ``jnp`` backend; ``generate(...,
    tile_resident=True)`` on float16 weights (a float32 state: JAX draws
    x_T in float32) gives JAX's tokens.

Tolerance: 4 float16 ulps (4 x 2^-10) of max|x| per run, against JAX's
state of the same type: both compute each step in float32 and round the
state to float16 after it, and a float32 difference of an ulp can flip a
float16 rounding, which the next steps carry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mega import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro import diffusion_lm as jdlm
from repro.core import make_schedule as j_make_schedule
from repro.core.sampler import SamplerConfig as JSamplerConfig
from repro.models import unet as junet
from repro.models.common import ArchConfig as JArch
from repro.sampling import SamplerPlan as JPlan
from repro.serving import engine as jengine
from repro_torch import configs, interop, prng
from repro_torch.core import make_schedule
from repro_torch.core.sampler import SamplerConfig
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.models import unet as tunet
from repro_torch.models.common import ArchConfig as TArch
from repro_torch.sampling import SamplerPlan
from repro_torch.sampling import backends as tback
from repro_torch.serving import DiffusionSampler

F16_TOL = 4 * 2.0 ** -10
JDT = {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
JSCH = j_make_schedule("linear", T=1000)
TSCH = make_schedule("linear", 1000)
SHAPE = (8, 8, 3)
UCFG = dict(in_channels=3, base_width=16, width_mults=(1, 2),
            n_res_blocks=1, attn_levels=(1,), time_dim=32)
B, SEQ = 2, 64


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= F16_TOL * float(np.abs(want).max()), err


# ------------------------------------------------------------ the U-Net
@pytest.fixture(scope="module")
def unets():
    """JAX's eps (one jit) and the port's on the same narrow U-Net weights,
    each promoting a float16 state to the float32 weights' type."""
    jcfg, tcfg = junet.UNetConfig(**UCFG), tunet.UNetConfig(**UCFG)
    tree = junet.init_params(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: (rs.randn(*np.shape(a)) / np.sqrt(np.prod(np.shape(a)[:-1]))
                   if np.ndim(a) > 1 else np.asarray(a)).astype(np.float32),
        tree)
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(interop.unet_params_from_jax(tree, tcfg))
    fwd = jax.jit(lambda x, t: junet.forward(tree, jcfg, x, t))
    teps = tunet.make_eps_fn(model.eval())
    return (lambda x, t: fwd(x.astype(jnp.float32), t),
            lambda x, t: teps(x.float(), t))


@pytest.mark.parametrize("sigma", [0.0, 1.0], ids=["eta0", "eta1"])
def test_diffusion_sampler_float16_serve_matches_jax(unets, sigma):
    jeps, teps = unets
    jsvc = jengine.DiffusionSampler(JSCH, jeps, SHAPE, 4,
                                    dtype=jnp.float16, tile_resident=True)
    svc = DiffusionSampler(TSCH, teps, SHAPE, 4, dtype=torch.float16,
                           tile_resident=True, device="cpu")
    want, jstats = jsvc.serve(6, JPlan.build(JSCH, tau=5, sigma=sigma),
                              seed=2)
    got, stats = svc.serve(6, SamplerPlan.build(TSCH, 5, sigma=sigma),
                           seed=2)
    assert stats["dtype"] == jstats["dtype"] == "float16"
    _close(got, want)


# --------------------------------------------------------- diffusion-LM
def _dlm_cfgs():
    arch = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                vocab=50)
    return (jdlm.DiffusionLMConfig(arch=JArch(name="t", family="dense",
                                              **arch), time_dim=32),
            tdlm.DiffusionLMConfig(arch=TArch(name="t", family="dense",
                                              **arch), time_dim=32))


@pytest.fixture(scope="module")
def dlm():
    jcfg, tcfg = _dlm_cfgs()
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b"])
def test_diffusion_lm_float16_init_bitwise_jax(arch):
    """Every leaf in float16 (float32 draws times the fan-in scale, cast),
    bitwise JAX's for the same key."""
    tcfg = tdlm.DiffusionLMConfig(arch=configs.get_smoke(arch), time_dim=32)
    jcfg = jdlm.DiffusionLMConfig(arch=jconfigs.get_smoke(arch), time_dim=32)
    want = jdlm.init_params(jax.random.PRNGKey(5), jcfg, jnp.float16)
    got = tdlm.init_params(prng.PRNGKey(5, "cpu"), tcfg, device="cpu",
                           dtype=torch.float16)
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in leaves:
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(leaf)
        assert str(g.dtype) == f"torch.{w.dtype}", path
        np.testing.assert_array_equal(g.numpy().view(np.uint16)
                                      if w.dtype == np.float16 else g.numpy(),
                                      w.view(np.uint16)
                                      if w.dtype == np.float16 else w)
    assert any(np.asarray(leaf).dtype == np.float16 for _, leaf in leaves)


@pytest.mark.parametrize("weights", ["f32", "bf16", "f16"])
def test_plan_run_mega_float16_state_matches_jax_jnp(dlm, weights):
    """A float16 state over float32, bfloat16 and float16 weights: 'mega'
    (the plain B3 on the CPU, K = 4, two chunks) against JAX's 'jnp'
    loop; the trunk runs in the pair's promotion (float16 only over
    float16 weights)."""
    jcfg, tcfg, jp, tp = dlm
    jw = jax.tree.map(lambda a: a.astype(JDT[weights]), jp)
    tw = interop.map_leaves(tp, lambda t: t.to(TDT[weights]))
    x = np.random.RandomState(1).randn(B, SEQ, 32).astype(np.float16)
    want = JPlan.build(JSCH, tau=6).run(jdlm.make_eps_fn(jw, jcfg),
                                        jnp.asarray(x), backend="jnp")
    eps = tdlm.make_tile_eps_fn(tw, tcfg, B, SEQ)
    got = SamplerPlan.build(TSCH, 6).run(eps, torch.from_numpy(x),
                                         backend="mega", k_fuse=4)
    assert tback.run_mega.last_reason == "ok"
    assert eps(torch.from_numpy(x).reshape(-1, 256), 500).dtype == \
        (torch.float16 if weights == "f16" else torch.float32)
    _close(got, want)


def test_generate_on_float16_weights_matches_jax(dlm):
    """generate(..., tile_resident=True) over float16 weights: x_T is
    float32 (JAX draws it so), the trunk float32 in the float16-weight
    megakernel's plain version; the tokens are JAX's."""
    jcfg, tcfg, jp, tp = dlm
    jw = jax.tree.map(lambda a: a.astype(jnp.float16), jp)
    tw = interop.map_leaves(tp, lambda t: t.to(torch.float16))
    want = jdlm.generate(jw, jcfg, JSCH, jax.random.PRNGKey(3), B, SEQ,
                         sampler=JSamplerConfig(S=4), tile_resident=True)
    got = tdlm.generate(tw, tcfg, TSCH, prng.PRNGKey(3, "cpu"), B, SEQ,
                        sampler=SamplerConfig(S=4), tile_resident=True,
                        device="cpu")
    assert tback.run_mega.last_reason == "ok"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
