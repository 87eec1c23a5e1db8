"""The dense diffusion-LM trunk of the port against the JAX package: the
attention and dense layer, ``eps_forward`` on weights carried over by
``interop.dlm_params_from_jax``, the sampler adapter, and ``generate``.

Tolerance: 1e-4 of max|eps| for trunk forwards (float32; the products sum
in another order, and the sinusoid's arguments reach ~1e3 rad).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import diffusion_lm as jdlm
from repro.core import SamplerConfig as JSamplerConfig
from repro.core import make_schedule as j_make_schedule
from repro.models import attention as jattn
from repro.models import dense as jdense
from repro.models.common import ArchConfig as JArch
from repro.sampling import SamplerPlan as JPlan
from repro_torch import prng
from repro_torch import configs, interop
from repro_torch.core import SamplerConfig, make_schedule, sample
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.models import attention as tattn
from repro_torch.models import dense as tdense
from repro_torch.models.common import ArchConfig as TArch
from repro_torch.sampling import SamplerPlan

TOL_OF_SCALE = 1e-4
SMOKE = dict(n_layers=2, d_model=192, n_heads=3, n_kv_heads=3, head_dim=64,
             d_ff=512, vocab=512)                 # smollm-135m SMOKE widths
GQA = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab=50)


def _cfgs(arch, time_dim=32, latent=32):
    ja = JArch(name="t", family="dense", **arch)
    ta = TArch(name="t", family="dense", **arch)
    return (jdlm.DiffusionLMConfig(arch=ja, time_dim=time_dim,
                                   latent_dim=latent),
            tdlm.DiffusionLMConfig(arch=ta, time_dim=time_dim,
                                   latent_dim=latent))


def _params(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", [SMOKE, GQA], ids=["smoke", "gqa"])
def test_eps_forward_matches_jax(arch):
    jcfg, tcfg, jp, tp = _params(arch)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 64, 32).astype(np.float32)
    t = np.array([999, 17], np.int32)
    want = jdlm.eps_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(t))
    got = tdlm.eps_forward(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(t))
    assert _rel_err(got, want) <= TOL_OF_SCALE


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gqa_forward_and_layer_match_jax(causal):
    jcfg, tcfg, jp, tp = _params(GQA)
    layer_j = jax.tree.map(lambda a: a[0], jp["layers"])
    layer_t = tdense.layer_params(tp["layers"], 0)
    x = np.random.RandomState(2).randn(2, 24, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    want = jattn.gqa_forward(layer_j["attn"], jcfg.arch, jnp.asarray(x),
                             jnp.asarray(pos), causal=causal)
    got = tattn.gqa_forward(layer_t["attn"], tcfg.arch, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), causal=causal)
    assert _rel_err(got, want) <= TOL_OF_SCALE
    want = jdense.layer_fwd(layer_j, jcfg.arch, jnp.asarray(x),
                            jnp.asarray(pos), causal=causal)
    got = tdense.layer_fwd(layer_t, tcfg.arch, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()), causal=causal)
    assert _rel_err(got, want) <= TOL_OF_SCALE


def test_param_shapes_match_jax_init():
    jcfg, tcfg = _cfgs(GQA)
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tdlm.param_shapes(tcfg) == want


def test_interop_rejects_unmapped_missing_and_misshaped_leaves():
    jcfg, tcfg = _cfgs(GQA)
    tree = jax.tree.map(np.asarray,
                        jdlm.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(KeyError, match="unmapped"):
        interop.dlm_params_from_jax({**tree, "extra": np.zeros(3)}, tcfg)
    with pytest.raises(KeyError, match="no JAX leaf"):
        interop.dlm_params_from_jax(
            {k: v for k, v in tree.items() if k != "w_out"}, tcfg)
    with pytest.raises(ValueError, match="w_in"):
        interop.dlm_params_from_jax({**tree, "w_in": tree["w_in"].T}, tcfg)


def test_init_params_scheme():
    """The port's init: the JAX shapes, norm scales 1, fan-in
    truncated-normal weights, w_down at its depth-scaled std (its numbers
    are held to JAX's in ``test_torch_init.py``)."""
    _, tcfg = _cfgs(SMOKE)
    p = tdlm.init_params(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert shapes == tdlm.param_shapes(tcfg)
    assert torch.equal(p["layers"]["attn_norm"], torch.ones(2, 192))
    w = p["layers"]["attn"]["wq"]
    trunc_std = 0.9866                  # std of N(0, 1) cut to [-3, 3]
    assert abs(float(w.std()) * 192 ** 0.5 - trunc_std) < 0.03
    assert float(w.abs().max()) <= 3 * 192 ** -0.5
    wd = p["layers"]["w_down"]
    want = 512 ** -0.5 / 2.0 * trunc_std
    assert abs(float(wd.std()) - want) < 0.05 * want


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs(GQA)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdlm.init_params(prng.PRNGKey(0, "cpu"), tcfg)
    p = tdlm.init_params(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdlm.generate(p, tcfg, make_schedule("linear", 1000),
                      prng.PRNGKey(0, "cpu"), 2, 64)


def test_other_families_name_their_jax_module():
    """The ssm trunk builds rwkv6 layers (its leaves the shapes of
    ``param_shapes``); a family the JAX trunk does not know raises
    ValueError naming it, as JAX's does."""
    arch = dict(name="m", n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                d_ff=64, vocab=10)
    cfg = tdlm.DiffusionLMConfig(arch=TArch(family="ssm", **arch))
    p = tdlm.init_params(prng.PRNGKey(0, "cpu"), cfg, device="cpu")
    assert set(p["layers"]) == {"ln1", "ln2", "tm", "cm"}
    assert jax.tree.map(lambda t: tuple(t.shape), p) == tdlm.param_shapes(cfg)
    bad = tdlm.DiffusionLMConfig(arch=TArch(family="rnn", **arch))
    with pytest.raises(ValueError, match="rnn"):
        tdlm.init_params(prng.PRNGKey(0, "cpu"), bad, device="cpu")


def test_configs_carry_smollm_widths():
    a = configs.DLM_SMOLLM.arch
    assert (a.n_layers, a.d_model, a.n_heads, a.n_kv_heads, a.hd(), a.d_ff,
            a.vocab) == (30, 576, 9, 3, 64, 1536, 49152)
    assert configs.DLM_SMOLLM_MEGA.arch == dataclasses.replace(
        a, name="smollm-135m-2l", n_layers=2)
    for c in (configs.DLM_SMOLLM, configs.DLM_SMOLLM_MEGA):
        assert (c.time_dim, c.latent_dim) == (256, 32)
    s = configs.SMOLLM_135M_SMOKE
    assert (s.n_layers, s.d_model, s.n_heads, s.d_ff) == (2, 192, 3, 512)


@pytest.mark.parametrize("cfg", [dict(S=10), dict(S=7, tau_kind="quadratic"),
                                 dict(S=5, eta=1.0, sigma_hat=True),
                                 dict(S=4, clip_x0=1.0)], ids=str)
def test_sampler_config_compiles_the_jax_table(cfg):
    jt = JSamplerConfig(**cfg).to_plan(j_make_schedule("linear", 1000))
    tt = SamplerConfig(**cfg).to_plan(make_schedule("linear", 1000))
    assert isinstance(tt, SamplerPlan) and isinstance(jt, JPlan)
    for k, v in jt.steps().items():
        np.testing.assert_array_equal(tt.steps()[k], v)


def test_generate_composes_on_the_port():
    """Tokens (B, S) int32 in the vocabulary; tile_resident (through
    'mega') and the eager loop give the same tokens on the CPU; rounding
    embedded tokens is the composition the JAX package computes."""
    jcfg, tcfg, jp, tp = _params(GQA)
    sch = make_schedule("linear", 1000)
    kw = dict(sampler=SamplerConfig(S=4), device="cpu")
    a = tdlm.generate(tp, tcfg, sch, prng.PRNGKey(3, "cpu"), 2,
                      64, tile_resident=True, **kw)
    b = tdlm.generate(tp, tcfg, sch, prng.PRNGKey(3, "cpu"), 2,
                      64, **kw)
    assert a.shape == (2, 64) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < GQA["vocab"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = tdlm.generate(tp, tcfg, sch, prng.PRNGKey(3, "cpu"), 2,
                      64, sampler=SamplerConfig(S=4),
                      device=torch.device("cpu", 0))
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    with pytest.raises(ValueError, match="params lie on"):
        tdlm.generate(tp, tcfg, sch, prng.PRNGKey(0, "cpu"), 2, 64,
                      device="meta")
    tok = np.random.RandomState(4).randint(0, GQA["vocab"], (2, 64))
    want = jdlm.round_to_tokens(jp, jdlm.embed_tokens(jp, jnp.asarray(tok)))
    got = tdlm.round_to_tokens(tp, tdlm.embed_tokens(
        tp, torch.from_numpy(tok)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(5))
    eps = tdlm.make_eps_fn(tp, tcfg)
    torch.testing.assert_close(
        sample(sch, eps, x, SamplerConfig(S=3)),
        SamplerConfig(S=3).to_plan(sch).run(eps, x), rtol=0, atol=0)


# ------------------------------------------------------------ moe trunk
MOE_TRUNKS = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]


def _moe_params(arch):
    from repro import configs as jconfigs
    ja, ta = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jcfg = jdlm.DiffusionLMConfig(arch=ja, time_dim=32)
    tcfg = tdlm.DiffusionLMConfig(arch=ta, time_dim=32)
    jp = jdlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.dlm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", MOE_TRUNKS, ids=["mla", "gqa"])
def test_moe_trunk_eps_forward_matches_jax(arch):
    """The moe trunk: MLA layers causal (JAX's trunk calls mla_forward),
    GQA layers bidirectional, each with the routed-expert FFN."""
    jcfg, tcfg, jp, tp = _moe_params(arch)
    x = np.random.RandomState(1).randn(2, 64, 32).astype(np.float32)
    t = np.array([999, 17], np.int32)
    want = jdlm.eps_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(t))
    got = tdlm.eps_forward(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(t))
    assert _rel_err(got, want) <= TOL_OF_SCALE


@pytest.mark.parametrize("arch", MOE_TRUNKS, ids=["mla", "gqa"])
def test_moe_trunk_generate_runs_tile_resident_like_jax(arch):
    """A moe trunk carries no mega_spec in either package, so 'mega' runs
    the tile-resident loop (B1 per step on the card), with the reason in
    run_mega.last_reason; tokens equal the eager loop's and JAX's."""
    from repro_torch.sampling import backends
    jcfg, tcfg, jp, tp = _moe_params(arch)
    sch = make_schedule("linear", 1000)
    eps = tdlm.make_tile_eps_fn(tp, tcfg, 2, 64)
    assert getattr(eps, "mega_spec", None) is None
    assert not hasattr(jdlm.make_tile_eps_fn(jp, jcfg, 2, 64), "mega_spec")
    kw = dict(sampler=SamplerConfig(S=4), device="cpu")
    a = tdlm.generate(tp, tcfg, sch, prng.PRNGKey(3, "cpu"), 2, 64,
                      tile_resident=True, **kw)
    assert "mega_spec" in backends.run_mega.last_reason
    b = tdlm.generate(tp, tcfg, sch, prng.PRNGKey(3, "cpu"), 2, 64, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = jdlm.generate(jp, jcfg, j_make_schedule("linear", 1000),
                         jax.random.PRNGKey(3), 2, 64,
                         sampler=JSamplerConfig(S=4), tile_resident=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))
