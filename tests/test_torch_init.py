"""The port's initial weights against the JAX package's for one threefry
key: every leaf of the U-Net, dense, vlm, moe (MLA and GQA) and
diffusion-LM (dense and moe trunks) smoke inits, bitwise.

The inits draw with ``prng.truncated_normal`` / ``prng.normal`` (bitwise
``jax.random`` on the CPU, ``tests/test_torch_prng.py``) in float32, scale
and cast as JAX does, and hand out keys in JAX's ``KeyGen`` order;
``stack_layer_params`` draws layer by layer where JAX vmaps, which gives
the same bits (no leaf differs here, so the test is bitwise).  Draws are
chunked over the counter range; a chunked draw is bitwise the whole one.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro import diffusion_lm as jdlm
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.models import unet as junet
from repro_torch import configs, interop, prng
from repro_torch.diffusion_lm import model as tdlm
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry
from repro_torch.models import unet as tunet

LM_IDS = ["smollm-135m", "llama3.2-3b", "deepseek-7b", "mistral-large-123b",
          "deepseek-v2-236b", "kimi-k2-1t-a32b", "llava-next-mistral-7b"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


def _assert_same_tree(jtree, ttree):
    j = dict(_leaves(jax.tree.map(np.asarray, jtree)))
    t = dict(_leaves(ttree))
    assert sorted(j) == sorted(t)
    for name, want in j.items():
        got = t[name]
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
        assert np.array_equal(got.float().numpy(),
                              want.astype(np.float32)), name


@pytest.mark.parametrize("arch", LM_IDS)
@pytest.mark.parametrize("seed", [0, 7])
def test_lm_smoke_inits_bitwise_jax(arch, seed):
    tcfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    want = jregistry.get_api(jcfg).init_params(jax.random.PRNGKey(seed),
                                               jcfg)
    got = tregistry.get_api(tcfg).init_params(prng.PRNGKey(seed, "cpu"),
                                              tcfg, device="cpu")
    _assert_same_tree(want, got)
    # the layout interop carries across is the init's
    shapes = interop.map_leaves(interop.lm_param_shapes(tcfg), tuple)
    assert interop.map_leaves(got, lambda t: tuple(t.shape)) == shapes


def test_bfloat16_init_bitwise_jax():
    tcfg = configs.get_smoke("deepseek-v2-236b")
    jcfg = jconfigs.get_smoke("deepseek-v2-236b")
    want = jregistry.get_api(jcfg).init_params(jax.random.PRNGKey(2), jcfg,
                                               jnp.bfloat16)
    got = tregistry.get_api(tcfg).init_params(
        prng.PRNGKey(2, "cpu"), tcfg, device="cpu", dtype=torch.bfloat16)
    assert got["layers"]["moe"]["router"].dtype == torch.float32
    _assert_same_tree(want, got)


@pytest.mark.parametrize("name", ["TOY_UNET", "narrow"])
def test_unet_init_bitwise_jax(name):
    cfg = (configs.TOY_UNET if name == "TOY_UNET" else tunet.UNetConfig(
        in_channels=3, base_width=16, width_mults=(1, 2), n_res_blocks=1,
        attn_levels=(0,), time_dim=32))
    jcfg = junet.UNetConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.asarray, junet.init_params(
        jax.random.PRNGKey(4), jcfg))
    want = interop.unet_params_from_jax(tree, cfg)
    model = tunet.init_params(prng.PRNGKey(4, "cpu"), cfg, device="cpu")
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # init_tree is JAX's pytree itself
    jt = dict(_leaves_list(tree))
    tt = {k: v.numpy() for k, v in _leaves_list(
        tunet.init_tree(prng.PRNGKey(4, "cpu"), cfg))}
    assert sorted(jt) == sorted(tt)
    assert all(np.array_equal(jt[k], tt[k]) for k in jt)


def _leaves_list(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_list(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_list(v, path + (str(i),))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b", "rwkv6-7b"])
def test_diffusion_lm_inits_bitwise_jax(arch):
    tcfg = tdlm.DiffusionLMConfig(arch=configs.get_smoke(arch), time_dim=32)
    jcfg = jdlm.DiffusionLMConfig(arch=jconfigs.get_smoke(arch), time_dim=32)
    want = jdlm.init_params(jax.random.PRNGKey(5), jcfg)
    got = tdlm.init_params(prng.PRNGKey(5, "cpu"), tcfg, device="cpu")
    _assert_same_tree(want, got)
    assert interop.map_leaves(got, lambda t: tuple(t.shape)) == \
        interop.map_leaves(tdlm.param_shapes(tcfg), tuple)


@pytest.mark.parametrize("shape,chunk", [((37, 29), 100), ((3, 5, 64), 7),
                                         ((1000,), 999), ((4, 4), 1)])
def test_chunked_draw_is_the_whole_draw(shape, chunk):
    key = prng.PRNGKey(3, "cpu")
    for fn in (tcommon.dense_init, tcommon.embed_init):
        whole = fn(key, shape, torch.float32, chunk=1 << 40)
        part = fn(key, shape, torch.float32, chunk=chunk)
        assert torch.equal(whole, part)
    want = np.asarray(jcommon.dense_init(jax.random.PRNGKey(3), shape,
                                         jnp.float32, scale=0.3))
    got = tcommon.dense_init(key, shape, torch.float32, scale=0.3,
                             chunk=chunk)
    assert np.array_equal(got.numpy(), want)


def test_fan_in_rule_and_keygen_are_jax():
    """fan_in = shape[0] (E for a 3-D expert weight), normal * 0.02 for
    embeddings, and KeyGen hands out JAX's keys."""
    for shape in [(6, 4, 5), (7, 3), (9,)]:
        want = np.asarray(jcommon.dense_init(jax.random.PRNGKey(1), shape,
                                             jnp.float32))
        got = tcommon.dense_init(prng.PRNGKey(1, "cpu"), shape, torch.float32)
        assert np.array_equal(got.numpy(), want)
    want = np.asarray(jcommon.embed_init(jax.random.PRNGKey(8), (11, 6),
                                         jnp.float32))
    assert np.array_equal(tcommon.embed_init(prng.PRNGKey(8, "cpu"), (11, 6),
                                             torch.float32).numpy(), want)
    jk, tk = jcommon.KeyGen(jax.random.PRNGKey(5)), \
        tcommon.KeyGen(prng.PRNGKey(5, "cpu"))
    for _ in range(4):
        assert np.array_equal(np.asarray(jk()), tk().numpy())


def test_cpu_draws_in_two_threads_restore_the_thread_count():
    """A draws, B starts, A ends, B ends: one intra-op thread while either
    is in flight, the caller's count after both."""
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        a_in, b_in, a_out = threading.Event(), threading.Event(), \
            threading.Event()
        seen = {}

        def a():
            with tcommon._one_cpu_thread(torch.device("cpu")):
                a_in.set()
                b_in.wait(10)
            a_out.set()

        def b():
            a_in.wait(10)
            with tcommon._one_cpu_thread(torch.device("cpu")):
                b_in.set()
                a_out.wait(10)
                seen["b_after_a"] = torch.get_num_threads()

        ts = [threading.Thread(target=f) for f in (a, b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(20)
        assert seen["b_after_a"] == 1
        assert torch.get_num_threads() == 3
        key = prng.PRNGKey(2, "cpu")
        outs = [None, None]

        def draw(i):
            outs[i] = tcommon.dense_init(key, (64, 33), torch.float32,
                                         chunk=100)
        ts = [threading.Thread(target=draw, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(20)
        assert torch.equal(outs[0], outs[1])
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)


def test_stack_layer_params_is_jax_vmap():
    def jinit(k):
        kg = jcommon.KeyGen(k)
        return {"a": jcommon.dense_init(kg(), (5, 3), jnp.float32),
                "b": {"c": jcommon.embed_init(kg(), (4,), jnp.float32)}}

    def tinit(k):
        kg = tcommon.KeyGen(k)
        return {"a": tcommon.dense_init(kg(), (5, 3), torch.float32),
                "b": {"c": tcommon.embed_init(kg(), (4,), torch.float32)}}

    want = jcommon.stack_layer_params(jinit, 3, jcommon.KeyGen(
        jax.random.PRNGKey(6)))
    got = tcommon.stack_layer_params(tinit, 3, tcommon.KeyGen(
        prng.PRNGKey(6, "cpu")))
    _assert_same_tree(want, got)


def test_inits_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("deepseek-v2-236b", "llava-next-mistral-7b"):
        cfg = configs.get_smoke(arch)
        with pytest.raises(RuntimeError, match="CUDA"):
            tregistry.get_api(cfg).init_params(prng.PRNGKey(0, "cpu"), cfg)
