"""The MoE family (``models/moe.py``, MLA in ``models/attention.py``,
``runtime_flags.moe_group``, the registry, the configs and ``interop``)
against the JAX package on the CPU at smoke sizes, with JAX's weights
(the port's init of the same key is bitwise JAX's, ``test_torch_init.py``).

Tolerances:
  * ``route``: the dispatch one-hots bitwise (the top-k picks, the slot of
    every choice and every drop are exact), combine within 1e-6 and the
    aux loss within 1e-6 relative (float32 sums in another order);
  * ``moe_ffn``, MLA outputs, ``forward``, ``prefill`` and decode logits:
    1e-5 of max|.| of JAX's (float32 products sum in another order);
  * the cache path against the cache-free forward of the same tokens:
    1e-5 of max|logits|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import runtime_flags as jflags
from repro.models.common import ArchConfig as JArch
from repro_torch import configs, interop
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as tregistry
from repro_torch.models.runtime_flags import FLAGS, perf_flags

TOL_OF_SCALE = 1e-5
MOE_IDS = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
NEW_IDS = MOE_IDS + ["llava-next-mistral-7b"]

_PARAMS = {}


def _jcfg(tcfg):
    return JArch(**dataclasses.asdict(tcfg))


def _params(arch):
    if arch not in _PARAMS:
        tcfg = configs.get_smoke(arch)
        jp = jmoe.init_params(jax.random.PRNGKey(0), _jcfg(tcfg))
        tp = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
        _PARAMS[arch] = (tcfg, jp, tp)
    return _PARAMS[arch]


def _close(got, want, tol=TOL_OF_SCALE):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", NEW_IDS)
def test_configs_field_for_field(arch):
    for get in ("get", "get_smoke"):
        t = getattr(configs, get)(arch)
        j = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(t).keys() <= dataclasses.asdict(j).keys()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        t.validate()


def test_registry_serves_moe_and_vlm():
    for arch, fam, embeds in (("deepseek-v2-236b", "moe", False),
                              ("kimi-k2-1t-a32b", "moe", False),
                              ("llava-next-mistral-7b", "vlm", True)):
        api = tregistry.get_api(configs.get_smoke(arch))
        assert api is tregistry.FAMILIES[fam]
        assert api.needs_embeds == jregistry.FAMILIES[fam].needs_embeds \
            == embeds
    assert set(tregistry.FAMILIES) == set(jregistry.FAMILIES)
    bad = dataclasses.replace(configs.DEEPSEEK_V2_236B_SMOKE, kv_lora=0)
    with pytest.raises(AssertionError):
        bad.validate()


# ------------------------------------------------------------- routing
def _route_case(arch, seed, G, S, C, zeros=0):
    tcfg, jp, _ = _params(arch)
    rw = np.asarray(jp["layers"]["moe"]["router"][0])
    x = np.random.RandomState(seed).randn(G, S, tcfg.d_model).astype(
        np.float32)
    if zeros:
        x[:, -zeros:] = 0.0                 # exact ties among the experts
    jd, jc, ja = jmoe.route(jnp.asarray(rw), jnp.asarray(x), _jcfg(tcfg), C)
    td, tc, ta = tmoe.route(torch.from_numpy(rw.copy()),
                            torch.from_numpy(x), tcfg, C)
    assert td.dtype == torch.float32 and tuple(td.shape) == (
        G, S, tcfg.n_experts, C)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-6
    assert abs(float(ta) - float(ja)) <= 1e-6 * abs(float(ja))
    return td


@pytest.mark.parametrize("arch", MOE_IDS)
@pytest.mark.parametrize("C", [1, 3, 16])
def test_route_dispatch_bitwise_jax(arch, C):
    d = _route_case(arch, C, 2, 24, C)
    # every expert holds at most C tokens, each slot at most one token
    assert float(d.sum((1,)).max()) <= 1.0
    assert float(d.sum((1, 3)).max()) <= C


@pytest.mark.parametrize("arch", MOE_IDS)
def test_route_ties_take_the_lower_expert(arch):
    """Zero tokens (the padding moe_ffn adds) see equal probabilities:
    top-k picks experts 0..K-1 in order, as jax.lax.top_k."""
    d = _route_case(arch, 5, 1, 12, 8, zeros=4)
    tcfg = configs.get_smoke(arch)
    picked = d[0, -4:].sum(-1).nonzero()[:, 1].reshape(4, -1)
    assert picked.tolist() == [list(range(tcfg.top_k))] * 4


@pytest.mark.parametrize("arch", MOE_IDS)
@pytest.mark.parametrize("B,S,group", [(2, 8, 512), (3, 5, 4), (1, 7, 3)])
def test_moe_ffn_matches_jax(arch, B, S, group):
    """Padding to a whole group and the capacity per group as JAX's."""
    tcfg, jp, tp = _params(arch)
    x = np.random.RandomState(B * S).randn(B, S, tcfg.d_model).astype(
        np.float32)
    jblock = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tblock = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    with jflags.perf_flags(moe_group=group):
        jy, ja = jmoe.moe_ffn(jblock, _jcfg(tcfg), jnp.asarray(x))
    with perf_flags(moe_group=group):
        ty, ta = tmoe.moe_ffn(tblock, tcfg, torch.from_numpy(x))
    assert FLAGS.moe_group == 512
    _close(ty, jy)
    assert abs(float(ta) - float(ja)) <= 1e-6 * abs(float(ja))


@pytest.mark.parametrize("arch", MOE_IDS)
def test_decode_capacity_drops_like_jax(arch):
    """At decode N = batch, so C is tiny (deepseek-v2 at batch 4: C = 1);
    JAX drops there too, and the one-hots are its own."""
    tcfg = configs.get_smoke(arch)
    full = configs.get(arch)
    assert tmoe._capacity(full, 4) == jmoe._capacity(_jcfg(full), 4)
    assert tmoe._capacity(configs.DEEPSEEK_V2_236B, 4) == 1
    d = _route_case(arch, 11, 1, 4, tmoe._capacity(tcfg, 4))
    assert d.shape[-1] == tmoe._capacity(tcfg, 4)


# ------------------------------------------------------------------ MLA
def test_mla_forward_prefill_and_decode_match_jax():
    tcfg, jp, tp = _params("deepseek-v2-236b")
    jc = _jcfg(tcfg)
    ja = jp["layer0"]["attn"]
    ta = tp["layer0"]["attn"]
    B, S, M = 2, 6, 10
    x = np.random.RandomState(1).randn(B, S + 3, tcfg.d_model).astype(
        np.float32) * 0.5
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _close(tattn.mla_forward(ta, tcfg, torch.from_numpy(x[:, :S]),
                             torch.from_numpy(pos.copy())),
           jattn.mla_forward(ja, jc, jnp.asarray(x[:, :S]), jnp.asarray(pos)))
    jcache = jattn.init_mla_cache(jc, B, M, 1, jnp.float32)
    tcache = tattn.init_mla_cache(tcfg, B, M, 1, device="cpu")
    jout, jckv, jkr = jattn.mla_prefill(jcache["ckv"][0], jcache["krope"][0],
                                        ja, jc, jnp.asarray(x[:, :S]),
                                        jnp.asarray(pos))
    tout, tckv, tkr = tattn.mla_prefill(tcache["ckv"][0], tcache["krope"][0],
                                        ta, tcfg, torch.from_numpy(x[:, :S]),
                                        torch.from_numpy(pos.copy()))
    assert tckv.data_ptr() == tcache["ckv"][0].data_ptr()   # in place
    _close(tout, jout)
    _close(tckv, jckv)
    _close(tkr, jkr)
    for i in range(3):
        idx = S + i
        jout, jckv, jkr = jattn.mla_decode_step(
            jckv, jkr, jnp.asarray(idx, jnp.int32), ja, jc,
            jnp.asarray(x[:, idx:idx + 1]))
        tout, tckv, tkr = tattn.mla_decode_step(
            tckv, tkr, torch.tensor(idx, dtype=torch.int32), ta, tcfg,
            torch.from_numpy(x[:, idx:idx + 1]))
        _close(tout, jout)
        _close(tckv, jckv)
        _close(tkr, jkr)


# ------------------------------------------------------- forward / cache
@pytest.mark.parametrize("arch", MOE_IDS)
def test_forward_matches_jax(arch):
    tcfg, jp, tp = _params(arch)
    toks = _tokens(0, 2, 12, tcfg.vocab)
    jl, jaux = jmoe.forward(jp, _jcfg(tcfg), jnp.asarray(toks))
    tl, taux = tregistry.get_api(tcfg).forward(tp, tcfg,
                                               torch.from_numpy(toks))
    _close(tl, jl)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    emb = np.random.RandomState(2).randn(2, 3, tcfg.d_model).astype(
        np.float32) * 0.02
    jl, _ = jmoe.forward(jp, _jcfg(tcfg), jnp.asarray(toks),
                         embeds=jnp.asarray(emb))
    tl, _ = tmoe.forward(tp, tcfg, torch.from_numpy(toks),
                         embeds=torch.from_numpy(emb))
    assert tuple(tl.shape) == (2, 15, tcfg.vocab)
    _close(tl, jl)


@pytest.mark.parametrize("arch", MOE_IDS)
@pytest.mark.parametrize("M", [16, 10])
def test_prefill_and_decode_match_jax_and_forward(arch, M):
    tcfg, jp, tp = _params(arch)
    jc = _jcfg(tcfg)
    B, P, N = 3, 6, 4
    toks = _tokens(3, B, P + N, tcfg.vocab)
    jcache = jmoe.init_cache(jc, B, M)
    tcache = tmoe.init_cache(tcfg, B, M, device="cpu")
    names = ("ckv", "krope") if tcfg.use_mla else ("k", "v")
    assert set(tcache) == set(jcache) == set(names) | {"idx"}
    ptrs = [tcache[n].data_ptr() for n in names]
    jl, jcache = jmoe.prefill(jp, jc, jnp.asarray(toks[:, :P]), jcache)
    tl, tcache = tmoe.prefill(tp, tcfg, torch.from_numpy(toks[:, :P]),
                              tcache)
    _close(tl, jl)
    full, _ = tmoe.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tl, full[:, P - 1])
    for s in range(P, P + N):
        jl, jcache = jmoe.decode_step(jp, jc, jnp.asarray(toks[:, s:s + 1]),
                                      jcache)
        tl, tcache = tmoe.decode_step(tp, tcfg,
                                      torch.from_numpy(toks[:, s:s + 1]),
                                      tcache)
        _close(tl, jl)
        _close(tl, full[:, s])
        assert int(tcache["idx"]) == int(jcache["idx"]) == s + 1
    for n in names:
        _close(tcache[n], jcache[n])
    assert [tcache[n].data_ptr() for n in names] == ptrs


def test_mla_cache_is_smaller_than_gqa():
    """The latent cache holds kv_lora + rope values per token and layer,
    against 2 * H * head_dim for the GQA cache it replaces."""
    cfg = configs.DEEPSEEK_V2_236B
    c = tmoe.init_cache(dataclasses.replace(cfg, n_layers=1), 1, 4,
                        device="meta")
    per_tok = sum(c[n].numel() for n in ("ckv", "krope")) // 4
    assert per_tok == cfg.kv_lora + cfg.qk_rope_dim == 576
    gqa = 2 * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    assert per_tok / gqa < 0.03


# ---------------------------------------------------------------- interop
@pytest.mark.parametrize("arch", MOE_IDS)
def test_interop_round_trip(arch):
    tcfg, jp, tp = _params(arch)
    tree = jax.tree.map(np.asarray, jp)
    back = interop.lm_params_to_jax(interop.lm_params_from_jax(tree, tcfg),
                                    tcfg)
    la, ta = jax.tree_util.tree_flatten(tree)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb and all(np.array_equal(a, b) for a, b in zip(la, lb))
    with pytest.raises(KeyError, match="layer0"):
        interop.lm_params_from_jax(
            {k: v for k, v in tree.items() if k != "layer0"}, tcfg)
