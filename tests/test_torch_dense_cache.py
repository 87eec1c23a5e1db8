"""The dense family's KV-cache path in the port (``models.dense``,
``models.attention``, ``models.runtime_flags``, ``models.registry``,
``configs``, ``interop``) against the JAX package, on the CPU at smoke
sizes, with the JAX weights carried over by
``interop.lm_params_from_jax``.

Tolerance: 1e-5 of max|.| for logits, KV caches and attention outputs
(float32; the products sum in another order).  ``idx`` and every integer
are exact, and the port's decode step equals its per-layer
``gqa_decode_step`` composition bitwise (the same arithmetic in the same
order).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import dense as jdense
from repro.models import registry as jregistry
from repro.models import runtime_flags as jflags
from repro.models.common import ArchConfig as JArch
from repro_torch import configs, interop, prng
from repro_torch.models import attention as tattn
from repro_torch.models import dense as tdense
from repro_torch.models import registry as tregistry
from repro_torch.models.common import ArchConfig, rms_norm
from repro_torch.models.runtime_flags import FLAGS, perf_flags

TOL_OF_SCALE = 1e-5
DENSE_IDS = ["smollm-135m", "llama3.2-3b", "deepseek-7b",
             "mistral-large-123b"]
# a ring-buffer config: llama3.2-3b's smoke widths, sliding window 8
RING = dataclasses.replace(configs.LLAMA3_2_3B_SMOKE, name="ring-smoke",
                           sliding_window=8)


def _jcfg(tcfg: ArchConfig):
    """The JAX ArchConfig with the port config's fields."""
    return JArch(**dataclasses.asdict(tcfg))


_PARAMS = {}


def _params(tcfg: ArchConfig):
    """(JAX params, port params) of the JAX init at seed 0."""
    if tcfg not in _PARAMS:
        jp = jdense.init_params(jax.random.PRNGKey(0), _jcfg(tcfg))
        tp = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg)
        _PARAMS[tcfg] = (jp, tp)
    return _PARAMS[tcfg]


@contextlib.contextmanager
def _jax_attn_chunk(chunk):
    """Set JAX's attn_chunk for a block and restore it on the same object.
    JAX's own ``perf_flags`` rebinds its module's FLAGS on exit and leaves
    the old object, which other modules imported by name, still set."""
    flags = jflags.FLAGS
    old = flags.attn_chunk
    flags.attn_chunk = chunk
    try:
        yield flags
    finally:
        flags.attn_chunk = old


def _close(got, want, tol=TOL_OF_SCALE):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _tokens(B, S, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def _cache_close(tc, jc):
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["idx"].dtype == torch.int32 and tc["idx"].dim() == 0
    assert int(tc["idx"]) == int(jc["idx"])


# ----------------------------------------------------------- prefill/decode
CASES = [(configs.SMOLLM_135M_SMOKE, 6, 8), (configs.LLAMA3_2_3B_SMOKE, 6, 8),
         (configs.DEEPSEEK_7B_SMOKE, 5, 8), (RING, 6, 10)]


@pytest.mark.parametrize("tcfg,S,n_new", CASES,
                         ids=[c[0].name for c in CASES])
def test_prefill_then_teacher_forced_decode_matches_jax(tcfg, S, n_new):
    """After prefill and after every decode step: logits, the KV cache and
    idx.  JAX's greedy tokens feed both packages (teacher forcing)."""
    jcfg = _jcfg(tcfg)
    jp, tp = _params(tcfg)
    B, max_len = 2, S + n_new
    toks = _tokens(B, S, tcfg.vocab, 1)
    jc = jdense.init_cache(jcfg, B, max_len)
    tc = tdense.init_cache(tcfg, B, max_len, device="cpu")
    jl, jc = jdense.prefill(jp, jcfg, jnp.asarray(toks), jc)
    tl, tc2 = tdense.prefill(tp, tcfg, torch.from_numpy(toks), tc)
    assert tc2 is tc                          # updated in place
    _close(tl, jl)
    _cache_close(tc, jc)
    k_ptr = tc["k"].data_ptr()
    for _ in range(n_new):
        nxt = np.asarray(jl.argmax(-1)).astype(np.int32)[:, None]
        jl, jc = jdense.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = tdense.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        _close(tl, jl)
        _cache_close(tc, jc)
        assert tc["k"].data_ptr() == k_ptr
    if tcfg.sliding_window:
        assert tc["k"].shape[2] == tcfg.sliding_window < S + n_new


def _decode_per_layer(tp, tcfg, tokens, cache):
    """JAX's decode_step structure: each layer calls gqa_decode_step, which
    builds the step's tables itself."""
    h = tp["embed"][tokens]
    for i in range(tcfg.n_layers):
        layer = tdense.layer_params(tp["layers"], i)
        out, _, _ = tattn.gqa_decode_step(
            cache["k"][i], cache["v"][i], cache["idx"], layer["attn"], tcfg,
            rms_norm(h, layer["attn_norm"], tcfg.norm_eps))
        h = tdense._mlp(layer, tcfg, h + out)
    cache["idx"].add_(1)
    return tdense._logits(tp, tcfg, h)[:, 0], cache


@pytest.mark.parametrize("tcfg", [configs.LLAMA3_2_3B_SMOKE, RING],
                         ids=["llama-smoke", "ring"])
def test_decode_inplace_variant(tcfg):
    """JAX's two decode variants against the port's one body: the port's
    decode_step_inplace is decode_step, which equals the per-layer
    gqa_decode_step composition bitwise (the tables are only hoisted) and
    matches both JAX variants; decode_inplace is not a port flag."""
    assert tdense.decode_step_inplace is tdense.decode_step
    with pytest.raises(AttributeError, match="decode_inplace"):
        with perf_flags(decode_inplace=True):
            pass
    jcfg = _jcfg(tcfg)
    jp, tp = _params(tcfg)
    B, S, n_new = 2, 6, 9
    toks = _tokens(B, S, tcfg.vocab, 2)
    new = _tokens(B, n_new, tcfg.vocab, 3)
    caches = []
    for step in (tdense.decode_step, _decode_per_layer):
        tc = tdense.init_cache(tcfg, B, S + n_new, device="cpu")
        tdense.prefill(tp, tcfg, torch.from_numpy(toks), tc)
        logits = []
        for j in range(n_new):
            tl, tc = step(tp, tcfg, torch.from_numpy(new[:, j:j + 1]), tc)
            logits.append(tl)
        caches.append((torch.stack(logits), tc))
    (l0, c0), (l1, c1) = caches
    assert torch.equal(l0, l1)
    assert torch.equal(c0["k"], c1["k"]) and torch.equal(c0["v"], c1["v"])
    for jstep in (jdense.decode_step, jdense.decode_step_inplace):
        jc = jdense.init_cache(jcfg, B, S + n_new)
        _, jc = jdense.prefill(jp, jcfg, jnp.asarray(toks), jc)
        for j in range(n_new):
            jl, jc = jstep(jp, jcfg, jnp.asarray(new[:, j:j + 1]), jc)
            _close(l0[j], jl)
        _cache_close(c0, jc)


def test_prefill_longer_than_the_ring_keeps_the_last_rows():
    """S >= M: the cache holds the prompt's last M rows, as in JAX."""
    tcfg = RING
    jcfg = _jcfg(tcfg)
    jp, tp = _params(tcfg)
    toks = _tokens(2, 12, tcfg.vocab, 4)
    jl, jc = jdense.prefill(jp, jcfg, jnp.asarray(toks),
                            jdense.init_cache(jcfg, 2, 16))
    tc = tdense.init_cache(tcfg, 2, 16, device="cpu")
    tl, tc = tdense.prefill(tp, tcfg, torch.from_numpy(toks), tc)
    assert tc["k"].shape[2] == 8
    _close(tl, jl)
    _cache_close(tc, jc)
    nxt = np.array([[3], [5]], np.int32)
    jl, jc = jdense.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
    tl, tc = tdense.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
    _close(tl, jl)
    _cache_close(tc, jc)


def test_prefill_with_embeds():
    tcfg = configs.SMOLLM_135M_SMOKE
    jcfg = _jcfg(tcfg)
    jp, tp = _params(tcfg)
    toks = _tokens(2, 5, tcfg.vocab, 5)
    emb = (np.random.RandomState(6).randn(2, 3, tcfg.d_model) * 0.02
           ).astype(np.float32)
    jl, jc = jdense.prefill(jp, jcfg, jnp.asarray(toks),
                            jdense.init_cache(jcfg, 2, 12),
                            embeds=jnp.asarray(emb))
    tc = tdense.init_cache(tcfg, 2, 12, device="cpu")
    tl, tc = tdense.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                            embeds=torch.from_numpy(emb))
    _close(tl, jl)
    _cache_close(tc, jc)
    assert int(tc["idx"]) == 8


@pytest.mark.parametrize("tcfg", [configs.SMOLLM_135M_SMOKE, RING],
                         ids=["smollm-smoke", "ring"])
def test_forward_matches_jax_and_the_cache(tcfg):
    """The cache-free forward equals JAX's, and its last-position logits
    equal prefill's (same port, same weights)."""
    jcfg = _jcfg(tcfg)
    jp, tp = _params(tcfg)
    toks = _tokens(2, 12, tcfg.vocab, 7)
    tl = tdense.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jdense.forward(jp, jcfg, jnp.asarray(toks)))
    pl, _ = tdense.prefill(tp, tcfg, torch.from_numpy(toks),
                           tdense.init_cache(tcfg, 2, 16, device="cpu"))
    _close(pl, tl[:, -1].numpy())


# ------------------------------------------------------------- attention
def _qkv(B, Sq, Sk, H, Hkv, D, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("causal,window,chunks", [
    (True, 0, (4, 4)), (True, 5, (4, 8)), (False, 0, (8, 4)),
    (False, 6, (16, 16))], ids=["causal", "windowed", "full", "full-win"])
def test_chunked_grouped_attention_matches_jax(causal, window, chunks):
    q, k, v = _qkv(2, 16, 16, 6, 2, 32, 8)
    want = jattn.chunked_grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, *chunks,
        window=window)
    got = tattn.chunked_grouped_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, *chunks, window=window)
    _close(got, want)


@pytest.mark.parametrize("tcfg", [configs.LLAMA3_2_3B_SMOKE, RING],
                         ids=["causal", "windowed"])
def test_attn_chunk_branches_match_jax(tcfg):
    """gqa_forward and gqa_prefill under attn_chunk=4 (S=12) against JAX's
    chunked branches and the port's unchunked path."""
    jcfg = _jcfg(tcfg)
    jp, tp = _params(tcfg)
    rs = np.random.RandomState(9)
    x = rs.randn(2, 12, tcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32)[None], (2, 12))
    jl0 = jax.tree.map(lambda a: a[0], jp["layers"])
    tl0 = tdense.layer_params(tp["layers"], 0)
    plain = tattn.gqa_forward(tl0["attn"], tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()))
    jk = jnp.zeros((2, 16, tcfg.n_kv_heads, tcfg.hd()))
    tk = torch.zeros(2, 16, tcfg.n_kv_heads, tcfg.hd())
    tv = torch.zeros_like(tk)
    with _jax_attn_chunk(4), perf_flags(attn_chunk=4):
        want = jattn.gqa_forward(jl0["attn"], jcfg, jnp.asarray(x),
                                 jnp.asarray(pos))
        got = tattn.gqa_forward(tl0["attn"], tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
        jout, jnk, jnv = jattn.gqa_prefill(jk, jk, jl0["attn"], jcfg,
                                           jnp.asarray(x), jnp.asarray(pos))
        tout, _, _ = tattn.gqa_prefill(tk, tv, tl0["attn"], tcfg,
                                       torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()))
    assert FLAGS.attn_chunk == 0 and jflags.FLAGS.attn_chunk == 0
    _close(got, want)
    _close(got, plain.numpy())
    _close(tout, jout)
    _close(tk, jnk)
    _close(tv, jnv)


def test_ring_slot_positions_match_jax():
    for idx in (0, 1, 5, 8, 9, 23):
        want = np.asarray(jattn._ring_slot_positions(jnp.int32(idx), 8))
        got = tattn._ring_slot_positions(
            torch.tensor(idx, dtype=torch.int32), 8)
        assert got.tolist() == want.tolist()


def test_init_kv_cache_layout():
    for tcfg, M in ((configs.LLAMA3_2_3B_SMOKE, 20), (RING, 8)):
        jc = jattn.init_kv_cache(_jcfg(tcfg), 3, 20, 2, jnp.float32)
        tc = tattn.init_kv_cache(tcfg, 3, 20, 2, device="cpu")
        assert tuple(tc["k"].shape) == jc["k"].shape == (2, 3, M, 2, 32)
        assert tc["v"].shape == tc["k"].shape
        assert tc["idx"].shape == () and int(tc["idx"]) == 0


# ----------------------------------------------------- params and configs
@pytest.mark.parametrize("arch", DENSE_IDS)
def test_configs_field_for_field(arch):
    for get in ("get", "get_smoke"):
        t = getattr(configs, get)(arch)
        j = getattr(jconfigs, get)(arch)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.hd() == j.hd() and t.q_per_kv() == j.q_per_kv()


def test_config_tables_and_unported_ids():
    """Every JAX id resolves in the port, in JAX's order, to its family
    (none is left unported); an unknown id raises KeyError."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    for arch in configs.ARCH_IDS:
        for get in ("get", "get_smoke"):
            t, j = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert tregistry.get_api(t) is tregistry.FAMILIES[j.family]
    for get in (configs.get, configs.get_smoke):
        with pytest.raises(KeyError, match="unknown arch"):
            get("gpt-5")
    bad = dataclasses.replace(configs.SMOLLM_135M_SMOKE, n_kv_heads=2)
    with pytest.raises(ValueError, match="n_heads % n_kv_heads"):
        bad.validate()


@pytest.mark.parametrize("family,module", [
    ("ssm", "rwkv6"), ("hybrid", "hybrid"), ("audio", "encdec")])
def test_registry_refuses_unported_families(family, module):
    """The families that were refused are served: each ModelApi is its
    module's, with JAX's ``needs_embeds``."""
    cfg = dataclasses.replace(configs.SMOLLM_135M_SMOKE, family=family)
    api = tregistry.get_api(cfg)
    assert api.needs_embeds == jregistry.FAMILIES[family].needs_embeds
    assert api.decode_step.__module__ == f"repro_torch.models.{module}"
    assert api.init_params.__module__ == f"repro_torch.models.{module}"


def test_registry_dense_api():
    api = tregistry.get_api(configs.SMOLLM_135M_SMOKE)
    assert api is tregistry.FAMILIES["dense"]
    assert (api.init_cache, api.prefill, api.decode_step) == (
        tdense.init_cache, tdense.prefill, tdense.decode_step)
    assert set(tregistry.FAMILIES) == set(jregistry.FAMILIES)
    tcfg = configs.SMOLLM_135M_SMOKE
    _, tp = _params(tcfg)
    toks = torch.from_numpy(_tokens(1, 4, tcfg.vocab, 10))
    logits, aux = api.forward(tp, tcfg, toks)
    assert torch.equal(logits, tdense.forward(tp, tcfg, toks))
    assert aux.shape == () and float(aux) == 0.0
    with pytest.raises(ValueError, match="unknown family"):
        tregistry.get_api(dataclasses.replace(tcfg, family="nope"))


@pytest.mark.parametrize("tcfg", [configs.SMOLLM_135M_SMOKE,
                                  configs.MISTRAL_LARGE_123B_SMOKE],
                         ids=["tied", "unembed"])
def test_init_params_scheme_and_interop_round_trip(tcfg):
    """The port's seeded init has the JAX tree's keys and shapes and the
    JAX scheme's scales; interop carries a JAX tree there and back
    bitwise."""
    jcfg = _jcfg(tcfg)
    shapes = jax.eval_shape(lambda k: jdense.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    tp = tdense.init_params(prng.PRNGKey(0, "cpu"), tcfg, device="cpu")
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert interop.map_leaves(tp, lambda t: tuple(t.shape)) == want
    assert ("unembed" in tp) == (not tcfg.tie_embeddings)
    assert abs(float(tp["embed"].std()) - 0.02) < 0.002
    wq = tp["layers"]["attn"]["wq"]
    # a unit normal truncated at +-3 has std 0.9866
    assert abs(float(wq.std()) / (0.9866 * tcfg.d_model ** -0.5) - 1) < 0.05
    assert float(wq.abs().max()) <= 3 * tcfg.d_model ** -0.5 * (1 + 1e-6)
    assert torch.equal(tp["final_norm"], torch.ones(tcfg.d_model))
    jp, _ = _params(tcfg)
    tree = jax.tree.map(np.asarray, jp)
    back = interop.lm_params_to_jax(
        interop.lm_params_from_jax(tree, tcfg), tcfg)
    la, ta = jax.tree_util.tree_flatten(tree)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb and all(np.array_equal(a, b) for a, b in zip(la, lb))
    with pytest.raises(KeyError, match="final_norm"):
        interop.lm_params_from_jax(
            {k: v for k, v in tree.items() if k != "final_norm"}, tcfg)
    with pytest.raises(ValueError, match="embed"):
        interop.lm_params_from_jax(dict(tree, embed=np.zeros(3)), tcfg)


def test_init_params_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdense.init_params(prng.PRNGKey(0, "cpu"), configs.SMOLLM_135M_SMOKE)
