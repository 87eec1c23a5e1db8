"""The port's autoregressive server (``repro_torch.serving.ARGenerator``)
against the JAX package's, on the CPU at smoke sizes, over the same
weights (``interop.lm_params_from_jax``), prompts and ``rng_seed``s.

The two packages' logits agree to 1e-5 of max|logits| (float32 products
summed in another order), so a token can differ only where the choice is
a near tie.  Each row is compared up to its first differing token (after
that the sequences diverge); at that step the test replays JAX's loop and
asserts that JAX's own top-2 gap was under 10x the tolerance: of the
logits for a greedy row, of gumbel + scaled logits (plus the 4-ulp Gumbel
tolerance of ``test_torch_prng.py``) for a sampled one.  The near ties
found are counted in the assertion messages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro.models import dense as jdense
from repro.models.common import ArchConfig as JArch
from repro.serving import ARGenerator as JGen
from repro.serving import GenRequest as JReq
from repro_torch import configs, interop, prng
from repro_torch.serving import ARGenerator, GenRequest, GenResult

TOL_OF_SCALE = 1e-5
NEAR_TIE = 10 * TOL_OF_SCALE
GUMBEL_ULPS = 4
RING = dataclasses.replace(configs.LLAMA3_2_3B_SMOKE, name="ring-smoke",
                           sliding_window=8)

# (temperature, top_k, rng_seed, prompt length, max_new_tokens)
ROWS = [(0.0, 0, 0, 6, 12), (0.0, 0, 5, 4, 8), (0.8, 50, 11, 6, 12),
        (1.0, 0, 2 ** 31 - 1, 5, 10)]


def _jcfg(tcfg):
    return JArch(**dataclasses.asdict(tcfg))


@functools.lru_cache(maxsize=None)
def _params(tcfg):
    jp = jdense.init_params(jax.random.PRNGKey(1), _jcfg(tcfg))
    return jp, interop.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                             tcfg)


def _requests(tcfg, rows, cls):
    rs = np.random.RandomState(3)
    return [cls(prompt=rs.randint(0, tcfg.vocab, plen).astype(np.int32),
                max_new_tokens=n, temperature=t, top_k=k, rng_seed=seed)
            for t, k, seed, plen, n in rows]


def _jax_trace(gen, reqs):
    """JAX's generate loop (repro/serving/engine.py:104-151) replayed step
    by step: per step the logits sampled from, the per-row sub-keys and
    the tokens, all rows (pads included)."""
    prompt_len = max(len(r.prompt) for r in reqs)
    toks = np.zeros((gen.batch, prompt_len), np.int32)
    for i, r in enumerate(reqs):
        toks[i, prompt_len - len(r.prompt):] = r.prompt
    cache = gen.api.init_cache(gen.cfg, gen.batch, gen.max_len, gen.dtype)
    logits, cache = gen._prefill(params=gen.params, tokens=jnp.asarray(toks),
                                 cache=cache)
    pad = gen.batch - len(reqs)
    temps = jnp.asarray([r.temperature for r in reqs] + [0.0] * pad,
                        jnp.float32)
    top_ks = jnp.asarray([r.top_k for r in reqs] + [0] * pad, jnp.int32)
    max_k = max(r.top_k for r in reqs)
    rngs = jnp.stack([jax.random.PRNGKey(r.rng_seed) for r in reqs]
                     + [jax.random.PRNGKey(0)] * pad)
    trace = []
    for _ in range(max(r.max_new_tokens for r in reqs)):
        split = jax.vmap(functools.partial(jax.random.split, num=2))(rngs)
        rngs, subs = split[:, 0], split[:, 1]
        nxt = gen._sample(logits, temps, top_ks, subs, max_k=max_k)
        trace.append((np.asarray(logits), np.asarray(subs), np.asarray(nxt)))
        logits, cache = gen._decode(params=gen.params,
                                    tokens=nxt[:, None].astype(jnp.int32),
                                    cache=cache)
    return trace, max_k


def _jax_gap(logits, sub, req, max_k):
    """JAX's top-2 gap at one row and step, and the tolerance of scale
    that a near tie is held to."""
    if req.temperature <= 0.0:
        top2 = np.sort(logits)[-2:]
        return top2[1] - top2[0], NEAR_TIE * np.abs(logits).max()
    scaled = logits / max(req.temperature, 1e-6)
    if req.top_k > 0:
        kth = np.sort(scaled)[::-1][:max_k][min(req.top_k, max_k) - 1]
        scaled = np.where(scaled < kth, -np.inf, scaled)
    g = np.asarray(jax.random.gumbel(jnp.asarray(sub), logits.shape))
    z = np.sort(g + scaled)[-2:]
    tol = (NEAR_TIE * np.abs(scaled[np.isfinite(scaled)]).max()
           + GUMBEL_ULPS * np.spacing(np.float32(max(np.abs(g).max(), 1.0))))
    return z[1] - z[0], tol


def _first_divergence(got, want):
    n = min(len(got), len(want))
    diff = np.nonzero(np.asarray(got[:n]) != np.asarray(want[:n]))[0]
    return int(diff[0]) if len(diff) else None


@pytest.mark.parametrize("tcfg,batch", [(configs.SMOLLM_135M_SMOKE, 4),
                                        (configs.LLAMA3_2_3B_SMOKE, 5),
                                        (RING, 4)],
                         ids=["smollm-smoke", "llama-smoke-padded", "ring"])
def test_generate_tokens_match_jax(tcfg, batch):
    """Greedy and sampled rows equal JAX's tokens, up to near ties."""
    jp, tp = _params(tcfg)
    max_len = 6 + 12
    jgen = JGen(_jcfg(tcfg), jp, batch_size=batch, max_len=max_len)
    tgen = ARGenerator(tcfg, tp, batch_size=batch, max_len=max_len,
                       device="cpu")
    jreqs, treqs = _requests(tcfg, ROWS, JReq), _requests(tcfg, ROWS,
                                                          GenRequest)
    jres = jgen.generate(jreqs)
    tres = tgen.generate(treqs)
    trace, max_k = _jax_trace(jgen, jreqs)
    ties = []
    for i, (jr, tr, req) in enumerate(zip(jres, tres, jreqs)):
        assert isinstance(tr, GenResult) and tr.tokens.dtype == np.int32
        assert len(tr.tokens) == len(jr.tokens) == req.max_new_tokens
        # the replay is JAX's generate
        assert np.array_equal([s[2][i] for s in trace[:len(jr.tokens)]],
                              jr.tokens)
        step = _first_divergence(tr.tokens, jr.tokens)
        if step is None:
            continue
        logits, subs, _ = trace[step]
        gap, tol = _jax_gap(logits[i], subs[i], req, max_k)
        ties.append((i, step, float(gap), float(tol)))
        assert gap <= tol, f"row {i} differs at step {step}: {ties}"


def test_sample_tokens_matches_jax():
    """The vectorized sampler on the same logits and keys: greedy rows
    bitwise, sampled rows (temperature, top-k) equal except near ties."""
    rs = np.random.RandomState(0)
    logits = (rs.randn(6, 512) * 3).astype(np.float32)
    temps = np.array([0.0, 0.5, 1.0, 0.8, 2.0, 0.0], np.float32)
    top_ks = np.array([0, 5, 0, 50, 1, 3], np.int32)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in (0, 1, 2, 3, 4, 5)])
    want = np.asarray(JGen._sample_tokens(jnp.asarray(logits),
                                          jnp.asarray(temps),
                                          jnp.asarray(top_ks), keys, 50))
    got = ARGenerator._sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks.astype(np.int64)),
        torch.from_numpy(np.asarray(keys).astype(np.int64)), 50).numpy()
    assert np.array_equal(got[temps <= 0], want[temps <= 0])
    for i in np.nonzero(got != want)[0]:
        req = JReq(prompt=np.zeros(1, np.int32), temperature=float(temps[i]),
                   top_k=int(top_ks[i]))
        gap, tol = _jax_gap(logits[i], np.asarray(keys[i]), req, 50)
        assert gap <= tol, (i, gap, tol)
    # top_k == 1 is greedy on the scaled logits
    assert got[4] == logits[4].argmax()
    # top_k == 5 keeps the sample among the 5 largest logits
    assert got[1] in np.argsort(logits[1])[-5:]


def test_sample_tokens_keys_split_per_step():
    """The per-row key walk: each step splits every row's key and samples
    with the second half, as JAX's loop does (bitwise keys)."""
    seeds = [0, 7, 2 ** 31 - 1]
    t = torch.stack([prng.PRNGKey(s, "cpu") for s in seeds])
    j = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    for _ in range(4):
        s = prng.split(t, 2)
        t, tsub = s[:, 0], s[:, 1]
        js = jax.vmap(functools.partial(jax.random.split, num=2))(j)
        j, jsub = js[:, 0], js[:, 1]
        assert np.array_equal(tsub.numpy(), np.asarray(jsub).astype(np.int64))
    assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_generate_result_fields_and_no_new_cache():
    tcfg = configs.SMOLLM_135M_SMOKE
    _, tp = _params(tcfg)
    gen = ARGenerator(tcfg, tp, batch_size=3, max_len=12, device="cpu")
    reqs = [GenRequest(prompt=np.array([1, 2, 3], np.int32),
                       max_new_tokens=5),
            GenRequest(prompt=np.array([4], np.int32), max_new_tokens=2,
                       temperature=0.7, rng_seed=3)]
    ptrs = []
    decode = gen.api.decode_step

    def spy(params, cfg, tokens, cache):
        ptrs.append((cache["k"].data_ptr(), cache["v"].data_ptr()))
        assert tokens.shape == (3, 1)
        return decode(params, cfg, tokens, cache)

    gen.api = dataclasses.replace(gen.api, decode_step=spy)
    res = gen.generate(reqs)
    assert [len(r.tokens) for r in res] == [5, 2]
    assert all(0 <= t < tcfg.vocab for r in res for t in r.tokens)
    assert len(ptrs) == 5 and len(set(ptrs)) == 1
    r = res[0]
    assert r.prefill_ms > 0 and r.decode_ms > 0
    assert r.tokens_per_s == pytest.approx(5 * 2 / (r.decode_ms / 1e3),
                                           rel=1e-6)
    # same requests, same tokens: the generator holds no state between runs
    again = gen.generate(reqs)
    assert all(np.array_equal(a.tokens, b.tokens) for a, b in zip(res, again))


def test_argenerator_refusals(monkeypatch):
    tcfg = configs.SMOLLM_135M_SMOKE
    _, tp = _params(tcfg)
    with pytest.raises(ValueError, match="in place"):
        ARGenerator(tcfg, tp, 2, 8, donate=False, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        ARGenerator(dataclasses.replace(tcfg, family="rnn"), tp, 2, 8,
                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ARGenerator(tcfg, tp, 2, 8)
