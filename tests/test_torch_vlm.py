"""The VLM family (``models/vlm.py``: the dense backbone over a prefix of
stub image embeddings) and the serving of the new families through
``ARGenerator`` and ``launch.serve``, against the JAX package on the CPU
at smoke sizes.

Tolerances: logits and caches within 1e-5 of max|.| of JAX's (float32
products sum in another order); greedy tokens equal JAX's (the smoke
models at these seeds meet no near tie); the stub embeddings bitwise
JAX's ``normal(PRNGKey(9), ...) * 0.02``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models import vlm as jvlm
from repro.serving import ARGenerator as JGen
from repro.serving import GenRequest as JReq
from repro_torch import configs, interop
from repro_torch.launch import serve
from repro_torch.models import dense as tdense
from repro_torch.models import registry as tregistry
from repro_torch.models import vlm as tvlm
from repro_torch.serving import ARGenerator, GenRequest

TOL_OF_SCALE = 1e-5
VLM = "llava-next-mistral-7b"
TOKENS = re.compile(r"^req(\d+): \[([\d\s]+)\]\.\.\.$", re.M)


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_OF_SCALE * np.abs(want).max()


@pytest.fixture(scope="module")
def vlm_pair():
    jcfg, tcfg = jconfigs.get_smoke(VLM), configs.get_smoke(VLM)
    jp = jvlm.init_params(jax.random.PRNGKey(1), jcfg)
    tp = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    emb = np.random.RandomState(0).randn(2, tcfg.n_ctx_embeds,
                                         tcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, tp, emb * 0.02


def test_forward_with_embeds_matches_jax(vlm_pair):
    jcfg, tcfg, jp, tp, emb = vlm_pair
    toks = np.random.RandomState(1).randint(0, tcfg.vocab, (2, 8)).astype(
        np.int32)
    want = jvlm.forward(jp, jcfg, jnp.asarray(toks), embeds=jnp.asarray(emb))
    got, aux = tregistry.get_api(tcfg).forward(
        tp, tcfg, torch.from_numpy(toks), embeds=torch.from_numpy(emb))
    assert tuple(got.shape) == (2, tcfg.n_ctx_embeds + 8, tcfg.vocab)
    assert float(aux) == 0.0
    _close(got, want)
    # the vlm is the dense backbone with a prefix
    assert torch.equal(got, tdense.forward(tp, tcfg, torch.from_numpy(toks),
                                           embeds=torch.from_numpy(emb)))


def test_prefill_and_decode_with_embeds_match_jax(vlm_pair):
    jcfg, tcfg, jp, tp, emb = vlm_pair
    P, N = 6, 3
    M = tcfg.n_ctx_embeds + P + N
    toks = np.random.RandomState(2).randint(0, tcfg.vocab,
                                            (2, P + N)).astype(np.int32)
    jc = jvlm.init_cache(jcfg, 2, M)
    tc = tvlm.init_cache(tcfg, 2, M, device="cpu")
    jl, jc = jvlm.prefill(jp, jcfg, jnp.asarray(toks[:, :P]), jc,
                          embeds=jnp.asarray(emb))
    tl, tc = tvlm.prefill(tp, tcfg, torch.from_numpy(toks[:, :P]), tc,
                          embeds=torch.from_numpy(emb))
    _close(tl, jl)
    assert int(tc["idx"]) == tcfg.n_ctx_embeds + P
    full = tvlm.forward(tp, tcfg, torch.from_numpy(toks),
                        embeds=torch.from_numpy(emb))
    for s in range(P, P + N):
        jl, jc = jvlm.decode_step(jp, jcfg, jnp.asarray(toks[:, s:s + 1]),
                                  jc)
        tl, tc = tvlm.decode_step(tp, tcfg, torch.from_numpy(toks[:, s:s + 1]),
                                  tc)
        _close(tl, jl)
        _close(tl, full[:, tcfg.n_ctx_embeds + s].numpy())
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_stub_embeds_are_jax_draws():
    cfg = configs.get_smoke(VLM)
    got = tvlm.stub_embeds(cfg, 3, "cpu")
    want = np.asarray(jax.random.normal(
        jax.random.PRNGKey(9), (3, cfg.n_ctx_embeds, cfg.d_model)) * 0.02)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tvlm.stub_embeds(configs.get_smoke("deepseek-v2-236b"), 3,
                            "cpu") is None


@pytest.mark.parametrize("arch", [VLM, "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b"])
def test_argenerator_greedy_tokens_match_jax(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jregistry.get_api(jcfg).init_params(jax.random.PRNGKey(3), jcfg)
    tp = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, tcfg.vocab, n).astype(np.int32)
               for n in (5, 7, 7)]
    extra = tcfg.n_ctx_embeds
    emb = tvlm.stub_embeds(tcfg, 3, "cpu")
    jgen = JGen(jcfg, jp, batch_size=3, max_len=extra + 7 + 6)
    tgen = ARGenerator(tcfg, tp, batch_size=3, max_len=extra + 7 + 6,
                       device="cpu")
    jres = jgen.generate([JReq(prompt=p, max_new_tokens=6) for p in prompts],
                         embeds=None if emb is None else jnp.asarray(
                             emb.numpy()))
    tres = tgen.generate([GenRequest(prompt=p, max_new_tokens=6)
                          for p in prompts], embeds=emb)
    assert [r.tokens.tolist() for r in tres] == \
        [r.tokens.tolist() for r in jres]


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b", VLM])
def test_serve_cli_seed_gives_jax_weights(arch, capsys):
    """--seed s: the weights are JAX's init of PRNGKey(s), so the greedy
    tokens are the JAX ARGenerator's over that init (a vlm with JAX's stub
    embeddings and the cache grown by n_ctx_embeds)."""
    serve.main(["--arch", arch, "--smoke", "--seed", "2", "--batch", "2",
                "--new-tokens", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "not JAX" not in out
    got = [[int(x) for x in t.split()] for _, t in TOKENS.findall(out)]
    jcfg = jconfigs.get_smoke(arch)
    jp = jregistry.get_api(jcfg).init_params(jax.random.PRNGKey(2), jcfg)
    rng = np.random.RandomState(2)
    reqs = [JReq(prompt=rng.randint(0, jcfg.vocab, 16).astype(np.int32),
                 max_new_tokens=5) for _ in range(2)]
    embeds = None
    extra = 0
    if jcfg.family == "vlm":
        extra = jcfg.n_ctx_embeds
        embeds = jax.random.normal(jax.random.PRNGKey(9),
                                   (2, extra, jcfg.d_model)) * 0.02
    want = JGen(jcfg, jp, batch_size=2, max_len=16 + 5 + extra).generate(
        reqs, embeds=embeds)
    assert got == [r.tokens.tolist() for r in want]
