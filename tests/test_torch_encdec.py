"""The audio family (``models/encdec.py``: seamless-m4t-large-v2's
encoder-decoder backbone over stub frame embeddings), cross-attention
(``attention.gqa_cross_forward``), ``common.layer_norm``, the config, the
registry entry and the CLIs, against the JAX package on the CPU at the
smoke config.

Tolerances: ``gqa_cross_forward`` and ``encode`` 1e-5 of max|.| of
JAX's; ``layer_norm`` 1e-6 of max|.| in float32 (a mean and a variance
summed in another order) and 1 bfloat16 ulp of the value in bfloat16;
the rest as ``tests/_torch_lm.py`` states them.
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
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import registry as jregistry
from repro.training import checkpoint as jckpt
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import dense as tdense
from repro_torch.models import encdec as tencdec
from repro_torch.models import registry as tregistry

import _torch_lm as lm

ARCH = "seamless-m4t-large-v2"
LN_TOL = 1e-6


def test_config_field_for_field():
    for get in ("get", "get_smoke"):
        t, j = getattr(configs, get)(ARCH), getattr(jconfigs, get)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 7, 96) * 3 + 1).astype(np.float32)
    scale = rs.randn(96).astype(np.float32)
    bias = rs.randn(96).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jcommon.layer_norm(jnp.asarray(x).astype(jd),
                              jnp.asarray(scale).astype(jd),
                              jnp.asarray(bias).astype(jd))
    got = tcommon.layer_norm(torch.from_numpy(x).to(td),
                             torch.from_numpy(scale).to(td),
                             torch.from_numpy(bias).to(td))
    assert got.dtype == td
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    if dtype == "float32":
        lm.close(g, w, LN_TOL)
    else:
        ulp = np.abs(w) * 2.0 ** -7 + 1e-30
        assert (np.abs(g - w) <= ulp * 1.0001).all()
    # statistics in float32: the normalised rows have mean 0, variance 1
    z = tcommon.layer_norm(torch.from_numpy(x), torch.ones(96),
                           torch.zeros(96))
    assert float(z.mean(-1).abs().max()) < 1e-5
    assert float((z.var(-1, correction=0) - 1).abs().max()) < 1e-4


def test_gqa_cross_forward_matches_jax():
    jcfg, tcfg, jp, tp = lm.pair(ARCH)
    jl = jax.tree.map(lambda a: a[1], jp["dec_layers"])["cross_attn"]
    tl = tdense.layer_params(tp["dec_layers"], 1)["cross_attn"]
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, tcfg.d_model).astype(np.float32)
    src = rs.randn(2, 13, tcfg.d_model).astype(np.float32)
    want = jattn.gqa_cross_forward(jl, jcfg, jnp.asarray(x), jnp.asarray(src))
    got = tattn.gqa_cross_forward(tl, tcfg, torch.from_numpy(x),
                                  torch.from_numpy(src))
    lm.close(got, want)
    # GQA grouping: a 2-kv-head config reads head h from kv head h // 2
    cfg2 = dataclasses.replace(tcfg, n_kv_heads=2)
    jcfg2 = dataclasses.replace(jcfg, n_kv_heads=2)
    hd = tcfg.hd()
    tl2 = {**tl, "wk": tl["wk"][:, :2 * hd], "wv": tl["wv"][:, :2 * hd]}
    jl2 = {**jl, "wk": jl["wk"][:, :2 * hd], "wv": jl["wv"][:, :2 * hd]}
    lm.close(tattn.gqa_cross_forward(tl2, cfg2, torch.from_numpy(x),
                                     torch.from_numpy(src)),
             jattn.gqa_cross_forward(jl2, jcfg2, jnp.asarray(x),
                                     jnp.asarray(src)))


def test_encode_matches_jax():
    jcfg, tcfg, jp, tp = lm.pair(ARCH)
    emb = lm.frames(tcfg, 2)
    lm.close(tencdec.encode(tp, tcfg, torch.from_numpy(emb)),
             jencdec.encode(jp, jcfg, jnp.asarray(emb)))


def test_forward_matches_jax():
    lm.check_forward(ARCH)


def test_prefill_and_decode_match_jax_in_place():
    lm.check_prefill_decode(ARCH)


@pytest.mark.parametrize("seed", [0, 5])
def test_init_is_jax(seed):
    assert lm.check_init(ARCH, seed) == 0


def test_registry_needs_frames():
    tcfg = configs.get_smoke(ARCH)
    api = tregistry.get_api(tcfg)
    assert api.needs_embeds and jregistry.get_api(
        jconfigs.get_smoke(ARCH)).needs_embeds
    c = api.init_cache(tcfg, 2, 9, device="cpu")
    assert c["xk"].shape == (2, 2, tcfg.n_ctx_embeds, 4, 32)
    with pytest.raises(AssertionError, match="frame embeddings"):
        api.forward(None, tcfg, torch.zeros((1, 2), dtype=torch.int32))


def test_argenerator_greedy_tokens_match_jax():
    lm.check_argenerator(ARCH)


def test_serve_cli_ckpt_from_jax_gives_jax_tokens(tmp_path):
    """--ckpt with a JAX init's {"params": ...} file: the CLI's greedy
    tokens over JAX's stub frames are the JAX ARGenerator's, and the cache
    is prompt + new tokens long (frames go to the encoder, not the
    cache)."""
    from repro.serving import ARGenerator as JGen
    from repro.serving import GenRequest as JReq
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jencdec.init_params(jax.random.PRNGKey(4), jcfg)
    path = str(tmp_path / "lm.npz")
    jckpt.save(path, {"params": jp}, step=1)
    out = lm.run_cli(serve.main, ["--arch", ARCH, "--smoke", "--ckpt", path,
                                  "--seed", "2", "--batch", "2",
                                  "--prompt-len", "8", "--new-tokens", "5",
                                  "--device", "cpu"])
    got = [[int(x) for x in line.split("[")[1].split("]")[0].split()]
           for line in out if line.startswith("req")]
    rng = np.random.RandomState(2)
    reqs = [JReq(prompt=rng.randint(0, jcfg.vocab, 8).astype(np.int32),
                 max_new_tokens=5) for _ in range(2)]
    emb = jax.random.normal(jax.random.PRNGKey(9),
                            (2, jcfg.n_ctx_embeds, jcfg.d_model)) * 0.02
    want = JGen(jcfg, jp, batch_size=2, max_len=13).generate(reqs,
                                                             embeds=emb)
    assert got == [np.asarray(r.tokens).tolist() for r in want]


def test_train_cli_smoke():
    out = lm.run_cli(train.main, ["--arch", ARCH, "--smoke", "--steps", "1",
                                  "--batch", "2", "--seq", "16", "--device",
                                  "cpu"])
    assert out[0].startswith(f"{ARCH}-smoke: ")
    assert np.isfinite(float(out[-1].split(":")[-1].strip(" }")))
