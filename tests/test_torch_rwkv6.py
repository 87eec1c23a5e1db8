"""The ssm family (``models/rwkv6.py``: RWKV6 "Finch" time / channel
mixing with the WKV recurrence), its config, registry entry,
diffusion-LM trunk and CLIs, against the JAX package on the CPU at the
smoke config.

Tolerances: ``time_mix`` / ``channel_mix`` outputs and states 1e-5 of
max|.| of JAX's (float32 products sum in another order); the rest as
``tests/_torch_lm.py`` states them (logits and caches 1e-5 of max|.|,
the cache path against the cache-free forward 1e-5 of max|logits|, drawn
init leaves bitwise, the diffusion-LM's x0 1e-4 of max|x0| and its loss
1e-5 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.models import rwkv6 as jrwkv
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import dense as tdense
from repro_torch.models import rwkv6 as trwkv

import _torch_lm as lm

ARCH = "rwkv6-7b"


def test_config_field_for_field():
    for get in ("get", "get_smoke"):
        t, j = getattr(configs, get)(ARCH), getattr(jconfigs, get)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    full = configs.get(ARCH)
    assert (trwkv.n_rwkv_heads(full), trwkv.head_size(full)) == (
        jrwkv.n_rwkv_heads(jconfigs.get(ARCH)), 64) == (64, 64)


def _layer(seed=0):
    jcfg, tcfg, jp, tp = lm.pair(ARCH, seed)
    return (jcfg, tcfg, jax.tree.map(lambda a: a[0], jp["layers"]),
            tdense.layer_params(tp["layers"], 0))


@pytest.mark.parametrize("S", [1, 9])
def test_time_mix_matches_jax(S):
    jcfg, tcfg, jl, tl = _layer()
    rs = np.random.RandomState(S)
    H, K = trwkv.n_rwkv_heads(tcfg), trwkv.head_size(tcfg)
    x = rs.randn(2, S, tcfg.d_model).astype(np.float32)
    last = rs.randn(2, tcfg.d_model).astype(np.float32)
    state = (rs.randn(2, H, K, K) * 0.1).astype(np.float32)
    want = jrwkv.time_mix(jl["tm"], jcfg, *map(jnp.asarray, (x, last, state)))
    got = trwkv.time_mix(tl["tm"], tcfg, *map(torch.from_numpy,
                                              (x, last, state)))
    for g, w in zip(got, want):
        lm.close(g, w)


def test_channel_mix_matches_jax():
    jcfg, tcfg, jl, tl = _layer(1)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, tcfg.d_model).astype(np.float32)
    last = rs.randn(2, tcfg.d_model).astype(np.float32)
    want = jrwkv.channel_mix(jl["cm"], jcfg, jnp.asarray(x),
                             jnp.asarray(last))
    got = trwkv.channel_mix(tl["cm"], tcfg, torch.from_numpy(x),
                            torch.from_numpy(last))
    for g, w in zip(got, want):
        lm.close(g, w)


def test_forward_matches_jax():
    lm.check_forward(ARCH)


def test_prefill_and_decode_match_jax_in_place():
    lm.check_prefill_decode(ARCH)


def test_state_holds_the_normalised_last_token():
    """tm_last / cm_last hold ln1[:, -1] / ln2[:, -1], not x: after a
    prefill, layer 0's tm_last is the first norm of the embedded last
    token."""
    _, tcfg, _, tp = lm.pair(ARCH)
    toks = torch.from_numpy(lm.tokens(3, 2, 5, tcfg.vocab))
    st = trwkv.init_state(tcfg, 2, device="cpu")
    trwkv.prefill(tp, tcfg, toks, st)
    from repro_torch.models.common import rms_norm
    h = rms_norm(tp["embed"][toks], tp["ln_in"], tcfg.norm_eps)
    want = rms_norm(h, tp["layers"]["ln1"][0], tcfg.norm_eps)[:, -1]
    torch.testing.assert_close(st["tm_last"][0], want, rtol=0, atol=0)
    assert int(st["idx"]) == 5


@pytest.mark.parametrize("seed", [0, 5])
def test_init_is_jax(seed):
    assert lm.check_init(ARCH, seed) == 0


def test_argenerator_greedy_tokens_match_jax():
    lm.check_argenerator(ARCH)


def test_dlm_trunk_generate_matches_jax():
    lm.check_dlm_generate(ARCH)


def test_dlm_trunk_training_loss_matches_jax():
    lm.check_dlm_loss(ARCH)


def test_serve_and_train_cli_smoke():
    out = lm.run_cli(serve.main, ["--arch", ARCH, "--smoke", "--batch", "2",
                                  "--new-tokens", "3", "--device", "cpu"])
    assert sum(line.startswith("req") for line in out) == 2
    out = lm.run_cli(train.main, ["--arch", ARCH, "--smoke", "--steps", "1",
                                  "--batch", "2", "--seq", "16", "--device",
                                  "cpu"])
    assert out[0].startswith(f"{ARCH}-smoke: ")
    assert np.isfinite(float(out[-1].split(":")[-1].strip(" }")))
