"""The hybrid family (``models/hybrid.py``: zamba2-2.7b's Mamba2 layers
with a shared attention block every ``attn_every`` layers), its config,
its registry entry, its diffusion-LM trunk (Mamba2 layers only) and its
CLIs, against the JAX package on the CPU at the smoke config.

Tolerances are ``tests/_torch_lm.py``'s: logits and caches 1e-5 of
max|.| of JAX's, the cached recurrence against the chunked forward 1e-5
of max|logits| at this size, drawn init leaves bitwise (``A_log`` /
``dt_bias`` within 2 float32 ulps), the diffusion-LM's x0 1e-4 of
max|x0| and its loss 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import configs as jconfigs
from repro.models import hybrid as jhybrid
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import hybrid as thybrid

import _torch_lm as lm

ARCH = "zamba2-2.7b"


def test_config_field_for_field():
    for get in ("get", "get_smoke"):
        t, j = getattr(configs, get)(ARCH), getattr(jconfigs, get)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert thybrid.n_apps(configs.get(ARCH)) == jhybrid.n_apps(
        jconfigs.get(ARCH)) == 9


def test_forward_matches_jax():
    lm.check_forward(ARCH)


def test_prefill_and_decode_match_jax_in_place():
    lm.check_prefill_decode(ARCH)


@pytest.mark.parametrize("seed", [0, 5])
def test_init_is_jax(seed):
    # A_log and dt_bias of each of the 4 layers
    assert lm.check_init(ARCH, seed) == 2


def test_cache_layout_is_jax():
    tcfg = configs.get_smoke(ARCH)
    c = thybrid.init_cache(tcfg, 3, 10, device="cpu")
    j = jhybrid.init_cache(jconfigs.get_smoke(ARCH), 3, 10)
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        k: v.shape for k, v in j.items()}
    assert c["k"].shape == (2, 3, 10, 4, 32)          # per application
    assert all(float(v.abs().max()) == 0 for v in c.values())


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
