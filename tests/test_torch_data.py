"""The port's synthetic data (``repro_torch.data``) against the JAX
package's ``repro.data``, batch for batch from the same seeds.

Tolerances:
  * ``SyntheticTokens``: bitwise (threefry integers through one table);
  * ``GaussianMixture2D``: 4 float32 ulps of max(|x|, 1) (measured 0: a
    gather, one product and one sum, which XLA may fuse);
  * ``SyntheticImages``: 4 float32 ulps of max(|x|, 1) (measured 1.5: XLA's
    float32 cos / exp / tanh and its fused multiply-adds against torch's);
  * ``mode_assignment`` and ``bigram_validity``: equal.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro import data as jdata
from repro_torch import data as tdata
from repro_torch import prng

ULPS = 4


def _ulps_of_scale(got, want):
    want = np.asarray(want)
    spacing = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / spacing).max())


@pytest.mark.parametrize("vocab,batch,seq", [(256, 4, 33), (300, 3, 17),
                                             (49152, 2, 64)], ids=str)
@pytest.mark.parametrize("seed", [0, 5], ids=str)
def test_tokens_bitwise(vocab, batch, seq, seed):
    j = jdata.SyntheticTokens(vocab=vocab, seed=seed)
    t = tdata.SyntheticTokens(vocab=vocab, seed=seed)
    want = np.asarray(j.sample(jax.random.PRNGKey(seed + 1), batch, seq))
    got = t.sample(prng.PRNGKey(seed + 1, "cpu"), batch, seq)
    assert got.dtype == torch.int32 and got.shape == (batch, seq)
    np.testing.assert_array_equal(got.numpy(), want)
    assert t.bigram_validity(got.numpy()) == j.bigram_validity(want) == 1.0


def test_token_pipeline_batches_bitwise():
    jg = jdata.make_token_pipeline(128, 3, 20, seed=2)
    tg = tdata.make_token_pipeline(128, 3, 20, seed=2, device="cpu")
    for _ in range(3):
        np.testing.assert_array_equal(next(tg).numpy(), np.asarray(next(jg)))
    t = tdata.SyntheticTokens(vocab=128, seed=2)
    rnd = np.random.RandomState(0).randint(0, 128, (4, 9))
    assert t.bigram_validity(rnd) == jdata.SyntheticTokens(
        vocab=128, seed=2).bigram_validity(rnd)


@pytest.mark.parametrize("size,n", [(16, 8), (32, 4)], ids=str)
@pytest.mark.parametrize("seed", [0, 3], ids=str)
def test_images_within_ulps(size, n, seed):
    want = jdata.SyntheticImages(size=size, seed=seed).sample(
        jax.random.PRNGKey(seed), n)
    got = tdata.SyntheticImages(size=size, seed=seed).sample(
        prng.PRNGKey(seed, "cpu"), n)
    assert got.shape == (n, size, size, 3) and got.dtype == torch.float32
    assert float(got.abs().max()) <= 1.0
    assert _ulps_of_scale(got.numpy(), want) <= ULPS


def test_image_pipeline_batches():
    jg = jdata.make_image_pipeline(16, 2, seed=1)
    tg = tdata.make_image_pipeline(16, 2, seed=1, device="cpu")
    for _ in range(2):
        assert _ulps_of_scale(next(tg).numpy(), next(jg)) <= ULPS


@pytest.mark.parametrize("seed", [0, 9], ids=str)
def test_gaussian_mixture_within_ulps(seed):
    j = jdata.GaussianMixture2D(seed=seed)
    t = tdata.GaussianMixture2D(seed=seed)
    want = np.asarray(next(j.batches(512)))
    got = next(t.batches(512, device="cpu")).numpy()
    assert _ulps_of_scale(got, want) <= ULPS
    np.testing.assert_array_equal(t.modes(), j.modes())
    np.testing.assert_array_equal(t.mode_assignment(got),
                                  j.mode_assignment(want))


def test_samples_run_where_the_key_lies():
    """Meta keys stand for the card: shapes and dtypes only."""
    k = prng.PRNGKey(0, device="meta")
    assert tdata.SyntheticImages(size=8).sample(k, 2).device.type == "meta"
    assert tdata.GaussianMixture2D().sample(k, 5).shape == (5, 2)


def test_pipelines_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(tdata.make_token_pipeline(16, 2, 4))
