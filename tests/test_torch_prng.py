"""The port's threefry PRNG (``repro_torch.prng``) against ``jax.random``.

JAX runs with ``jax_threefry_partitionable`` on (its default since 0.5;
the test checks it), which fixes how ``split`` and ``random_bits`` lay out
their counters.

Tolerances:
  * keys, ``split`` and ``random_bits``: bitwise (uint32 words).
  * ``uniform``: bitwise (a bit pattern, one float32 subtraction, one
    product by exactly 1 and one addition).
  * ``gumbel``: 4 float32 ulps of max(|g|, 1).  Each of its two logs is
    within 1 ulp of XLA's; where -log(u) is near 1 the outer log's value is
    near 0, so the gap is an ulp of 1 there, not of the value.
  * ``categorical``: equal indices, except where JAX's top-2 of gumbel +
    logits are within the gumbel tolerance (a near tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = [0, 1, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (513,)]
GUMBEL_ULPS = 4


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def test_jax_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS + [-1, 12345], ids=str)
def test_prng_key_bitwise(seed):
    assert prng.PRNGKey(seed, "cpu").tolist() == _u32(_jkey(seed)).tolist()


def test_prng_key_refuses_seeds_past_32_bits():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 32, "cpu")


@pytest.mark.parametrize("seed", SEEDS, ids=str)
@pytest.mark.parametrize("num", [2, 3, (2, 3)], ids=str)
def test_split_bitwise(seed, num):
    got = prng.split(prng.PRNGKey(seed, "cpu"), num)
    want = _u32(jax.random.split(_jkey(seed), num))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS, ids=str)
def test_split_chain_bitwise(seed):
    """Five generations of split, as the AR sampler walks its keys."""
    k, jk = prng.PRNGKey(seed, "cpu"), _jkey(seed)
    for _ in range(5):
        k, sub = prng.split(k)
        jk, jsub = jax.random.split(jk)
        assert np.array_equal(k.numpy(), _u32(jk))
        assert np.array_equal(sub.numpy(), _u32(jsub))


@pytest.mark.parametrize("seed", SEEDS, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_bitwise(seed, shape):
    got = prng.random_bits(prng.PRNGKey(seed, "cpu"), shape)
    want = _u32(jax.random.bits(_jkey(seed), shape))
    assert np.array_equal(got.numpy(), want)


def test_batched_keys_are_vmap():
    """A (B, 2) batch of keys acts as jax.vmap over the batch."""
    keys = jnp.stack([_jkey(s) for s in SEEDS])
    tkeys = torch.stack([prng.PRNGKey(s, "cpu") for s in SEEDS])
    want = _u32(jax.vmap(lambda k: jax.random.split(k, 2))(keys))
    assert np.array_equal(prng.split(tkeys, 2).numpy(), want)
    want = _u32(jax.vmap(lambda k: jax.random.bits(k, (4, 3)))(keys))
    assert np.array_equal(prng.random_bits(tkeys, (4, 3)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_bitwise(seed, shape):
    got = prng.uniform(prng.PRNGKey(seed, "cpu"), shape).numpy()
    want = np.asarray(jax.random.uniform(_jkey(seed), shape))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_range_bitwise():
    key = prng.PRNGKey(7, "cpu")
    got = prng.uniform(key, (1000,), minval=-2.0, maxval=3.0).numpy()
    want = np.asarray(jax.random.uniform(_jkey(7), (1000,), minval=-2.0,
                                         maxval=3.0))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _gumbel_gap_ulps(got, want):
    spacing = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    return float((np.abs(got.astype(np.float64) - want) / spacing).max())


@pytest.mark.parametrize("seed", SEEDS, ids=str)
def test_gumbel_within_four_ulps(seed):
    got = prng.gumbel(prng.PRNGKey(seed, "cpu"), (4096,)).numpy()
    want = np.asarray(jax.random.gumbel(_jkey(seed), (4096,)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _gumbel_gap_ulps(got, want) <= GUMBEL_ULPS


def test_uniform_floor_gives_finite_gumbels():
    """u is floored at float32 tiny, so an all-zero mantissa still gives a
    finite Gumbel draw: the smallest draw of 65,536 is finite."""
    g = prng.gumbel(prng.PRNGKey(3, "cpu"), (65536,))
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("seed", SEEDS, ids=str)
def test_categorical_matches_jax_except_near_ties(seed):
    rs = np.random.RandomState(seed % 1000)
    logits = (rs.randn(6, 512) * 2).astype(np.float32)
    logits[1, ::3] = -np.inf                    # a top-k filtered row
    jkeys = jax.random.split(_jkey(seed), 6)
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys,
                                                        jnp.asarray(logits)))
    got = prng.categorical(torch.from_numpy(_u32(jkeys)),
                           torch.from_numpy(logits)).numpy()
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (512,)))(jkeys))
    z = np.sort(jg + logits, axis=-1)
    tol = GUMBEL_ULPS * np.spacing(np.float32(max(np.abs(jg).max(), 1.0)))
    near_tie = (z[:, -1] - z[:, -2]) <= 2 * tol
    assert ((got == want) | near_tie).all()
    assert logits[1, got[1]] > -np.inf


def test_prng_runs_on_any_device_tensor():
    """The keys' device carries through (meta tensors stand in for the
    card): shapes and dtypes only."""
    k = prng.PRNGKey(0, device="meta")
    assert prng.split(k, 3).shape == (3, 2)
    assert prng.gumbel(k, (5,)).device.type == "meta"
    assert prng.random_bits(k, (2, 2)).dtype == torch.int64


def test_prng_key_defaults_to_the_card(monkeypatch):
    """With no device named the key goes to CUDA, and without a card that
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prng.PRNGKey(0)
