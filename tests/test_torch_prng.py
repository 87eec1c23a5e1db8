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
  * ``randint``: bitwise (int32).
  * ``normal`` and ``truncated_normal``: NORMAL_ULPS = 4 float32 ulps of
    max(|z|, 1).  The port follows XLA's float32 erf / erf_inv / log1p op
    for op, fused multiply-adds included, and is bitwise on the x86 CPU
    these tests were written on (gap 0 on every one of the 2**23
    uniforms each can draw, the two extremes included).  Which of
    erf_inv's multiply-adds XLA fuses is its code generator's choice; an
    erf_inv with none fused is 2 ulps away, so the bound holds either way.
  * XLA's float32 ``erf`` (two bounds per truncated draw): bitwise (XLA
    writes its multiply-adds as explicit fused ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax import lax

from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from repro_torch import prng

SEEDS = [0, 1, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (513,)]
GUMBEL_ULPS = 4
NORMAL_ULPS = 4


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


RANGES = [(1, 1001), (0, 2 ** 31 - 1), (0, 4), (-5, 5), (3, 3)]


@pytest.mark.parametrize("seed", SEEDS, ids=str)
@pytest.mark.parametrize("lohi", RANGES, ids=str)
def test_randint_bitwise(seed, lohi):
    lo, hi = lohi
    got = prng.randint(prng.PRNGKey(seed, "cpu"), (3, 333), lo, hi).numpy()
    want = np.asarray(jax.random.randint(_jkey(seed), (3, 333), lo, hi))
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_randint_batched_keys_are_vmap():
    keys = jnp.stack([_jkey(s) for s in SEEDS])
    tkeys = torch.from_numpy(_u32(keys))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (5,), 1, 1001))(keys))
    assert np.array_equal(prng.randint(tkeys, (5,), 1, 1001).numpy(), want)


def _same_bits(got, want):
    return got.dtype == np.float32 and np.array_equal(
        got.view(np.int32), np.asarray(want).view(np.int32))


def _normals_close(got, want):
    return (got.dtype == np.float32 and np.isfinite(got).all()
            and _gumbel_gap_ulps(got, np.asarray(want)) <= NORMAL_ULPS)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, 42], ids=str)
def test_normal_matches_jax_over_a_million_draws(seed):
    """4 keys x 2**20 draws: 2**22 in all."""
    got = prng.normal(prng.PRNGKey(seed, "cpu"), (1 << 20,)).numpy()
    assert _normals_close(got, jax.random.normal(_jkey(seed), (1 << 20,)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_matches_jax_shapes(shape):
    got = prng.normal(prng.PRNGKey(3, "cpu"), shape).numpy()
    assert _normals_close(got, jax.random.normal(_jkey(3), shape))


@pytest.mark.parametrize("seed", [0, 7], ids=str)
@pytest.mark.parametrize("bounds", [(-3.0, 3.0), (-2.0, 2.0), (-1.0, 2.5)],
                         ids=str)
def test_truncated_normal_matches_jax_and_lies_inside(seed, bounds):
    lo, hi = bounds
    got = prng.truncated_normal(prng.PRNGKey(seed, "cpu"), lo, hi,
                                (1 << 18,)).numpy()
    want = jax.random.truncated_normal(_jkey(seed), lo, hi, (1 << 18,))
    assert _normals_close(got, want)
    assert (got > lo).all() and (got < hi).all()


def _all_uniforms(lo, hi):
    """Every value ``uniform`` can give on [lo, hi): the 2**23 mantissas
    through XLA's fused f * (hi - lo) + lo, floored at lo."""
    m = np.arange(1 << 23, dtype=np.uint32)
    f = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo, hi = np.float32(lo), np.float32(hi)
    fused = f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fused.astype(np.float32))


def _port_transform(u):
    out = [(prng.erf_inv32(torch.from_numpy(c)) * prng._SQRT2).numpy()
           for c in np.array_split(u, 8)]
    return np.concatenate(out)


def test_normal_transform_on_every_uniform():
    """sqrt2 * erf_inv on all 2**23 uniforms of normal's range, the
    extremes nextafter(-1, 0) and 1 - 2**-22 included."""
    u = _all_uniforms(np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    assert u.min() == np.nextafter(np.float32(-1), np.float32(0))
    assert u.max() == np.float32(2 - 2.0 ** -22 + np.float64(u.min()))
    want = jax.jit(lambda v: lax.erf_inv(v) * np.float32(np.sqrt(2)))(u)
    assert _normals_close(_port_transform(u), want)


def test_truncated_transform_on_every_uniform():
    """The same over truncated_normal(-3, 3)'s uniform range, whose ends
    are XLA's float32 erf(-+3 / sqrt2)."""
    s2 = np.float32(np.sqrt(2))
    a, b = (np.asarray(jax.jit(lax.erf)(np.float32(v) / s2))
            for v in (-3.0, 3.0))
    pa, pb = (np.float32(prng.erf32(torch.tensor(v) / float(s2)))
              for v in (-3.0, 3.0))
    assert pa == a and pb == b
    u = _all_uniforms(a, b)
    want = jax.jit(lambda v: lax.erf_inv(v) * s2)(u)
    assert _normals_close(_port_transform(u), want)


def test_erf_bitwise_on_a_grid():
    x = np.linspace(-5, 5, 100_003, dtype=np.float32)
    got = prng.erf32(torch.from_numpy(x)).numpy()
    assert _same_bits(got, jax.jit(lax.erf)(x))


def test_normal_runs_where_its_key_lies():
    k = prng.PRNGKey(0, device="meta")
    assert prng.normal(k, (5,)).device.type == "meta"
    assert prng.randint(k, (2, 2), 0, 4).dtype == torch.int32
    assert prng.truncated_normal(k, -3, 3, (4,)).shape == (4,)
