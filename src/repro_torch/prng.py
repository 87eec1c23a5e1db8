"""Threefry-2x32 counter-based PRNG with JAX's key and draw semantics.

A port of the ``jax.random`` functions the autoregressive sampler uses
(``PRNGKey``, ``split``, ``random_bits``, ``uniform``, ``gumbel``,
``categorical``), as JAX 0.9 runs them with ``jax_threefry_partitionable``
on (its default): the hash is ``jax/_src/prng.py::_threefry2x32_lowering``,
``split`` is ``_threefry_split_foldlike`` and ``random_bits`` is
``_threefry_random_bits_partitionable`` (counters are the row-major index
of each output element as a 64-bit integer, hashed as its (hi, lo) words).
The same key gives JAX's bits, bit for bit, on any device.

uint32 words live in int64 tensors masked to 32 bits after every
operation that can carry past them.  A key is an int64 tensor whose last
axis holds its two words: shape (2,) for one key, (..., 2) for a batch.
Functions that take a batch of keys act as ``jax.vmap`` of the JAX
function over the batch axes.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2); all broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def PRNGKey(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's 32-bit pattern in the low
    word (JAX converts the seed to int32 first, so the high word is 0).
    The key lies on ``device``, the CUDA card unless named; the other
    functions run where their keys lie."""
    if not -2 ** 31 <= int(seed) < 2 ** 32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _iota_2x32(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(hi, lo) words of the row-major index of each element of shape."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _hash(keys: torch.Tensor, shape: Tuple[int, ...]):
    """Hash the counters of ``shape`` under every key of ``keys``; returns
    two (*keys.shape[:-1], *shape) words."""
    hi, lo = _iota_2x32(shape, keys.device)
    lead = keys.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = keys[..., 0].reshape(view)
    k2 = keys[..., 1].reshape(view)
    return threefry2x32(k1, k2, hi, lo)


def split(keys: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., *num, 2)."""
    b1, b2 = _hash(keys, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``, uint32 values in an
    int64 tensor): keys (..., 2) -> (..., *shape)."""
    b1, b2 = _hash(keys, _shape(shape))
    return b1 ^ b2


def uniform(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval) by ``jax.random.uniform``'s bit
    trick: 23 random mantissa bits under exponent 0 give [1, 2), minus 1,
    then floats * (maxval - minval) + minval, floored at minval.

    XLA fuses that product and sum into one fused multiply-add.  The port
    evaluates it in float64 (the float32 product is exact there) and rounds
    once more to float32, which equals the fused result except where the
    float64 sum falls on a float32 rounding midpoint.  At the default
    range, and at [tiny, 1) for ``gumbel``, the product is by 1 and the
    result is exact either way.
    """
    bits = random_bits(keys, shape)
    one = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    floats = (one - 1.0).double()
    fused = (floats * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def gumbel(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """float32 standard Gumbel draws, ``jax.random.gumbel`` in its default
    "low" mode: -log(-log(u)), u uniform on [tiny, 1)."""
    u = uniform(keys, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max trick:
    argmax of gumbel + logits, first index on ties).

    keys (*K, 2) and logits (*K, V): each key draws its own V Gumbels, as
    ``jax.vmap(jax.random.categorical)`` does over K.  Returns (*K,) int64.
    """
    g = gumbel(keys, logits.shape[keys.dim() - 1:])
    return torch.argmax(g + logits, dim=-1)
