"""Threefry-2x32 counter-based PRNG with JAX's key and draw semantics.

A port of the ``jax.random`` functions the port draws with (``PRNGKey``,
``split``, ``random_bits``, ``uniform``, ``normal``, ``randint``,
``truncated_normal``, ``gumbel``, ``categorical``), as JAX 0.9 runs them
with ``jax_threefry_partitionable`` on (its default): the hash is
``jax/_src/prng.py::_threefry2x32_lowering``, ``split`` is
``_threefry_split_foldlike`` and ``random_bits`` is
``_threefry_random_bits_partitionable`` (counters are the row-major index
of each output element as a 64-bit integer, hashed as its (hi, lo) words).
The same key gives JAX's bits, bit for bit, on any device.

uint32 words live in int64 tensors masked to 32 bits after every
operation that can carry past them.  A key is an int64 tensor whose last
axis holds its two words: shape (2,) for one key, (..., 2) for a batch.
Functions that take a batch of keys act as ``jax.vmap`` of the JAX
function over the batch axes.

The float draws follow XLA:CPU's float32 code for them op for op: the
erf / erf_inv / log1p expansions XLA emits (M. Giles' erf_inv, a Cephes
logf and log1p) with the fused multiply-adds its x86 code generator forms.
Sums, products and quotients are float32 tensor ops (IEEE on the CPU and
the card); a square root is taken in float64 and rounded, and a fused
multiply-add is an exact float64 product plus a float64 sum, rounded to
float32 (``_fma32``).  So the draws are JAX's bit for bit on either
device (``_fma32`` says where that rests on the tests).  ``uniform`` and
``normal`` also draw bfloat16 and float16 at their own width, as JAX does
(``_uniform16``): a bfloat16 draw is not the float32 one rounded.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
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
    key = torch.zeros(2, dtype=torch.int64, device=resolve_device(device))
    key[1] = int(seed) & _MASK          # a fill: no host-to-device copy
    return key


def _iota_2x32(shape: Tuple[int, ...], device, start: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the row-major index of each element of shape,
    plus ``start``."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(start, start + n, dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _hash(keys: torch.Tensor, shape: Tuple[int, ...], start: int = 0):
    """Hash the counters of ``shape`` (offset by ``start``) under every key
    of ``keys``; returns two (*keys.shape[:-1], *shape) words."""
    hi, lo = _iota_2x32(shape, keys.device, start)
    lead = keys.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = keys[..., 0].reshape(view)
    k2 = keys[..., 1].reshape(view)
    return threefry2x32(k1, k2, hi, lo)


def split(keys: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., *num, 2)."""
    b1, b2 = _hash(keys, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape, *,
                start: int = 0) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``, uint32 values in an
    int64 tensor): keys (..., 2) -> (..., *shape).

    ``start`` offsets the counters: the bits of a flat ``shape`` (n,) at
    ``start`` are elements [start, start + n) of a larger row-major draw
    (the counter of an element is its row-major index), which is how a
    large draw is taken in chunks (``normal`` / ``truncated_normal``
    forward it)."""
    b1, b2 = _hash(keys, _shape(shape), start)
    return b1 ^ b2


# ---------------------------------------------------- float32 arithmetic
def _fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c (float32 tensors or float32-valued Python floats)
    as XLA's fused multiply-add: the product is exact in float64 and the
    float64 sum is rounded to float32.  That rounds twice, and differs
    from one rounding only where the float64 sum lands exactly on a
    float32 midpoint; the tests run every input ``normal`` and
    ``truncated_normal(-3, 3)`` can draw and find no such case.  Use
    ``_fma32_exact`` where the inputs are not covered so."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def _fma32_exact(a, b, c) -> torch.Tensor:
    """``_fma32`` rounded once: where the float64 sum is a float32 midpoint
    and inexact (its two-sum error is not 0), it is first moved one
    float64 ulp towards the exact value."""
    p = _f64(a) * _f64(b)
    c = _f64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    toward = torch.nextafter(s, err * float("inf"))
    return torch.where(mid & (err != 0), toward, s).float()


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else x


def _poly(x: torch.Tensor, coefs, start) -> torch.Tensor:
    """Horner's rule with one fused multiply-add (``_fma32``) per
    coefficient; x is widened once."""
    x = x.double()
    p = start
    for c in coefs:
        p = (x * p.double() + c).float()
    return p


def _uniform32(keys: torch.Tensor, shape: Shape, lo: torch.Tensor,
               hi: torch.Tensor, start: int = 0) -> torch.Tensor:
    """``uniform`` on float32 bounds ``lo`` / ``hi`` (0-dim tensors)."""
    bits = random_bits(keys, shape, start=start)
    one = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    return torch.maximum(lo, _fma32_exact(one - 1.0, hi - lo, lo))


def _scalar32(v, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _table64(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A float64 constant vector, copied to ``device`` once."""
    return torch.tensor(values, dtype=torch.float64).to(device)


# the 16-bit float types JAX draws at their own width: mantissa bits
_MANT16 = {torch.bfloat16: 7, torch.float16: 10}


def _uniform16(keys: torch.Tensor, shape: Shape, minval: float,
               maxval: float, dtype: torch.dtype,
               start: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in a 16-bit float type, as ``_uniform`` runs
    it: ``random_bits`` at bit width 8 (bfloat16: fewer than 8 mantissa
    bits) or 16, i.e. the low byte or half of the 32-bit word, shifted
    onto the mantissa under exponent 0, minus 1, then floats * (maxval -
    minval) + minval and the floor at minval, bounds converted to
    ``dtype`` first.  XLA:CPU rounds that product and that sum to
    bfloat16 one by one, and fuses them for float16 (one rounding of the
    exact value).  bfloat16 draws take one of 128 values."""
    nmant = _MANT16[dtype]
    width = 8 if nmant < 8 else 16
    bits = random_bits(keys, shape, start=start) & ((1 << width) - 1)
    one = int(torch.ones((), dtype=dtype).view(torch.int16))
    floats = ((bits >> (width - nmant)) | one).to(torch.int16).view(dtype)
    lo = torch.full((), minval, dtype=dtype, device=keys.device)
    hi = torch.full((), maxval, dtype=dtype, device=keys.device)
    if dtype == torch.bfloat16:
        out = (floats - 1.0) * (hi - lo) + lo
    else:    # exact in float64: 11-bit operands
        out = ((floats - 1.0).double() * (hi - lo).double()
               + lo.double()).to(dtype)
    return torch.maximum(lo, out)


def _check_dtype(dtype: torch.dtype) -> None:
    if not dtype.is_floating_point:
        raise TypeError(f"JAX draws floats only, got dtype {dtype}")


def uniform(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, *,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform in [minval, maxval) by ``jax.random.uniform``'s bit trick:
    random mantissa bits under exponent 0 give [1, 2), minus 1, then
    floats * (maxval - minval) + minval, floored at minval.  In float32
    (23 bits) XLA fuses that product and sum into one multiply-add; so
    does the port.  bfloat16 and float16 draw at their own width
    (``_uniform16``).  float64 is JAX's float32 draw, widened (JAX draws
    float32 unless x64 is on)."""
    _check_dtype(dtype)
    if dtype in _MANT16:
        return _uniform16(keys, shape, minval, maxval, dtype)
    return _uniform32(keys, shape, _scalar32(minval, keys.device),
                      _scalar32(maxval, keys.device)).to(dtype)


# XLA:CPU's float32 log: a Cephes logf on the mantissa in [sqrt(1/2), sqrt(2))
_LOG_P = ((0.07037683576345444, -0.11514610052108765, 0.11676998436450958),
          (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426),
          (0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
_LN2_LO = -0.00021219444170128554
_LN2_HI = 0.693359375
_SQRT_HALF = 0.7071067690849304
# its log1p below |x| < sqrt(2) - 1: x - x^2/2 + x^3 * num(x) / den(x)
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_NUM = (0.4985410273075104, 6.578732490539551, 29.91191864013672,
              60.949668884277344, 57.11296463012695, 20.039552688598633)
_LOG1P_NUM0 = 4.527000055531971e-05
_LOG1P_DEN = (15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
# erf_inv (Giles): w = -log1p(-x^2), one polynomial below w = 5, one above
_ERFINV_LO = (2.810226362726098e-08, 3.432739390518691e-07,
              -3.523387704262859e-06, -4.391506536194356e-06,
              0.00021858086984138936, -0.001253725029528141,
              -0.004177681636065245, 0.24664072692394257, 1.5014094114303589)
_ERFINV_HI = (-0.0002002142573473975, 0.0001009505576803349,
              0.0013493432197719812, -0.003673428436741233,
              0.005739507731050253, -0.007622461300343275,
              0.00943887047469616, 1.0016740560531616, 2.832976818084717)
# erf: x * num(x^2) / den(x^2) on x clamped to +-3.7439213
_ERF_CLAMP = 3.7439212799072266
_ERF_NUM = (0.0034082909114658833, 0.050955694168806076,
            0.18520832061767578, 1.1283791065216064)
_ERF_NUM0 = 0.00022905065270606428
_ERF_DEN = (2.354796561121475e-05, 0.0010179625824093819,
            0.01407046988606453, 0.11098504811525345, 0.4974692463874817,
            1.0)
_ERF_DEN0 = -1.1791603071742429e-07
_SQRT2 = 1.4142135381698608


def _log32(y: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log of y > 0 (its inf / 0 / negative cases
    included)."""
    bits = torch.clamp(y, min=_F32_TINY).view(torch.int32)
    e = ((bits >> 23) - 126).float()
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    r = (m - 1.0) + torch.where(small, m, 0.0)
    e = torch.where(small, e - 1.0, e)
    z = r * r
    r3 = z * r
    p1, p2, p3 = (_poly(r, (c1, c2), torch.full_like(r, c0))
                  for c0, c1, c2 in _LOG_P)
    t = _fma32(r3, p1, p2)
    t = _fma32(r3, t, p3)
    t = _fma32(r3, t, e * _LN2_LO)
    out = _fma32(e, _LN2_HI, (r - 0.5 * z) + t)
    out = torch.where(y == float("inf"), y, out)
    out = torch.where(y == 0, -float("inf"), out)
    return torch.where(y < 0, float("nan"), out)


def _log1p32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log1p."""
    large = _log32(x + 1.0)
    x2 = x * x
    num = _poly(x, _LOG1P_NUM, torch.full_like(x, _LOG1P_NUM0))
    den = _poly(x, _LOG1P_DEN, torch.ones_like(x))
    small = x + (((x * x2) * (num / den)) - 0.5 * x2)
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def erf_inv32(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` of a float32 tensor."""
    lg = _log1p32(u * -u)
    low = lg > -5.0                                    # w = -lg < 5
    w = torch.where(low, -2.5 - lg,
                    torch.sqrt(-lg.double()).float() - 3.0)
    coefs = torch.where(low[..., None], _table64(_ERFINV_LO, u.device),
                        _table64(_ERFINV_HI, u.device))
    p = _poly(w, coefs.unbind(-1)[1:], coefs[..., 0].float())
    return u * torch.where(u.abs() == 1.0, float("inf"), p)


def erf32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``erf`` of a float32 tensor (exact fused
    multiply-adds: it is evaluated on two bounds per draw)."""
    x = x.clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    num = _fma32_exact(x2, _ERF_NUM0, _ERF_NUM[0])
    for c in _ERF_NUM[1:]:
        num = _fma32_exact(num, x2, c)
    den = _fma32_exact(x2, _ERF_DEN0, _ERF_DEN[0])
    for c in _ERF_DEN[1:]:
        den = _fma32_exact(den, x2, c)
    return (x * num) / den


def normal(keys: torch.Tensor, shape: Shape = (), *, start: int = 0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normals, ``jax.random.normal(key, shape, dtype)``:
    sqrt(2) * erf_inv(u), u uniform on [nextafter(-1, 0), 1) in ``dtype``.
    In a 16-bit type u is ``_uniform16``'s, erf_inv is XLA's float32 one
    rounded to ``dtype`` (XLA widens the 16-bit erf_inv to float32), and
    its product with sqrt(2) (itself in ``dtype``) is rounded to
    ``dtype``.
    float64 is the float32 draw, widened.  ``start`` as in
    ``random_bits``."""
    _check_dtype(dtype)
    if dtype in _MANT16:
        nmant = _MANT16[dtype]
        u = _uniform16(keys, shape, -(1.0 - 2.0 ** -(nmant + 1)), 1.0,
                       dtype, start)
        sqrt2 = torch.full((), math.sqrt(2), dtype=torch.float64,
                           device=keys.device).to(dtype)
        return erf_inv32(u.float()).to(dtype) * sqrt2
    lo = _scalar32(float(np.nextafter(np.float32(-1), np.float32(0))),
                   keys.device)
    u = _uniform32(keys, shape, lo, torch.ones_like(lo), start)
    return (erf_inv32(u) * _SQRT2).to(dtype)


def truncated_normal(keys: torch.Tensor, lower: float, upper: float,
                     shape: Shape = (), *, start: int = 0) -> torch.Tensor:
    """float32 normals truncated to (lower, upper),
    ``jax.random.truncated_normal``: u uniform on [erf(lower / sqrt2),
    erf(upper / sqrt2)), sqrt(2) * erf_inv(u), clipped to the open
    interval.  ``start`` as in ``random_bits``."""
    lo = _scalar32(lower, keys.device)
    hi = _scalar32(upper, keys.device)
    u = _uniform32(keys, shape, erf32(lo / _SQRT2), erf32(hi / _SQRT2),
                   start)
    out = erf_inv32(u) * _SQRT2
    return out.clamp(torch.nextafter(lo, lo.new_tensor(float("inf"))),
                     torch.nextafter(hi, hi.new_tensor(-float("inf"))))


def randint(keys: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 integers in [minval, maxval), ``jax.random.randint``: two
    32-bit words per element from ``split(key)``, folded modulo the span
    with uint32 wrap-around (so a span that is not a power of two is
    slightly biased, as in JAX)."""
    lo32 = min(max(int(minval), -2 ** 31), 2 ** 31 - 1)
    hi32 = min(max(int(maxval), -2 ** 31), 2 ** 31 - 1)
    span = (hi32 - lo32) & _MASK
    if hi32 <= lo32:
        span = 1
    if int(maxval) > 2 ** 31 - 1 and hi32 > lo32:
        span = (span + 1) & _MASK
    ks = split(keys)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    if span == 0:                 # 2**32: every remainder is the word itself
        offset = (higher * 0 + lower) & _MASK
    else:
        mult = ((2 ** 16 % span) ** 2 & _MASK) % span   # uint32 square
        offset = (((higher % span) * mult) & _MASK) + lower % span
        offset = (offset & _MASK) % span
    out = (lo32 + offset) & _MASK
    return (out - ((out >> 31) << 32)).to(torch.int32)


def gumbel(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """float32 standard Gumbel draws, ``jax.random.gumbel`` in its default
    "low" mode: -log(-log(u)), u uniform on [tiny, 1)."""
    u = uniform(keys, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max trick:
    argmax of gumbel + logits, first index on ties).

    keys (*K, 2) and logits (*K, ..., V): each key draws its own Gumbels
    over the rest of the logits' shape, as ``jax.vmap(
    jax.random.categorical)`` does over K.  One key (shape (2,)) is
    ``jax.random.categorical(key, logits, axis=-1)`` itself: one Gumbel
    draw of ``logits.shape``.  Returns logits.shape[:-1], int64.
    """
    g = gumbel(keys, logits.shape[keys.dim() - 1:])
    return torch.argmax(g + logits, dim=-1)
