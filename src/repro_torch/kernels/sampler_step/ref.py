"""Plain PyTorch versions of the two sampler-step kernels.

These are the CPU path of the wrappers in ``kernel.py`` and the yardstick
the CUDA kernels (``csrc/sampler_step.cu``) are held against on the card.
They compute what the TPU kernels in ``repro/kernels/sampler_step/
kernel.py`` compute, with the same float32 rounding:

  * XLA:CPU contracts the kernel body's multiply-adds into fused
    multiply-adds (found by bitwise probing of the interpret-mode kernel):
      no clip:  a = c_x0 / sqrt_a_t
                b = fma(-a, sqrt_1m_a_t, c_dir)
                out = fma(a, x, b * eps)
      x0 form:  x0 = fma(-sqrt_1m_a_t, eps, x) / sqrt_a_t   [clip]
                eps = fma(-sqrt_a_t, x0, x) / sqrt_1m_a_t    [iff clip]
                out = fma(c_x0, x0, c_dir * eps)
      noise:    out = fma(c_noise, z, out)
    Eager PyTorch rounds every op separately, so ``_fma`` emulates the
    single rounding in float64 (the product of two float32 is exact there).
  * The software PRNG is the JAX kernel's murmur3 counter stream, bit for
    bit.  CPU PyTorch has no ``>>`` for uint32, so the uint32 mixing runs in
    int64 holding values in [0, 2**32), masked after every multiply and add.
  * Box–Muller uses PyTorch's float32 log/cos, which may differ from
    XLA's by an ulp or two; the normals are therefore held to a tolerance.

Every coefficient stays a float32 tensor: a Python float would make
``c_x0 / sqrt_a_t`` a float64 division and give other bits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# tile layout shared by the kernels, their plain versions and ops.py
TILE_R = 256
TILE_C = 256
SUBLANE = 8    # minimum row granule: small states tile at (8, TILE_C)
COEF_COLS = 8  # per-row coefficient columns: 5 live + pad

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
TID_MUL = 0x632BE59B
_INV_2_24 = 1.0 / 16777216.0
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def tile_rows(R: int) -> int:
    """Row granule of the (R, TILE_C) layout: 256 when R allows, else 8."""
    return TILE_R if R % TILE_R == 0 else SUBLANE


def salt(s: int) -> int:
    """Per-draw salt constant (uint32)."""
    return (int(s) * 0x85157AF5) & MASK32


def _u32(v) -> torch.Tensor:
    """int32 (or any int) tensor -> int64 tensor of its uint32 bits."""
    return v.to(torch.int64) & MASK32


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for uint32 values held in int64, without int64
    overflow: the constant is split into 16-bit halves."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fmix32_u32(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on numpy uint32 arrays (host-side seed streams,
    e.g. the scheduler's per-slot per-tick seeds); equals ``fmix32``."""
    h = np.asarray(h, np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _bits(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The counter stream: fmix32((ctr ^ key) * GOLDEN + key)."""
    return fmix32((_mul32(ctr ^ key, GOLDEN) + key) & MASK32)


def sw_random_bits_rows(row_seeds: torch.Tensor, col0: int, salt_id: int,
                        shape) -> torch.Tensor:
    """The per-row stream: key fmix(row_seed ^ salt), counter = lane."""
    key = fmix32(_u32(row_seeds) ^ salt(salt_id))[:, None]
    c = torch.arange(shape[1], dtype=torch.int64,
                     device=row_seeds.device)[None, :] + int(col0)
    return _bits(c, key)


def bits_to_normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Box–Muller: two uint32 draws -> one standard-normal float32.

    On a CUDA tensor log, cos and sqrt are PyTorch's float32 ops, the libm
    the CUDA kernels call.  On the CPU the whole transform is numpy:
    float64 log / cos rounded to float32, then float32 sqrt and product
    (correctly rounded).  PyTorch's float32 CPU transcendentals are neither
    correctly rounded nor path-independent: its sqrt is ~0.5% of elements
    an ulp off on an AVX512 build, and now and then one intra-op thread's
    chunk (~1/8 of 65,536 normals) came out ~2**-12 relative off; log and
    cos have shown the same (a few thousand ~5e-5 off).  So the CPU value
    is the path-independent, correctly rounded one."""
    u1 = ((b1 >> 8).to(torch.float32) + 0.5) * _INV_2_24
    u2 = (b2 >> 8).to(torch.float32) * _INV_2_24
    arg = _TWO_PI_F32 * u2
    if u1.device.type == "cpu":
        lg = np.log(u1.numpy().astype(np.float64)).astype(np.float32)
        cs = np.cos(arg.numpy().astype(np.float64)).astype(np.float32)
        return torch.from_numpy(np.sqrt(np.float32(-2.0) * lg) * cs)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(arg)


def tile_bits(seed: int, R: int, salt_id: int, device=None) -> torch.Tensor:
    """(R, TILE_C) uint32 bits (in int64) of the scalar kernel: ``repro``
    kernel.sw_random_bits tile by tile, key fmix(seed ^ tid*M ^ salt) for
    row-tile ``tid``, counter (row % tile_rows) * TILE_C + lane."""
    tr = tile_rows(R)
    row = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(TILE_C, dtype=torch.int64, device=device)[None, :]
    key = fmix32(_mul32(row // tr, TID_MUL) ^ (int(seed) & MASK32)
                 ^ salt(salt_id))
    return _bits((row % tr) * TILE_C + col, key)


def tile_noise(seed: int, R: int, device=None) -> torch.Tensor:
    """(R, TILE_C) normals of the scalar kernel."""
    return bits_to_normal(tile_bits(seed, R, 1, device),
                          tile_bits(seed, R, 2, device))


def row_noise(row_seeds: torch.Tensor) -> torch.Tensor:
    """(R, TILE_C) normals of the per-row kernel."""
    shape = (row_seeds.shape[0], TILE_C)
    return bits_to_normal(sw_random_bits_rows(row_seeds, 0, 1, shape),
                          sw_random_bits_rows(row_seeds, 0, 2, shape))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) rounded once to float32, emulated in float64."""
    return (a.double() * b.double() + c.double()).float()


def update(x, eps, c_x0, c_dir, sqrt_a_t, sqrt_1m_a_t,
           clip: Optional[float] = None, want_x0: bool = False):
    """The deterministic step body in float32: (x0 or None, x_prev).

    Coefficients are float32 tensors: 0-dim (scalar kernel) or (R, 1)
    columns (per-row kernel).  ``want_x0`` selects the explicit-x0 form.
    """
    if clip is None and not want_x0:
        a = c_x0 / sqrt_a_t
        b = _fma(-a, sqrt_1m_a_t, c_dir)
        return None, _fma(a, x, b * eps)
    x0 = _fma(-sqrt_1m_a_t, eps, x) / sqrt_a_t
    if clip is not None:
        x0 = torch.clamp(x0, -clip, clip)
        eps = _fma(-sqrt_a_t, x0, x) / sqrt_1m_a_t
    return x0, _fma(c_x0, x0, c_dir * eps)


def sampler_step_2d(x: torch.Tensor, eps: torch.Tensor, coefs: torch.Tensor,
                    seed: Optional[int] = None, *,
                    clip: Optional[float] = None,
                    stochastic: bool = False) -> torch.Tensor:
    """Plain version of the scalar-coefficient kernel.

    coefs: (5,) float32 [c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t] on
    x's device; seed: int32 value, required iff stochastic.
    """
    c = coefs.to(device=x.device, dtype=torch.float32)
    _, out = update(x.float(), eps.float(), c[0], c[1], c[3], c[4], clip)
    if stochastic:
        if seed is None:
            raise ValueError("stochastic sampler_step needs a seed")
        out = _fma(c[2], tile_noise(int(seed), x.shape[0], x.device), out)
    return out.to(x.dtype)


def sampler_step_rows_2d(x: torch.Tensor, eps: torch.Tensor,
                         row_coefs: torch.Tensor,
                         row_seeds: Optional[torch.Tensor] = None, *,
                         clip: Optional[float] = None,
                         stochastic: bool = False, want_x0: bool = False):
    """Plain version of the per-row kernel: (R, COEF_COLS) coefficients and
    (R,) int32 seeds.  Returns x_prev, or (x_prev, x0_hat) when want_x0."""
    c = row_coefs.to(torch.float32)
    x0, out = update(x.float(), eps.float(), c[:, 0:1], c[:, 1:2],
                     c[:, 3:4], c[:, 4:5], clip, want_x0)
    if stochastic:
        if row_seeds is None:
            raise ValueError("stochastic sampler_step_rows needs row_seeds")
        out = _fma(c[:, 2:3], row_noise(row_seeds), out)
    out = out.to(x.dtype)
    return (out, x0.to(x.dtype)) if want_x0 else out
