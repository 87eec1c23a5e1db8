"""Wrappers of the CUDA sampler-step kernels (``csrc/sampler_step.cu``).

Port of the two Pallas kernels in ``repro/kernels/sampler_step/kernel.py``
(``sampler_step_2d`` and ``sampler_step_rows_2d``).  Each wrapper checks
its inputs, allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream and counts the launch in its ``launches``
attribute.  On tensors that lie on the CPU it runs the plain PyTorch
version (``ref.py``) instead and counts nothing; on a CUDA tensor it
launches or raises — there is no fallback.

Both launch blocks of 256 threads, each thread taking 4 elements (one
vector) in a deterministic step and 1 in a stochastic one (``grid``).
``empty_kernel`` launches the library's empty kernel the same way: the
fixed cost per launch that the step kernels are measured against.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

from . import ref
from .ref import COEF_COLS, TILE_C, tile_rows

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("sampler_step")
    lib.repro_sampler_step_2d.argtypes = [
        _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _F, _I, _I, _P]
    lib.repro_sampler_step_2d.restype = _I
    lib.repro_sampler_step_rows_2d.argtypes = [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P]
    lib.repro_sampler_step_rows_2d.restype = _I
    lib.repro_empty_kernel.argtypes = [_I, _P]
    lib.repro_empty_kernel.restype = _I
    return lib


def grid(R: int, stochastic: bool) -> int:
    """Blocks of 256 threads that one step over R rows launches: a thread
    takes 1 element of a stochastic step (the noise chain is the longest
    part of its work) and 4 (one vector) of a deterministic one."""
    return -(-R * TILE_C // ((1 if stochastic else 4) * 256))


def empty_kernel(blocks: int) -> None:
    """Launch the library's empty kernel, ``blocks`` blocks of 256 threads,
    on the current CUDA stream."""
    err = _lib().repro_empty_kernel(int(blocks),
                                    torch.cuda.current_stream().cuda_stream)
    build.raise_on(err, "empty_kernel")


def _check_state(x: torch.Tensor, eps: torch.Tensor) -> None:
    """Shape/dtype/device/contiguity contract of both kernels."""
    for name, t in (("x", x), ("eps", eps)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32, bfloat16 or float16, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or x.shape[1] != TILE_C:
        raise ValueError(f"x must be (R, {TILE_C}), got {tuple(x.shape)}")
    if eps.shape != x.shape:
        raise ValueError(f"eps shape {tuple(eps.shape)} != x shape "
                         f"{tuple(x.shape)}")
    R = x.shape[0]
    if R == 0 or R % tile_rows(R):
        raise ValueError(f"R={R} must be a positive multiple of "
                         f"tile_rows(R)={tile_rows(R)}")
    if eps.device != x.device:
        raise ValueError(f"x on {x.device} but eps on {eps.device}")


def sampler_step_2d(x: torch.Tensor, eps: torch.Tensor, coefs,
                    seed: Optional[int] = None, *,
                    clip: Optional[float] = None,
                    stochastic: bool = False) -> torch.Tensor:
    """One Eq. 12 step over the (R, 256) tile view, scalar coefficients.

    Args:
      x, eps: (R, 256) contiguous float32/bfloat16/float16, each of its own
        type (widened as JAX's astype widens it), R % tile_rows(R) == 0.
      coefs: (5,) float32 host values [c_x0, c_dir, c_noise, sqrt_a_t,
        sqrt_1m_a_t] (numpy array, CPU tensor or sequence).  They are
        passed to the kernel by value, so no device copy is made per step.
      seed: int32 value; required iff stochastic.  Row tile i draws its
        stream from (seed, i).
      clip: |x0| bound or None.
      stochastic: False selects the specialization with no PRNG code.
    Returns x_prev, (R, 256) in x's dtype.
    """
    _check_state(x, eps)
    if stochastic and seed is None:
        raise ValueError("stochastic sampler_step needs a seed")
    c = np.asarray(coefs, np.float32).reshape(5)
    if x.device.type == "cpu":
        return ref.sampler_step_2d(x, eps, torch.from_numpy(c.copy()), seed,
                                   clip=clip, stochastic=stochastic)
    build.check_cuda(x, eps)
    out = torch.empty_like(x)
    R = x.shape[0]
    with torch.cuda.device(x.device):
        err = _lib().repro_sampler_step_2d(
            x.data_ptr(), eps.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[eps.dtype], R, tile_rows(R),
            *(float(v) for v in c), clip is not None,
            0.0 if clip is None else float(clip), bool(stochastic),
            int(np.int32(seed)) if stochastic else 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on(err, "sampler_step_2d")
    sampler_step_2d.launches += 1
    return out


sampler_step_2d.launches = 0


def sampler_step_rows_2d(x: torch.Tensor, eps: torch.Tensor,
                         row_coefs: torch.Tensor,
                         row_seeds: Optional[torch.Tensor] = None, *,
                         clip: Optional[float] = None,
                         stochastic: bool = False, want_x0: bool = False):
    """One Eq. 12 step where every ROW has its own coefficients and seed.

    Args:
      x, eps: (R, 256) contiguous float32/bfloat16/float16 (slot-tile
        layout), each of its own type.
      row_coefs: (R, 8) float32 on x's device: [c_x0, c_dir, c_noise,
        sqrt_a_t, sqrt_1m_a_t, pad...] (ops.expand_slot_coefs builds it).
      row_seeds: (R,) int32 on x's device; required iff stochastic.
      want_x0: also return the (clipped) predicted x0.
    Returns x_prev, or (x_prev, x0_hat) when want_x0.
    """
    _check_state(x, eps)
    R = x.shape[0]
    if (row_coefs.shape != (R, COEF_COLS) or row_coefs.dtype != torch.float32
            or not row_coefs.is_contiguous()
            or row_coefs.device != x.device):
        raise ValueError(f"row_coefs must be a contiguous ({R}, {COEF_COLS})"
                         f" float32 tensor on {x.device}")
    if stochastic:
        if row_seeds is None:
            raise ValueError("stochastic sampler_step_rows needs row_seeds")
        if (row_seeds.shape != (R,) or row_seeds.dtype != torch.int32
                or not row_seeds.is_contiguous()
                or row_seeds.device != x.device):
            raise ValueError(f"row_seeds must be a contiguous ({R},) int32 "
                             f"tensor on {x.device}")
    if x.device.type == "cpu":
        return ref.sampler_step_rows_2d(x, eps, row_coefs, row_seeds,
                                        clip=clip, stochastic=stochastic,
                                        want_x0=want_x0)
    build.check_cuda(x, eps, row_coefs)
    out = torch.empty_like(x)
    x0 = torch.empty_like(x) if want_x0 else None
    with torch.cuda.device(x.device):
        err = _lib().repro_sampler_step_rows_2d(
            x.data_ptr(), eps.data_ptr(), row_coefs.data_ptr(),
            row_seeds.data_ptr() if stochastic else None, out.data_ptr(),
            x0.data_ptr() if want_x0 else None,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[eps.dtype], R,
            clip is not None, 0.0 if clip is None else float(clip),
            bool(stochastic), bool(want_x0),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on(err, "sampler_step_rows_2d")
    sampler_step_rows_2d.launches += 1
    return (out, x0) if want_x0 else out


sampler_step_rows_2d.launches = 0
