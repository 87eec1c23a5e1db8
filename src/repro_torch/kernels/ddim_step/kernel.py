"""Wrapper of the CUDA legacy DDIM-update kernel (``csrc/ddim_step.cu``).

Port of ``ddim_step_2d`` in ``repro/kernels/ddim_step/kernel.py`` (B7):
out = a x + b eps + c_noise noise over an (R, C) view, with a = c_x0 /
sqrt_a_t and b = c_dir - a sqrt_1m_a_t, the coefficients cast to x's dtype
first.  The wrapper checks its inputs, allocates the output with
``torch.empty``, launches on PyTorch's current stream and counts the
launch in ``ddim_step_2d.launches``.  On tensors that lie on the CPU it
runs the plain version (``ref.ddim_step_body``) and counts nothing; on a
CUDA tensor it launches or raises.

A float32 x also takes eps and noise of bfloat16 or float16 (JAX
promotes them to float32); the kernel reads each at its own type.  A
16-bit x takes operands of its own type only, as JAX's kernel does.

Unlike the JAX grid of R // 256 by C // 256 tiles, which silently leaves
a remainder unwritten, the wrapper refuses R or C that is not a multiple
of 256.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from . import ref

TILE_R = 256
TILE_C = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ddim_step")
    lib.repro_ddim_step_2d.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                       ctypes.c_longlong, _F, _F, _F, _F, _F,
                                       _P]
    lib.repro_ddim_step_2d.restype = _I
    return lib


def ddim_step_2d(x: torch.Tensor, eps: torch.Tensor, noise: torch.Tensor,
                 coefs: torch.Tensor) -> torch.Tensor:
    """x, eps, noise: (R, C), R % 256 == C % 256 == 0, of one dtype, or x
    float32 over eps and noise of any of the three; coefs: (5,) [c_x0,
    c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t].  Returns (R, C) in x's
    dtype."""
    if x.dim() != 2 or eps.shape != x.shape or noise.shape != x.shape:
        raise ValueError(f"x, eps and noise must be one (R, C) shape, got "
                         f"{tuple(x.shape)}, {tuple(eps.shape)} and "
                         f"{tuple(noise.shape)}")
    R, C = x.shape
    if R == 0 or C == 0 or R % TILE_R or C % TILE_C:
        raise ValueError(f"(R, C) = ({R}, {C}) must be positive multiples "
                         f"of ({TILE_R}, {TILE_C})")
    if tuple(coefs.shape) != (5,):
        raise ValueError(f"coefs must be (5,), got {tuple(coefs.shape)}")
    if x.device.type == "cpu":
        return ref.ddim_step_body(x, eps, noise, coefs)
    mixed = eps.dtype != x.dtype or noise.dtype != x.dtype
    if (x.dtype not in _DTYPE_CODES or eps.dtype not in _DTYPE_CODES
            or noise.dtype not in _DTYPE_CODES
            or (mixed and x.dtype != torch.float32)):
        raise TypeError(f"x, eps and noise must share float32, bfloat16 or "
                        f"float16, or x be float32 over any of them, got "
                        f"{x.dtype}, {eps.dtype} and {noise.dtype}")
    if not (x.is_contiguous() and eps.is_contiguous()
            and noise.is_contiguous()):
        raise ValueError("x, eps and noise must be contiguous")
    build.check_cuda(x, eps, noise)
    # the cast to x's dtype, then exact float32 values for the launcher
    c = [float(v) for v in coefs.to(x.dtype).float().cpu()]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().repro_ddim_step_2d(
            x.data_ptr(), eps.data_ptr(), noise.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[eps.dtype],
            _DTYPE_CODES[noise.dtype], x.numel(), *c,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on(err, "ddim_step_2d")
    ddim_step_2d.launches += 1
    return out


ddim_step_2d.launches = 0
