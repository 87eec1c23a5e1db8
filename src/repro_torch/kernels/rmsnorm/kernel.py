"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Port of ``rms_norm_2d`` in ``repro/kernels/rmsnorm/kernel.py``.  It checks
its inputs, allocates the output with ``torch.empty``, launches on
PyTorch's current stream and counts the launch in ``rms_norm_2d.launches``;
``rms_norm_2d.last_plan`` holds the launch plan of its latest launch
(blocks, threads, rows per block, vector or scalar row path, shared bytes,
blocks per SM, the long-row kernel or the one-pass one).  On tensors that
lie on the CPU it runs the plain version (``ref.py``) and counts nothing;
on a CUDA tensor it launches or raises.  It takes every row width d: rows
past what 8 warps hold in registers (d > 8,192 float32, 16,384 bfloat16
or float16) run the long-row kernel, which reads each row twice.  A
float32 x over a bfloat16 or float16 scale (JAX promotes the product to
float32) takes the scale widened to float32, exactly; a 16-bit x takes a
scale of its own type only, as JAX's kernel does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from . import ref

TILE_R = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the fields of repro_rms_norm_2d's plan[6], in order
_PLAN = ("grid", "threads", "rows_per_block", "vector", "smem_bytes",
         "blocks_per_sm", "long_rows")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    lib.repro_rms_norm_2d.argtypes = [_P, _P, _P, _I, _I, _I, _F, _P,
                                      _P]
    lib.repro_rms_norm_2d.restype = _I
    return lib


def rms_norm_2d(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (R, d) with R % min(TILE_R, R) == 0 (ops.rms_norm pads);
    scale: (d,) of x's dtype, or of any of the three if x is float32.
    Returns (R, d) in x's dtype."""
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"x must be (R, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    R = x.shape[0]
    if R == 0 or R % min(TILE_R, R):
        raise ValueError(f"R={R} must be a positive multiple of "
                         f"min({TILE_R}, R)")
    if x.device.type == "cpu":
        return ref.rms_norm_body(x, scale, eps)
    if (x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES
            or (scale.dtype != x.dtype and x.dtype != torch.float32)):
        raise TypeError(f"x and scale must share float32, bfloat16 or "
                        f"float16, or x be float32 over any of them, got "
                        f"{x.dtype} and {scale.dtype}")
    if scale.dtype != x.dtype:
        scale = scale.float()      # exact: the product is float32 in JAX
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    build.check_cuda(x, scale, aligned=False)  # unaligned: scalar path
    out = torch.empty_like(x)
    plan = (ctypes.c_int * len(_PLAN))()
    with torch.cuda.device(x.device):
        err = _lib().repro_rms_norm_2d(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], R, x.shape[1], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream, plan)
    build.raise_on(err, "rms_norm_2d")
    rms_norm_2d.launches += 1
    rms_norm_2d.last_plan = dict(zip(_PLAN, plan))
    return out


rms_norm_2d.launches = 0
rms_norm_2d.last_plan = None
