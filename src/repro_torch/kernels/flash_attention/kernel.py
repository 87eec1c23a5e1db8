"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Port of ``flash_attention`` in ``repro/kernels/flash_attention/kernel.py``.
It checks its inputs, allocates the output with ``torch.empty``, launches
on PyTorch's current stream and counts the launch in
``flash_attention.launches``.  On tensors that lie on the CPU it runs the
plain version (``ref.flash_attention_ref``) and counts nothing; on a CUDA
tensor it launches or raises.  The kernel takes head dim 64 and block
sizes 64 or 128.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

from . import ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
KERNEL_HEAD_DIM = 64
KERNEL_BLOCKS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.repro_flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _I, _F, _P]
    lib.repro_flash_attention.restype = _I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q, k, v: (BH, S, D) flattened batch*heads. Returns (BH, S, D)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, D = q.shape
    block_q, block_k = min(block_q, S), min(block_k, S)
    if S % block_q or S % block_k:
        raise ValueError(f"S={S} must be a multiple of the blocks "
                         f"({block_q}, {block_k})")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       block_k=block_k)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("q, k, v must share float32 or bfloat16")
    if D != KERNEL_HEAD_DIM or block_q not in KERNEL_BLOCKS \
            or block_k not in KERNEL_BLOCKS:
        raise ValueError(f"the CUDA kernel takes D={KERNEL_HEAD_DIM} and "
                         f"blocks in {KERNEL_BLOCKS}; got D={D}, blocks "
                         f"({block_q}, {block_k})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    build.check_cuda(q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], BH, S, D, block_q, block_k, bool(causal),
            1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
