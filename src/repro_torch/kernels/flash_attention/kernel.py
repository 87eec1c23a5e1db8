"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Port of ``flash_attention`` in ``repro/kernels/flash_attention/kernel.py``.
It checks its inputs (the block sizes as the JAX wrapper checks them),
allocates the output with ``torch.empty``, launches on PyTorch's current
stream and counts the launch in ``flash_attention.launches``;
``flash_attention.last_plan`` holds the launch plan of its latest launch
(grid, threads, shared bytes, blocks per SM, KV tile rows, the warps
that split the KV columns of 16 query rows, the head width, the ring's
stages and the staging flags).  On tensors that lie on the CPU it runs
the plain version (``ref.flash_attention_ref``) and counts nothing; on a
CUDA tensor it launches or raises.  The kernel tiles for the card
whatever blocks the caller passes.  It takes every S the block check
admits and every head dim: up to 256 at the least width of
``ref.HEAD_WIDTHS`` that holds it (the widths up to 128 and those past it
are two libraries per dtype, ``csrc/flash_attention{,_bf16,_f16}{,_wide}
.cu``), past 256 in the XL kernel (``csrc/flash_xl.cuh``, a library per
dtype, ``*_xl.cu``), which streams the scores over the depth and writes
the output in slices of 256 columns.  q, k and v of different float types
(JAX casts every operand to float32 and the output to q's type) are
widened to float32, exactly, for the float32 library, and its output is
rounded once to q's type; ``last_plan["widened"]`` says so.
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
# the fields of repro_flash_attention's plan[10], in order (last_plan adds
# "slices", the XL kernel's output slices, and "widened")
_PLAN = ("grid_x", "grid_y", "threads", "smem_bytes", "blocks_per_sm",
         "kv_tile", "kv_split", "head_width", "stages", "flags")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the library name's suffix by dtype
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_f16"}


def library_name(dtype: torch.dtype, width: int) -> str:
    """The library (``csrc/<name>.cu``) that holds ``width`` in ``dtype``."""
    return ("flash_attention" + _SUFFIX[dtype]
            + ("_xl" if width > ref.MAX_HEAD_DIM
               else "_wide" if width > 128 else ""))


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    lib.repro_flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                          _F, _P, _P]
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
    if any(t.dtype not in _SUFFIX for t in (q, k, v)):
        raise TypeError(f"q, k, v must be float32, bfloat16 or float16, "
                        f"got {q.dtype}, {k.dtype} and {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    build.check_cuda(q, k, v, aligned=False)
    out_dtype = q.dtype
    widened = not q.dtype == k.dtype == v.dtype
    if widened:   # as JAX: every operand in float32, the output in q's type
        q, k, v = (t.float() for t in (q, k, v))
    out = torch.empty_like(q)
    plan = (ctypes.c_int * len(_PLAN))()
    lib = _lib(library_name(q.dtype, ref.kernel_head_width(D)))
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S,
            D, bool(causal), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream, plan)
    build.raise_on(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.last_plan = dict(zip(_PLAN, plan),
                                     slices=ref.kernel_slices(D),
                                     widened=widened)
    return out.to(out_dtype) if widened else out


flash_attention.launches = 0
flash_attention.last_plan = None
