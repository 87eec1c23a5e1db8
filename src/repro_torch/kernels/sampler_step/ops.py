"""The tile-layout contract around the sampler-step kernels.

Port of ``repro/kernels/sampler_step/ops.py``.

  * ``to_tile_layout(a) -> (a2, n)`` flattens ``a`` (in its own element
    order — NHWC for images) and zero-pads it into an (R, TILE_C) tensor,
    R a multiple of TILE_R when at least one full tile of data exists,
    else of the 8-row granule; ``n = a.numel()``.  Padding lanes are
    garbage, never read back.  The in-kernel noise is keyed on the flat
    position, so the element order is part of the stochastic stream.
  * ``to_slot_tile_layout(x) -> (x2, n)`` lays a (B, *shape) batch out as
    (B * slot_rows(shape), TILE_C), each slot padded to its own whole-row
    granule, so every row belongs to exactly one slot (the per-row kernel's
    layout).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import kernel
from .ref import (COEF_COLS, MASK32, SUBLANE, TILE_C, TILE_R, fmix32,
                  tile_rows)

__all__ = ["COEF_COLS", "SUBLANE", "TILE_C", "TILE_R", "tile_rows",
           "to_tile_layout", "from_tile_layout", "slot_rows",
           "to_slot_tile_layout", "from_slot_tile_layout",
           "expand_slot_coefs", "derive_row_seeds", "sampler_step_tiles",
           "sampler_step_rows"]


def to_tile_layout(a: torch.Tensor):
    """Flatten + zero-pad into the (R, TILE_C) tile view. Returns (view, n).
    """
    n = a.numel()
    R = -(-n // TILE_C)
    granule = TILE_R if R >= TILE_R else SUBLANE
    R_pad = -(-R // granule) * granule
    flat = a.reshape(-1)
    pad = R_pad * TILE_C - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(R_pad, TILE_C), n


def from_tile_layout(a2: torch.Tensor, n: int, shape) -> torch.Tensor:
    """Restore the natural-shape view from the (R, C) tile layout."""
    if a2.numel() == n:
        return a2.reshape(shape)
    return a2.reshape(-1)[:n].reshape(shape)


def slot_rows(sample_shape) -> int:
    """Rows one slot occupies in the slot-tile layout (8-row granule)."""
    n = int(np.prod(sample_shape))
    r = -(-n // TILE_C)
    return -(-r // SUBLANE) * SUBLANE


def to_slot_tile_layout(x: torch.Tensor):
    """(B, *shape) slot batch -> ((B * slot_rows, TILE_C) view, n)."""
    B, shape = x.shape[0], x.shape[1:]
    n = int(np.prod(shape))
    rps = slot_rows(shape)
    flat = x.reshape(B, n)
    pad = rps * TILE_C - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(B * rps, TILE_C), n


def from_slot_tile_layout(x2: torch.Tensor, n: int, batch_shape):
    """Restore the natural (B, *shape) view from the slot-tile layout."""
    flat = x2.reshape(batch_shape[0], -1)
    if flat.shape[1] != n:
        flat = flat[:, :n]
    return flat.reshape(batch_shape)


def expand_slot_coefs(slot_coefs: torch.Tensor, rows_per_slot: int):
    """(B, 5) per-slot Eq. 12 coefficients -> (B*rows, COEF_COLS) per-row."""
    c = torch.as_tensor(slot_coefs, dtype=torch.float32)
    c = F.pad(c, (0, COEF_COLS - c.shape[1]))
    return c.repeat_interleave(rows_per_slot, dim=0)


def derive_row_seeds(slot_seeds: torch.Tensor, rows_per_slot: int):
    """(B,) per-slot int32 tick seeds -> (B*rows,) int32 per-row seeds.

    Stream identity is (slot seed, row-within-slot), full-avalanche mixed:
    fmix32(seed ^ r * 0x9E3779B9), reinterpreted as int32.
    """
    s = torch.as_tensor(slot_seeds).to(torch.int64) & MASK32
    r = torch.arange(rows_per_slot, dtype=torch.int64, device=s.device)
    h = fmix32(s[:, None] ^ ((r * 0x9E3779B9) & MASK32)[None, :])
    h = torch.where(h >= 2 ** 31, h - 2 ** 32, h)
    return h.reshape(-1).to(torch.int32)


def sampler_step_tiles(x2, eps2, coefs, seed=None, *, clip=None,
                       stochastic: bool = False) -> torch.Tensor:
    """Loop-body entry: (R, C) in -> (R, C) out, zero layout conversions."""
    return kernel.sampler_step_2d(x2, eps2, coefs, seed, clip=clip,
                                  stochastic=stochastic)


def sampler_step_rows(x2, eps2, row_coefs, row_seeds=None, *, clip=None,
                      stochastic: bool = False, want_x0: bool = False):
    """Scheduler-tick entry: per-row coefficients, (R, C) in -> (R, C) out
    (plus the x0 preview when want_x0), zero layout conversions."""
    return kernel.sampler_step_rows_2d(x2, eps2, row_coefs, row_seeds,
                                       clip=clip, stochastic=stochastic,
                                       want_x0=want_x0)
