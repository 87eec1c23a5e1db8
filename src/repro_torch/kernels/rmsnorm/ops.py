"""Any leading shape -> the row-tiled RMSNorm kernel (port of
``repro/kernels/rmsnorm/ops.py``): rows are flattened and zero-padded to a
multiple of ``min(TILE_R, R)``, as the JAX wrapper pads for its grid."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import TILE_R, rms_norm_2d


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    d = x.shape[-1]
    lead = x.shape[:-1]
    R = 1
    for s in lead:
        R *= s
    x2 = x.reshape(R, d)
    pad = (-R) % min(TILE_R, max(R, 1))
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    out = rms_norm_2d(x2.contiguous(), scale, eps=eps)
    return out[:R].reshape(*lead, d)
