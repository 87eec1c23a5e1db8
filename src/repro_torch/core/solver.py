"""Adams–Bashforth multistep machinery (port of ``repro/core/solver.py``).

The plan compiler bakes the Euler warm-up into a per-step weight matrix,
and every backend combines the eps history with the one ``mix_history``.
"""
from __future__ import annotations

import numpy as np
import torch

# Adams–Bashforth weights by effective order; row h = the order-(h+1) method
AB_COEFS = (
    (1.0,),
    (1.5, -0.5),
    (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0),
    (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
)
MAX_ORDER = len(AB_COEFS)


def warmup_weights(S: int, order: int) -> np.ndarray:
    """(S, order) float64 AB weights; step k uses at most k+1 entries."""
    w = np.zeros((S, order), np.float64)
    for k in range(S):
        row = AB_COEFS[min(k + 1, order) - 1]
        w[k, :len(row)] = row
    return w


def mix_history(eps32: torch.Tensor, hist, w, order: int):
    """The AB combine: (effective eps, updated history).

    ``w`` is the step's (order,) float32 weight row (warm-up zeros
    included); ``hist`` holds the previous order-1 eps evaluations, newest
    first, as an (order-1, ...) float32 tensor (None when order == 1).
    """
    if order == 1:
        return eps32, hist
    eff = w[0] * eps32
    for j in range(1, order):
        eff = eff + w[j] * hist[j - 1]
    new_hist = (torch.cat([eps32[None], hist[:-1]], dim=0)
                if order > 2 else eps32[None])
    return eff, new_hist
