"""Noise schedules (port of ``repro/core/schedules.py``).

``alpha_bar[t]`` is the cumulative product on a grid of T+1 points with
``alpha_bar[0] == 1`` (DDIM paper, below Eq. 12).  It is computed in
float64 numpy and stored once as float32, as the JAX package does, so the
two packages hold the same bytes — and therefore the same schedule digest
and the same compiled coefficient tables.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

ScheduleKind = Literal["linear", "cosine", "scaled_linear"]


@dataclasses.dataclass(frozen=True, eq=False)
class NoiseSchedule:
    """Immutable discrete noise schedule.

    Attributes:
      alpha_bar: (T+1,) float32 CPU tensor, alpha_bar[0] = 1, decreasing.
      T: number of diffusion steps.
      kind: schedule family used to construct it.
    """

    alpha_bar: torch.Tensor
    T: int
    kind: str


def make_schedule(kind: ScheduleKind = "linear", T: int = 1000,
                  beta_start: float = 1e-4,
                  beta_end: float = 2e-2) -> NoiseSchedule:
    """Build a NoiseSchedule (``linear`` is the paper's Ho et al. choice)."""
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if kind == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif kind == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
    elif kind == "cosine":
        s = 0.008
        steps = np.arange(T + 1, dtype=np.float64) / T
        f = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
        ab = f / f[0]
        betas = np.clip(1.0 - ab[1:] / ab[:-1], 0.0, 0.999)
    else:
        raise ValueError(f"unknown schedule kind: {kind}")
    alpha_bar = np.concatenate([[1.0], np.cumprod(1.0 - betas)])
    return NoiseSchedule(
        alpha_bar=torch.from_numpy(alpha_bar.astype(np.float32)), T=T,
        kind=kind)


def make_tau(T: int, S: int,
             kind: Literal["linear", "quadratic"] = "linear") -> np.ndarray:
    """Sampling sub-sequence tau (paper §4.2 / Appendix D.2).

    Returns an increasing int64 array of S timesteps in [1, T]:
    ``floor(c * i)`` (linear) or ``floor(c * i^2)`` (quadratic), with c
    chosen so tau_{-1} is close to T.
    """
    if not 1 <= S <= T:
        raise ValueError(f"need 1 <= S <= T, got S={S} T={T}")
    i = np.arange(1, S + 1, dtype=np.float64)
    if kind == "linear":
        tau = np.floor(T / S * i)
    elif kind == "quadratic":
        tau = np.floor(T / (S ** 2) * i * i)
    else:
        raise ValueError(f"unknown tau kind: {kind}")
    tau = np.unique(np.clip(tau.astype(np.int64), 1, T))
    # de-duplication may shorten the trajectory for extreme (S, kind)
    # combos; pad from the missing low timesteps to preserve length S
    if len(tau) < S:
        missing = np.setdiff1d(np.arange(1, T + 1), tau)
        tau = np.sort(np.concatenate([tau, missing[: S - len(tau)]]))
    return tau
