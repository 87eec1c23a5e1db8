"""Latent-space interpolation (paper §5.3, Appendix D.5); port of
``repro/core/interpolate.py``.  Runs in the latents' dtype on their
device."""
from __future__ import annotations

import torch


def slerp(x0: torch.Tensor, x1: torch.Tensor, alpha,
          eps: float = 1e-7) -> torch.Tensor:
    """Spherical linear interpolation (Shoemake 1985; paper Eq. 67).

    x0, x1: latents of identical shape. alpha: scalar or (K,) coefficients.
    Returns (K, *x.shape) (or x.shape for scalar alpha).
    """
    flat0 = x0.reshape(-1)
    flat1 = x1.reshape(-1)
    cos = torch.clamp(torch.dot(flat0, flat1)
                      / (torch.linalg.norm(flat0) * torch.linalg.norm(flat1)
                         + eps), -1.0 + eps, 1.0 - eps)
    theta = torch.arccos(cos)
    alpha = torch.as_tensor(alpha, dtype=x0.dtype, device=x0.device)
    scalar = alpha.dim() == 0
    a = alpha.reshape(-1, *([1] * x0.dim()))
    out = (torch.sin((1.0 - a) * theta) * x0[None]
           + torch.sin(a * theta) * x1[None]) / torch.sin(theta)
    return out[0] if scalar else out


def slerp_grid(corners: torch.Tensor, n: int) -> torch.Tensor:
    """Grid interpolation from four corner latents (paper App. D.5).

    corners: (4, *shape) -> returns (n, n, *shape); rows interpolate the two
    corner pairs, columns interpolate across the interpolated rows.
    """
    alphas = torch.linspace(0.0, 1.0, n, dtype=corners.dtype,
                            device=corners.device)
    top = slerp(corners[0], corners[1], alphas)       # (n, ...)
    bot = slerp(corners[2], corners[3], alphas)       # (n, ...)
    rows = [slerp(top[i], bot[i], alphas) for i in range(n)]
    return torch.stack(rows, dim=1)                   # (n_col, n_row, ...)
