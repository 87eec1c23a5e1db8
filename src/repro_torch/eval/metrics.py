"""Sample-quality metrics (offline substitutes for FID); port of
``repro/eval/metrics.py``.

The paper scores with FID, which needs a pretrained Inception network — not
available offline.  Two substitutes keep the *ranking* behaviour Table 1
relies on (sensitive to both mode coverage and noise perturbations, the
failure mode of sigma-hat at small S):

  * kernel MMD (RBF, multi-bandwidth) between sample sets;
  * a Frechet distance between Gaussian fits of hand-crafted image features
    ("FID-proxy": channel stats + gradient magnitudes + 4x4 thumbnail).

``mmd_rbf`` and ``image_features`` take tensors and compute on their
device, in float32.  ``frechet_proxy``, ``mode_coverage`` and the float64
part of ``high_level_similarity`` are numpy / scipy on the host, as in the
JAX package.  Three places where the PyTorch spelling differs from a
literal translation, so that both packages compute the same function:
the median averages the two middle values of an even count (``torch.median``
returns the lower one), std is the population std (correction 0), and the
4x4 thumbnail resize antialiases when it downsamples (``jax.image.resize``
with "linear" does).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = torch.sum(x * x, -1)[:, None]
    y2 = torch.sum(y * y, -1)[None, :]
    return x2 + y2 - 2 * x @ y.T


def _median(a: torch.Tensor) -> torch.Tensor:
    """Median of all elements; an even count averages the two middle
    values (``jnp.median``'s midpoint rule)."""
    v = torch.sort(a.reshape(-1)).values
    n = v.numel()
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


def mmd_rbf(x: torch.Tensor, y: torch.Tensor,
            sigmas: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0)) -> float:
    """Unbiased multi-bandwidth RBF MMD^2 between flattened sample sets."""
    x = x.reshape(x.shape[0], -1).to(torch.float32)
    y = y.reshape(y.shape[0], -1).to(torch.float32)
    # median-heuristic scaling keeps bandwidths meaningful across datasets
    med = _median(_sq_dists(x[:128], x[:128]))
    total = 0.0
    for s in sigmas:
        gamma = 1.0 / (s * torch.clamp(med, min=1e-6))
        kxx = torch.exp(-gamma * _sq_dists(x, x))
        kyy = torch.exp(-gamma * _sq_dists(y, y))
        kxy = torch.exp(-gamma * _sq_dists(x, y))
        n, m = x.shape[0], y.shape[0]
        exx = (kxx.sum() - torch.trace(kxx)) / (n * (n - 1))
        eyy = (kyy.sum() - torch.trace(kyy)) / (m * (m - 1))
        total += exx + eyy - 2 * kxy.mean()
    return float(total)


def _thumbnail(imgs: torch.Tensor, size: int = 4) -> torch.Tensor:
    """(N, H, W, C) -> (N, size, size, C) linear resize that antialiases
    when it downsamples (``jax.image.resize(..., "linear")``)."""
    nchw = imgs.permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(size, size), mode="bilinear",
                        antialias=True, align_corners=False)
    return out.permute(0, 2, 3, 1)


def image_features(imgs: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) -> (N,F) hand-crafted features for the FID-proxy."""
    imgs = imgs.to(torch.float32)
    N = imgs.shape[0]
    mean_c = imgs.mean(dim=(1, 2))
    std_c = imgs.std(dim=(1, 2), correction=0)
    gy = torch.abs(torch.diff(imgs, dim=1)).mean(dim=(1, 2))
    gx = torch.abs(torch.diff(imgs, dim=2)).mean(dim=(1, 2))
    thumb = _thumbnail(imgs).reshape(N, -1)
    return torch.cat([mean_c, std_c, gy, gx, thumb], dim=-1)


def frechet_proxy(fx: np.ndarray, fy: np.ndarray) -> float:
    """Frechet distance between Gaussian fits of two feature sets."""
    fx = np.asarray(_host(fx), np.float64)
    fy = np.asarray(_host(fy), np.float64)
    mu1, mu2 = fx.mean(0), fy.mean(0)
    c1 = np.cov(fx, rowvar=False) + 1e-6 * np.eye(fx.shape[1])
    c2 = np.cov(fy, rowvar=False) + 1e-6 * np.eye(fy.shape[1])
    covmean = scipy.linalg.sqrtm(c1 @ c2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(((mu1 - mu2) ** 2).sum()
                 + np.trace(c1 + c2 - 2 * covmean))


def fid_proxy(samples: torch.Tensor, reference: torch.Tensor) -> float:
    """FID-proxy between two image sets (lower is better)."""
    return frechet_proxy(_host(image_features(samples)),
                         _host(image_features(reference)))


def mode_coverage(samples: np.ndarray, modes: np.ndarray,
                  thresh: float = 1.0) -> Tuple[int, float]:
    """For the 2D GMM: (#modes hit, fraction of samples within thresh of a
    mode — a precision measure)."""
    samples, modes = _host(samples), _host(modes)
    d = np.linalg.norm(samples[:, None, :] - modes[None], axis=-1)
    nearest = d.min(axis=1)
    assign = d.argmin(axis=1)
    hit = np.unique(assign[nearest < thresh])
    return int(len(hit)), float((nearest < thresh).mean())


def high_level_similarity(a: torch.Tensor, b: torch.Tensor) -> float:
    """Feature-space cosine similarity between paired sample sets (used for
    the paper's §5.2 consistency claim: same x_T, different S)."""
    fa = np.asarray(_host(image_features(a)), np.float64)
    fb = np.asarray(_host(image_features(b)), np.float64)
    fa = (fa - fa.mean(0)) / (fa.std(0) + 1e-8)
    fb = (fb - fb.mean(0)) / (fb.std(0) + 1e-8)
    num = (fa * fb).sum(-1)
    den = np.linalg.norm(fa, axis=-1) * np.linalg.norm(fb, axis=-1) + 1e-12
    return float((num / den).mean())
