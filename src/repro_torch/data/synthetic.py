"""Deterministic synthetic data pipelines (port of
``repro/data/synthetic.py``).

Three generators with real structure, so sample-quality metrics mean
something:

* GaussianMixture2D — an 8-mode ring mixture with exact mode assignments.
* SyntheticImages — smooth random "textures": per-image low-frequency
  Fourier fields plus a bright blob, squashed to [-1, 1] by tanh; NHWC,
  the layout the port's U-Net takes.
* SyntheticTokens — a Markov chain over the vocabulary (a fixed sparse
  transition table from numpy's ``RandomState``).

Every batch is a pure function of (seed, index): the draws are
``repro_torch.prng``'s threefry, so a key gives the JAX package's random
numbers, and each sample runs where its key lies (``batches`` puts the
keys on ``device``, the card unless named).  The token chain is bitwise
JAX's; the float images and mixtures follow JAX's op order in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class GaussianMixture2D:
    n_modes: int = 8
    radius: float = 4.0
    scale: float = 0.3
    seed: int = 0

    def modes(self) -> np.ndarray:
        ang = 2 * np.pi * np.arange(self.n_modes) / self.n_modes
        return self.radius * np.stack([np.cos(ang), np.sin(ang)], axis=1)

    def sample(self, rng: torch.Tensor, n: int) -> torch.Tensor:
        k1, k2 = prng.split(rng)
        idx = prng.randint(k1, (n,), 0, self.n_modes)
        centers = torch.from_numpy(self.modes().astype(np.float32)).to(
            rng.device)[idx.long()]
        return centers + self.scale * prng.normal(k2, (n, 2))

    def batches(self, batch: int,
                device: DeviceLike = None) -> Iterator[torch.Tensor]:
        i = 0
        while True:
            yield self.sample(prng.PRNGKey(self.seed * 100003 + i, device),
                              batch)
            i += 1

    def mode_assignment(self, x: np.ndarray) -> np.ndarray:
        d = np.linalg.norm(x[:, None, :] - self.modes()[None], axis=-1)
        return d.argmin(axis=1)


@dataclasses.dataclass(frozen=True)
class SyntheticImages:
    size: int = 16
    channels: int = 3
    n_freqs: int = 4
    seed: int = 0

    def sample(self, rng: torch.Tensor, n: int) -> torch.Tensor:
        """(n, size, size, channels) float32 in [-1, 1]."""
        ks = prng.split(rng, 4)
        F, S, C = self.n_freqs, self.size, self.channels
        dev = rng.device
        f = torch.arange(F, device=dev)
        amp = prng.normal(ks[0], (n, F, F, C)) / (
            1.0 + f[None, :, None, None] + f[None, None, :, None])
        phase = prng.uniform(ks[1], (n, F, F, C)) * 2 * math.pi
        xx = torch.arange(S, device=dev).float() / float(S)
        field = torch.zeros((n, S, S, C), device=dev)
        for fy in range(F):
            for fx in range(F):
                wave = torch.cos(2 * math.pi * (fy * xx[:, None]
                                                + fx * xx[None, :]))
                field = field + (amp[:, fy, fx, None, None, :]
                                 * wave[None, :, :, None]
                                 + 0 * phase[:, fy, fx, None, None, :])
        # bright blob at a random location (a localized feature)
        cy = prng.uniform(ks[2], (n, 1, 1, 1))
        cx = prng.uniform(ks[3], (n, 1, 1, 1))
        gy = xx[None, :, None, None] - cy
        gx = xx[None, None, :, None] - cx
        blob = torch.exp(-((gy ** 2 + gx ** 2) / 0.02))
        return torch.tanh(field + blob)

    def batches(self, batch: int,
                device: DeviceLike = None) -> Iterator[torch.Tensor]:
        i = 0
        while True:
            yield self.sample(prng.PRNGKey(self.seed * 99991 + i, device),
                              batch)
            i += 1


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int = 256
    branching: int = 4       # successors per token
    seed: int = 0

    def _table(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        return rng.randint(0, self.vocab, size=(self.vocab, self.branching))

    def sample(self, rng: torch.Tensor, batch: int, seq: int) -> torch.Tensor:
        """(batch, seq) int32 token sequences: a uniform first token, then
        each next token a uniform choice among the chain's successors."""
        table = torch.from_numpy(self._table().astype(np.int64)).to(
            rng.device)
        k0, k1 = prng.split(rng)
        tok = prng.randint(k0, (batch,), 0, self.vocab).long()
        choices = prng.randint(k1, (batch, seq - 1), 0,
                               self.branching).long()
        out = [tok]
        for j in range(seq - 1):
            tok = table[tok, choices[:, j]]
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32)

    def batches(self, batch: int, seq: int,
                device: DeviceLike = None) -> Iterator[torch.Tensor]:
        i = 0
        while True:
            yield self.sample(prng.PRNGKey(self.seed * 7919 + i, device),
                              batch, seq)
            i += 1

    def bigram_validity(self, tokens: np.ndarray) -> float:
        """Fraction of adjacent pairs that are valid chain transitions."""
        table = self._table()
        valid = 0
        total = 0
        for row in np.asarray(tokens):
            for a, b in zip(row[:-1], row[1:]):
                valid += int(b in table[a])
                total += 1
        return valid / max(total, 1)


def make_image_pipeline(size: int, batch: int, seed: int = 0,
                        device: DeviceLike = None):
    return SyntheticImages(size=size, seed=seed).batches(batch, device)


def make_token_pipeline(vocab: int, batch: int, seq: int, seed: int = 0,
                        device: DeviceLike = None):
    return SyntheticTokens(vocab=vocab, seed=seed).batches(batch, seq,
                                                           device)
