"""Composable specs for the declarative sampler front door.

Port of ``repro/sampling/specs.py``, kept as this package's own copy (that
module imports only numpy, but the port imports nothing of ``repro``).

  * :class:`TauSpec`   — which timesteps the trajectory visits (uniform,
    quadratic, or an explicit strictly-increasing subsequence).
  * :class:`SigmaSpec` — how much stochasticity each step injects (scalar
    eta, a per-step eta schedule, or explicit sigmas; paper Eq. 16).
  * :class:`X0Policy`  — what to do with the predicted x0 before the jump.

All specs are frozen dataclasses with tuple payloads, so plans hash.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TauSpec:
    """Trajectory sub-sequence spec (paper §4.2 / App. D.2).

    kind:
      'uniform'    tau_i = floor(T/S * i)            (the paper's "linear")
      'quadratic'  tau_i = floor(T/S^2 * i^2)        (CIFAR10 in the paper)
      'explicit'   ``taus`` verbatim — any strictly increasing subsequence
                   of [1, T]; the carrier for learned/nonuniform budgets.
    """

    kind: str = "uniform"
    S: Optional[int] = None
    taus: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.kind in ("uniform", "linear", "quadratic"):
            if self.kind == "linear":       # accept the legacy spelling
                object.__setattr__(self, "kind", "uniform")
            if self.S is None or self.S < 1:
                raise ValueError(f"TauSpec('{self.kind}') needs S >= 1")
            if self.taus is not None:
                raise ValueError("taus is only valid with kind='explicit'")
        elif self.kind == "explicit":
            if not self.taus:
                raise ValueError("TauSpec('explicit') needs a non-empty taus")
            taus = tuple(self.taus)
            for k, t in enumerate(taus):
                # integral values only — silently truncating 5.7 -> 5 (or
                # coercing bool/NaN) used to surface downstream as a subtly
                # wrong coefficient table; the DP search builds thousands
                # of these, so bad values must fail HERE, by index.  Any
                # integral-valued number (python int, numpy/jax int or
                # float scalar out of e.g. floor arithmetic) is accepted.
                bad = (isinstance(t, (bool, np.bool_))
                       or getattr(t, "dtype", None) == np.bool_)
                if not bad:
                    try:
                        bad = int(t) != t      # NaN/inf raise, 5.7 != 5
                    except (TypeError, ValueError, OverflowError):
                        bad = True
                if bad:
                    raise ValueError(
                        f"explicit taus must be integer timesteps; "
                        f"taus[{k}] = {t!r} is not an integer")
            taus = tuple(int(t) for t in taus)
            for k, (a, b) in enumerate(zip(taus, taus[1:])):
                if b <= a:
                    raise ValueError(
                        f"explicit taus must be strictly increasing; "
                        f"taus[{k}] = {a} >= taus[{k + 1}] = {b}"
                        + (" (duplicate timestep)" if b == a else ""))
            if taus[0] < 1:
                raise ValueError(f"explicit taus must start >= 1 (the model "
                                 f"grid begins at t=1), got taus[0] = "
                                 f"{taus[0]}")
            object.__setattr__(self, "taus", taus)
            object.__setattr__(self, "S", len(taus))
        else:
            raise ValueError(f"unknown tau kind: {self.kind!r}")

    # ------------------------------------------------------------ builders
    @classmethod
    def uniform(cls, S: int) -> "TauSpec":
        return cls(kind="uniform", S=S)

    @classmethod
    def quadratic(cls, S: int) -> "TauSpec":
        return cls(kind="quadratic", S=S)

    @classmethod
    def explicit(cls, taus: Sequence[int],
                 T: Optional[int] = None) -> "TauSpec":
        """An arbitrary (e.g. learned) strictly-increasing subsequence.

        ``T`` (optional) validates the upper bound at CONSTRUCTION time —
        callers that know the target schedule (e.g. the DP search) get the
        out-of-range error immediately instead of at plan compilation.
        ``T`` is a validation bound only, not part of the spec's identity:
        two specs with the same taus hash/compare equal regardless.
        """
        spec = cls(kind="explicit", taus=tuple(taus))
        if T is not None and spec.taus[-1] > T:
            raise ValueError(f"explicit tau {spec.taus[-1]} exceeds T={T}")
        return spec

    # ------------------------------------------------------------- resolve
    def resolve(self, T: int) -> np.ndarray:
        """The increasing (S,) int array of visited timesteps in [1, T]."""
        from repro_torch.core.schedules import make_tau
        if self.kind == "explicit":
            if self.taus[-1] > T:
                raise ValueError(f"explicit tau {self.taus[-1]} exceeds "
                                 f"T={T}")
            return np.asarray(self.taus, dtype=np.int64)
        if self.S > T:
            raise ValueError(f"need S <= T, got S={self.S} T={T}")
        kind = "linear" if self.kind == "uniform" else self.kind
        return make_tau(T, self.S, kind)


@dataclasses.dataclass(frozen=True)
class SigmaSpec:
    """Per-step stochasticity spec (paper Eq. 16).

    kind:
      'eta'          sigma_k = eta * sqrt((1-a_s)/(1-a_t)) sqrt(1-a_t/a_s);
                     eta=0 is DDIM, eta=1 is DDPM.  ``sigma_hat`` selects
                     the over-dispersed App. D.3 noise scale (eta=1 only).
      'eta_schedule' the same formula with a per-step eta (length S,
                     ordered by increasing t — the trajectory order).
      'explicit'     per-step sigmas verbatim (length S, trajectory order);
                     validated against the Eq. 16 feasibility bound
                     sigma_k^2 <= 1 - a_{s}.
    """

    kind: str = "eta"
    eta: float = 0.0
    etas: Optional[Tuple[float, ...]] = None
    sigmas: Optional[Tuple[float, ...]] = None
    sigma_hat: bool = False

    def __post_init__(self):
        if self.kind == "eta":
            if self.eta < 0.0:
                raise ValueError(f"eta must be >= 0, got {self.eta}")
            if self.sigma_hat and self.eta != 1.0:
                raise ValueError("sigma_hat is a DDPM (eta=1) variant")
        elif self.kind == "eta_schedule":
            if not self.etas:
                raise ValueError("SigmaSpec('eta_schedule') needs etas")
            etas = tuple(float(e) for e in self.etas)
            if any(e < 0.0 for e in etas):
                raise ValueError("per-step etas must be >= 0")
            object.__setattr__(self, "etas", etas)
            if self.sigma_hat:
                raise ValueError("sigma_hat needs the scalar eta=1 spec")
        elif self.kind == "explicit":
            if self.sigmas is None:
                raise ValueError("SigmaSpec('explicit') needs sigmas")
            sig = tuple(float(s) for s in self.sigmas)
            if any(s < 0.0 for s in sig):
                raise ValueError("sigmas must be >= 0")
            object.__setattr__(self, "sigmas", sig)
            if self.sigma_hat:
                raise ValueError("sigma_hat needs the scalar eta=1 spec")
        else:
            raise ValueError(f"unknown sigma kind: {self.kind!r}")

    # ------------------------------------------------------------ builders
    @classmethod
    def ddim(cls) -> "SigmaSpec":
        """The deterministic implicit model (eta = 0)."""
        return cls(kind="eta", eta=0.0)

    @classmethod
    def ddpm(cls, sigma_hat: bool = False) -> "SigmaSpec":
        """The Markovian chain (eta = 1), optionally over-dispersed."""
        return cls(kind="eta", eta=1.0, sigma_hat=sigma_hat)

    @classmethod
    def from_eta(cls, eta: float, sigma_hat: bool = False) -> "SigmaSpec":
        return cls(kind="eta", eta=float(eta), sigma_hat=sigma_hat)

    @classmethod
    def schedule(cls, etas: Sequence[float]) -> "SigmaSpec":
        """A per-step eta schedule (trajectory order, increasing t)."""
        return cls(kind="eta_schedule", etas=tuple(float(e) for e in etas))

    @classmethod
    def explicit(cls, sigmas: Sequence[float]) -> "SigmaSpec":
        """Per-step sigmas verbatim (trajectory order, increasing t)."""
        return cls(kind="explicit", sigmas=tuple(float(s) for s in sigmas))

    # ------------------------------------------------------------- resolve
    def resolve(self, alpha_bar: np.ndarray, tau: np.ndarray):
        """(sigma, noise_scale) float64 (S,) arrays, trajectory order.

        ``sigma`` enters the direction coefficient sqrt(1 - a_s - sigma^2);
        ``noise_scale`` multiplies the noise draw (they differ only for the
        sigma-hat variant).
        """
        S = len(tau)
        t_prev = np.concatenate([[0], tau[:-1]])
        a_t = alpha_bar[tau]
        a_s = alpha_bar[t_prev]
        base = np.sqrt((1.0 - a_s) / (1.0 - a_t)) * np.sqrt(1.0 - a_t / a_s)
        if self.kind == "eta":
            sigma = self.eta * base
        elif self.kind == "eta_schedule":
            if len(self.etas) != S:
                raise ValueError(f"eta schedule length {len(self.etas)} != "
                                 f"S={S}")
            sigma = np.asarray(self.etas, np.float64) * base
        else:
            if len(self.sigmas) != S:
                raise ValueError(f"sigma list length {len(self.sigmas)} != "
                                 f"S={S}")
            sigma = np.asarray(self.sigmas, np.float64)
            bad = sigma ** 2 > (1.0 - a_s) + 1e-12
            if bad.any():
                k = int(np.argmax(bad))
                raise ValueError(
                    f"sigma[{k}]={sigma[k]:.4g} violates the Eq. 16 bound "
                    f"sigma^2 <= 1 - alpha_bar[prev] = {1.0 - a_s[k]:.4g}")
        noise_scale = np.sqrt(1.0 - a_t / a_s) if self.sigma_hat else sigma
        return sigma, noise_scale


@dataclasses.dataclass(frozen=True)
class X0Policy:
    """What happens to the predicted x0 before the Eq. 12 jump.

    ``clip``: bound |x0_hat| to a data range and re-derive the equivalent
    eps (the common practice for image models); None leaves x0_hat alone.
    """

    clip: Optional[float] = None

    def __post_init__(self):
        if self.clip is not None and self.clip <= 0.0:
            raise ValueError(f"clip must be positive, got {self.clip}")

    @classmethod
    def none(cls) -> "X0Policy":
        return cls(clip=None)

    @classmethod
    def clipped(cls, bound: float = 1.0) -> "X0Policy":
        return cls(clip=float(bound))
