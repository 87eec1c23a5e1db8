"""Device-side numerics probes (port of ``repro/obs/probes.py``).

The frozen :class:`ProbeSpec` and the reduction :func:`device_frame` that
the engine's probed tick runs on tensors the tick already holds (the raw
eps evaluation, the pre- and post-step state).  Enabling probes adds no
model evaluation and one ``(slots, 6)`` float32 device-to-host copy per
tick.  The reductions are plain torch ops on the state's device (the JAX
package's are plain ``jnp`` inside its jitted tick, no Pallas kernel).

Probe on/off picks one of two tick functions: the engine builds the plain
tick and at most one probed tick, so toggling probes never builds a third
(``compiled_ticks`` <= 2).

The ``defect`` column is a one-eval step-doubling proxy: with eps frozen,
a direct Eq. 12 jump and two half-jumps through a midpoint are the same
update, so the defect is carried by how much eps moves across the step,
which the tick observes for free as the drift between this tick's raw
eps and the previous one (the newest Adams-Bashforth history row on
multistep engines, a probe-carried buffer on order-1 engines).  It is
meaningless at a slot's first step (k == 0: there is no previous eval of
the same request), and hosts gate on ``slot.k >= 1``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.schema import PROBE_COLUMNS


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """Static selection of per-slot reductions in the probed tick.

    Frozen and hashable.  Disabling a probe fills its column(s) with NaN
    ("not computed") rather than shrinking the frame: the
    ``(slots, len(PROBE_COLUMNS))`` shape is part of the schema.
    """

    eps_norm: bool = True     # eps_rms column
    x0_stats: bool = True     # x0_min / x0_max / x0_mean columns
    finite: bool = True       # finite_frac column (post-step state)
    defect: bool = True       # step-doubling proxy column

    def describe(self) -> str:
        on = [f.name for f in dataclasses.fields(self)
              if getattr(self, f.name)]
        return "+".join(on) if on else "none"


def device_frame(spec: ProbeSpec, x_in2: torch.Tensor, x_new2: torch.Tensor,
                 eps2: torch.Tensor, eps_prev2: Optional[torch.Tensor],
                 states, *, rps: int, n_live: int) -> torch.Tensor:
    """Fold slot-tile tensors into a ``(slots, 6)`` float32 probe frame.

    All inputs are in the ``(slots * rps, 256)`` slot-tile layout;
    ``n_live`` is the per-slot count of live elements (the rest of a
    slot's rows is padding, masked out).  ``eps_prev2`` may be None
    (defect probe off): the defect column is then NaN.
    """
    b = states.t.shape[0]
    m = rps * x_in2.shape[1]
    dev = x_in2.device
    live = torch.arange(m, device=dev) < n_live
    mask = live.to(torch.float32)
    inv_n = float(np.float32(1.0 / float(n_live)))
    nan_col = torch.full((b,), float("nan"), dtype=torch.float32, device=dev)

    def per_slot(a2):
        return a2.reshape(b, m).to(torch.float32)

    eps = per_slot(eps2)
    if spec.eps_norm:
        eps_rms = torch.sqrt(((eps * mask) ** 2).sum(dim=1) * inv_n)
    else:
        eps_rms = nan_col

    if spec.x0_stats:
        # Eq. 12 x0-hat from the pre-step state and the raw eps (idle
        # slots carry sqrt_a_t = 1, so the division is safe).  The
        # numerator cancels at large t (x0 ~ 1e-3 of x), so it is one
        # fused multiply-add, as XLA contracts it in the JAX tick: the
        # product is exact in float64, rounded once with the difference
        sa = states.sqrt_a_t.to(torch.float32)[:, None]
        s1 = states.sqrt_1m_a_t.to(torch.float32)[:, None]
        num = (per_slot(x_in2).double() - s1.double() * eps.double())
        x0 = num.to(torch.float32) / sa
        inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
        x0_min = torch.where(live, x0, inf).amin(dim=1)
        x0_max = torch.where(live, x0, -inf).amax(dim=1)
        x0_mean = (x0 * mask).sum(dim=1) * inv_n
    else:
        x0_min = x0_max = x0_mean = nan_col

    if spec.finite:
        ok = torch.isfinite(per_slot(x_new2)).to(torch.float32)
        finite_frac = (ok * mask).sum(dim=1) * inv_n
    else:
        finite_frac = nan_col

    if spec.defect and eps_prev2 is not None:
        d = eps - per_slot(eps_prev2)
        defect = torch.sqrt(((d * mask) ** 2).sum(dim=1) * inv_n)
    else:
        defect = nan_col

    frame = torch.stack(
        [eps_rms, x0_min, x0_max, x0_mean, finite_frac, defect], dim=1)
    assert frame.shape == (b, len(PROBE_COLUMNS))
    return frame


def normalize_probes(probes) -> Optional[ProbeSpec]:
    """Coerce an engine's ``probes=`` argument to a spec or None."""
    if probes is None or probes is False:
        return None
    if probes is True:
        return ProbeSpec()
    if isinstance(probes, ProbeSpec):
        return probes
    raise TypeError(f"probes must be bool/None/ProbeSpec, got {probes!r}")
