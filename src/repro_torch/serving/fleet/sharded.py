"""The fleet's demo eps trunk (port of ``repro/serving/fleet/sharded.py``,
its single-device part).

The JAX module runs one slot pool's trunk across a ``("data", "model")``
mesh, by ``shard_map`` (:func:`make_sharded_eps`) or by GSPMD
(:func:`sharded_eps_from_apply`).  Those need a second device and are
not ported: they raise ``NotImplementedError``.  What one card runs is
the trunk itself — weights as an explicit tree (``wq``, ``wo``,
``time_w``, with ``alpha_bar`` riding along so the apply is a pure
function of (params, x, t)) — which the gateway and fleet demos, and
their tests, serve through the unsharded engine.

Weights are JAX's for the same seed: two threefry ``normal`` draws of
``split(PRNGKey(seed))``, scaled in float32 as JAX scales them.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.device import DeviceLike, resolve_device

_MESH = ("needs a second GPU: mesh-sharded slot pools (the JAX package's "
         "serving/fleet/sharded.py) are not ported to one card")


def make_trunk_params(schedule: NoiseSchedule, dim: int, hidden: int,
                      seed: int = 0, device: DeviceLike = None):
    """Weight-heavy demo trunk params on ``device`` (CUDA unless named),
    bitwise JAX's ``make_trunk_params`` for the same seed."""
    ks = prng.split(prng.PRNGKey(seed, resolve_device(device)))
    return {
        "trunk": {
            "wq": prng.normal(ks[0], (dim, hidden)) * (1.0 / np.sqrt(dim)),
            "wo": prng.normal(ks[1], (hidden, dim))
            * (1.0 / np.sqrt(hidden)),
            "time_w": torch.ones((1,), dtype=torch.float32,
                                 device=ks.device),
        },
        "alpha_bar": schedule.alpha_bar.to(device=ks.device,
                                           dtype=torch.float32),
    }


def trunk_apply(params, x: torch.Tensor, t: torch.Tensor, *,
                model_axis: Optional[str] = None) -> torch.Tensor:
    """eps_theta(x, t) for the demo trunk; ``model_axis=None`` is the
    single-device apply (the only one on one card)."""
    if model_axis is not None:
        raise NotImplementedError(f"trunk_apply(model_axis=...) {_MESH}")
    w = params["trunk"]
    a = params["alpha_bar"][t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
    base = x * torch.sqrt(1 - a) / (1 - a + a * 0.25)
    r = torch.tanh(x @ w["wq"]) @ w["wo"]
    return base + 0.05 * torch.sqrt(1 - a) * w["time_w"] * r


def make_unsharded_eps(params) -> Callable:
    """The single-device reference eps over the demo trunk."""
    def eps_fn(x, t):
        return trunk_apply(params, x, t)
    return eps_fn


def make_sharded_eps(mesh, params) -> Callable:
    """The demo trunk under ``shard_map`` on a mesh: not on one card."""
    raise NotImplementedError(f"make_sharded_eps {_MESH}")


def sharded_eps_from_apply(mesh, params, apply_fn: Callable) -> Callable:
    """Any eps apply under GSPMD on a mesh: not on one card."""
    raise NotImplementedError(f"sharded_eps_from_apply {_MESH}")
