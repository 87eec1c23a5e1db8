"""Mesh-parallel eps trunks for sharded slot pools (port of
``repro/serving/fleet/sharded.py``).

One slot pool's eps model runs across a ``("data", "model")`` mesh
(``launch/mesh.make_host_mesh`` / ``make_fleet_mesh``): the batch splits
over the DATA axes, weight matrices split by the name-based rules of
``sharding/rules.py`` over the MODEL axis (wq column-split, wo row-split).
Two wiring styles, as in the JAX package:

:func:`make_sharded_eps` — explicit SPMD: the trunk body
  (``trunk_apply(model_axis="model")``) sees one device's LOCAL weight
  shards and its LOCAL row block and returns its partial product; the
  partials are summed over the model axis in a fixed order on the data
  block's first device (JAX's ``psum``).  On a model axis of size 1 the
  single partial IS the sum, so a 1-device mesh is BITWISE the unsharded
  apply — the fleet's cross-backend equivalence anchor.

:func:`sharded_eps_from_apply` — any apply function.  Eager PyTorch has
  no GSPMD partitioner, so this is the data-parallel half of JAX's:
  weights are copied whole once onto each data block's first device (what
  GSPMD's all-gather would give that block), the batch is
  split over the data axes by ``sharding.batch_spec`` (whole where it
  does not divide) and ``apply_fn`` runs once per data block.

Both return a ``MeshEps``: ``eps(x, t)`` over the whole batch, with
``.mesh``, ``.params`` (the placed tree of ``ShardedTensor``) and
``.apply_blocks(xs, ts)``, the same function over batch blocks already
split by the data axes and on their blocks' devices: a mesh engine whose
slot state is split the same way calls it, so each block's eps stays on
its device.

Weights of the demo trunk are JAX's for the same seed: two threefry
``normal`` draws of ``split(PRNGKey(seed))``, scaled in float32 as JAX
scales them.  Everything here is functions over explicit params:
importing the module touches no device.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding import (P, batch_spec, data_axes, device_put,
                                  shard_params)
from repro_torch.sharding.rules import tree_map_with_path


# --------------------------------------------------------- demo eps trunk
# The fleet bench/test trunk: a weight-heavy shrinkage-plus-residual eps
# whose weights are an explicit tree with leaf names that hit the sharding
# rules (wq -> column-split, wo -> row-split, time_w -> replicated), so one
# trunk definition serves the unsharded engine and both mesh pools.

def make_trunk_params(schedule: NoiseSchedule, dim: int, hidden: int,
                      seed: int = 0, device: DeviceLike = None):
    """Weight-heavy demo trunk params on ``device`` (CUDA unless named),
    bitwise JAX's ``make_trunk_params`` for the same seed.  ``alpha_bar``
    rides along so the apply is a pure function of (params, x, t)."""
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


def _finish(params, x: torch.Tensor, t: torch.Tensor,
            r: torch.Tensor) -> torch.Tensor:
    """eps from the model-axis sum ``r`` of the trunk's products."""
    a = params["alpha_bar"][t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
    base = x * torch.sqrt(1 - a) / (1 - a + a * 0.25)
    return base + 0.05 * torch.sqrt(1 - a) * params["trunk"]["time_w"] * r


def trunk_apply(params, x: torch.Tensor, t: torch.Tensor, *,
                model_axis: Optional[str] = None) -> torch.Tensor:
    """eps_theta(x, t) for the demo trunk.

    ``model_axis`` names the mesh axis the hidden dim is split over: the
    weights are then one device's LOCAL shards and the return is that
    device's PARTIAL product ``tanh(x @ wq_j) @ wo_j``, which the caller
    sums over the axis (``make_sharded_eps``; JAX's ``psum`` inside the
    function).  ``None`` is the plain single-device apply.
    """
    w = params["trunk"]
    r = torch.tanh(x @ w["wq"]) @ w["wo"]
    if model_axis is not None:
        return r
    return _finish(params, x, t, r)


def make_unsharded_eps(params) -> Callable:
    """The single-device reference eps over the demo trunk."""
    def eps_fn(x, t):
        return trunk_apply(params, x, t)
    return eps_fn


def _split_rows(mesh, grid, x: torch.Tensor, t: torch.Tensor):
    """x and t cut into the data blocks of ``batch_spec``, each on its
    block's first device (a one-block list where the batch stays whole)."""
    devs = [mesh.devices[row[0]] for row in grid]
    if batch_spec(mesh, x.shape[0], x.dim())[0] is None:
        return [x.to(devs[0])], [t.to(devs[0])]
    b = x.shape[0] // len(grid)
    return ([x[i * b:(i + 1) * b].to(d) for i, d in enumerate(devs)],
            [t[i * b:(i + 1) * b].to(d) for i, d in enumerate(devs)])


class MeshEps:
    """An eps model on a mesh: ``eps(x, t)`` over the whole batch (split
    over the data axes by ``batch_spec``, each block's eps joined back on
    x's device), ``.mesh``, ``.apply_blocks(xs, ts)`` (the same function
    over blocks already split and on their devices) and ``.params``, the
    weights placed by the rules (a tree of ``ShardedTensor``), built by
    ``place`` the first time it is read."""

    def __init__(self, mesh, apply_blocks: Callable, place: Callable):
        self.mesh = mesh
        self._grid = mesh.data_model_grid()
        self.apply_blocks = apply_blocks
        self._place = place
        self._params = None

    @property
    def params(self):
        if self._params is None:
            self._params = self._place()
        return self._params

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        xs, ts = _split_rows(self.mesh, self._grid, x, t)
        out = self.apply_blocks(xs, ts)
        if len(out) == 1:
            return out[0].to(x.device)
        return torch.cat([b.to(x.device) for b in out])


def make_sharded_eps(mesh, params) -> MeshEps:
    """The demo trunk as explicit SPMD on ``mesh``.

    Weights are placed by ``sharding.shard_params`` (wq column-split, wo
    row-split over "model"; ``time_w`` and ``alpha_bar`` replicated); x, t
    and the output split over the data axes (``P(data, None)``), which
    must divide the batch, as JAX's ``shard_map`` requires.  Block (i, j)
    computes ``tanh(x_i @ wq[:, j]) @ wo[j, :]`` on device (i, j); the
    partials are summed over j in order 0, 1, ... on device (i, 0), which
    then finishes eps_i.
    """
    shardings = shard_params(params, mesh)
    placed = device_put(params, shardings)
    grid = mesh.data_model_grid()
    msize = grid.shape[1]
    if msize > 1 and any(
            shardings["trunk"][k].spec == P(None, None)
            for k in ("wq", "wo")):
        raise ValueError(
            f"hidden dim {params['trunk']['wq'].shape[1]} is not divisible "
            f"by the model axis ({msize}): wq / wo would be replicated and "
            "the model-axis sum would count every product "
            f"{msize} times")
    local = [[tree_map_with_path(lambda _, leaf, c=c: leaf.local(c), placed)
              for c in row] for row in grid]

    def apply_blocks(xs, ts):
        if len(xs) != len(grid):
            raise ValueError(
                f"batch {sum(x.shape[0] for x in xs)} is not divisible by "
                f"the data axes {data_axes(mesh)} ({len(grid)}) of the "
                f"mesh {mesh.shape}")
        out = []
        for i, (x, t) in enumerate(zip(xs, ts)):
            row = grid[i]
            home = mesh.devices[row[0]]
            r = None
            for j, c in enumerate(row):
                dev = mesh.devices[c]
                part = trunk_apply(local[i][j], x.to(dev), t.to(dev),
                                   model_axis="model").to(home)
                r = part if r is None else r + part
            out.append(_finish(local[i][0], x, t, r))
        return out

    return MeshEps(mesh, apply_blocks, lambda: placed)


def sharded_eps_from_apply(mesh, params, apply_fn: Callable) -> MeshEps:
    """Wrap ANY eps apply ``apply_fn(params, x, t)`` for a mesh pool.

    Each weight is copied whole onto each data block's first device; each
    call splits the batch over the data axes by ``sharding.batch_spec``
    (whole where it does not divide) and runs ``apply_fn`` once per block,
    with that device's weights.  Within a block the work is not split over
    the model axis: eager PyTorch has no partitioner to split an arbitrary
    body (JAX's GSPMD path).  ``.params`` (the weights placed by the
    name-based rules) is built only when read; no compute uses it.  Use
    for trunks whose body you don't control (U-Net, diffusion-LM).
    """
    grid = mesh.data_model_grid()
    whole = [tree_map_with_path(
        lambda _, leaf, d=mesh.devices[row[0]]: leaf.to(d), params)
        for row in grid]

    def apply_blocks(xs, ts):
        return [apply_fn(whole[i], x, t)
                for i, (x, t) in enumerate(zip(xs, ts))]

    return MeshEps(mesh, apply_blocks,
                   lambda: device_put(params, shard_params(params, mesh)))
