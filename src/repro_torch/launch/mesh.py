"""Device meshes (port of ``repro/launch/mesh.py``).

A mesh is an explicit array of ``torch.device``s with named axes.  The
sharding rules (``repro_torch.sharding``) read only its ``shape``, an
ordered ``{axis: size}`` dict, and the mesh-sharded slot pools
(``serving/fleet/sharded.py``, the engine's ``mesh=``) place each block of
a tensor on the device at its mesh coordinates.

``devices=None`` means the CUDA cards of this process, ``cuda:0`` to
``cuda:{n-1}``, and raises as ``device.resolve_device`` does when there is
none: a mesh never falls back to the CPU.  A SIMULATED mesh exists only
where the caller passes ``devices=`` explicitly, such as
``[torch.device("cpu")] * 8`` in the CPU tests or ``[cuda:0] * 4`` on one
card.  That argument is the port's counterpart of the JAX package's
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` recipe: the same
mesh shapes and the same split of the work over them, on fewer real
devices.

Everything here is a function of its arguments: importing the module
touches no device.  The card's rates live in ``launch/roofline.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """An n-d array of devices with one name per axis.

    ``devices`` is an ``np.ndarray`` (dtype object) of ``torch.device``
    whose shape is the mesh's; ``shape`` the ordered ``{axis: size}``
    dict; ``axis_names`` the names in order.  Two axes on the same device
    are allowed (a simulated mesh)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        arr.ravel()[:] = flat
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"devices have {arr.ndim} dims but "
                             f"{len(self.axis_names)} axis names "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        self.devices = arr

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.ravel()]
        return f"Mesh({self.shape}, devices={devs})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.ravel()) == list(other.devices.ravel()))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.ravel())))

    def data_model_grid(self) -> np.ndarray:
        """(data blocks, model size) array of mesh coordinate tuples: row i
        is data block i (the mixed-radix number over the data axes, 'pod'
        first, as ``sharding.batch_spec`` splits a batch), column j the
        model index.  Every axis must be 'pod', 'data' or 'model'."""
        extra = set(self.axis_names) - {"pod", "data", "model"}
        if extra:
            raise ValueError(f"mesh axes {sorted(extra)} are neither data "
                             "axes ('pod', 'data') nor 'model'")
        order = [a for a in ("pod", "data", "model") if a in self.shape]
        sizes = [self.shape[a] for a in order]
        msize = self.shape.get("model", 1)
        grid = np.empty((int(np.prod(sizes)) // msize, msize), dtype=object)
        for flat, c in enumerate(np.ndindex(*sizes)):
            by_name = dict(zip(order, c))
            grid.ravel()[flat] = tuple(by_name[a] for a in self.axis_names)
        return grid


def _local_devices(devices: Optional[Sequence]):
    """``devices`` as torch devices, or every CUDA card of the process."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    resolve_device(None)        # raises without a card
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production mesh shape for rule resolution only: 16x16 = 256
    chips per pod, 2 pods = 512 chips with a leading 'pod' axis.  Its
    devices are ``meta``: nothing runs on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = np.empty(shape, dtype=object)
    devs.ravel()[:] = [torch.device("meta")] * devs.size
    return Mesh(devs, axes)


def make_host_mesh(model: int = 1, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """A ("data", "model") mesh over the local devices (or ``devices``).

    Simulated: ``make_host_mesh(2, devices=[torch.device("cpu")] * 8)``
    is JAX's forced-8-host-device (4, 2) mesh.
    """
    devs = _local_devices(devices)
    n = len(devs)
    if model < 1 or n % model:
        raise ValueError(
            f"local device count {n} is not divisible by model={model}; "
            f"pick a model-axis size that divides {n} (e.g. pass more "
            "devices with devices=[...] * <k*model>)")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n // model, model), ("data", "model"))


def make_fleet_mesh(n_pools: int, model: int = 1,
                    devices: Optional[Sequence] = None):
    """Split the local devices (or ``devices``) into ``n_pools`` disjoint
    pool meshes.

    Each pool gets its own ("data", "model") mesh over a contiguous,
    non-overlapping slice of the devices: tensor / data sharding INSIDE a
    pool, pure data parallelism ACROSS pools.  Returns a list of
    ``n_pools`` meshes.  Simulated: ``make_fleet_mesh(2, model=2,
    devices=[torch.device("cpu")] * 8)`` yields two (2, 2) pool meshes.
    """
    devs = _local_devices(devices)
    n = len(devs)
    if n_pools < 1 or n % n_pools:
        raise ValueError(
            f"local device count {n} is not divisible by n_pools="
            f"{n_pools}; pick a pool count that divides {n} (e.g. pass "
            f"more devices with devices=[...] * <k*{n_pools}>)")
    per = n // n_pools
    if model < 1 or per % model:
        raise ValueError(
            f"per-pool device count {per} (= {n} devices / {n_pools} "
            f"pools) is not divisible by model={model}")
    out = []
    for p in range(n_pools):
        arr = np.empty(per, dtype=object)
        arr[:] = devs[p * per:(p + 1) * per]
        out.append(Mesh(arr.reshape(per // model, model), ("data", "model")))
    return out
