"""ModelRegistry — resident checkpoints behind the gateway's front door
(port of ``repro/serving/gateway/registry.py``).

A gateway serves N named models over one capability-homogeneous fleet:
each model owns one or more slot pools whose engines hold its weights as
hot-swappable ``eps_params`` (a state dict, or a nested dict / list of
tensors). The registry is the host-side source of truth for WHICH
weights are resident: ``register`` installs a model at version 1,
``stage`` parks a candidate checkpoint (validated against the resident
weights under the same conditions as ``engine.install_eps_params``:
keys, and every leaf's shape, dtype and device), and ``promote`` makes
the staged weights current once the gateway's rolling drain -> install
-> restore has walked every pool (serving/gateway/core.py).

The registry never touches an engine itself — it is bookkeeping the
gateway's swap state machine reads; pools are the unit of installation.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.serving.scheduler.engine import _flatten


def _desc(leaf) -> str:
    return (f"{tuple(leaf.shape)}/"
            f"{str(leaf.dtype).removeprefix('torch.')}@{leaf.device}")


def _check_like(name: str, resident, candidate) -> None:
    """A staged checkpoint must be install-compatible with the resident
    one: the same keys, and per leaf the same shape, dtype and device (the
    condition under which an engine swap reuses its tick), checked here
    at the API edge so that a bad checkpoint fails at stage time, not
    mid-rollout."""
    old, new = _flatten(resident), _flatten(candidate)
    old_p, new_p = [p for p, _ in old], [p for p, _ in new]
    if old_p != new_p:
        raise ValueError(
            f"model '{name}': staged checkpoint tree structure differs "
            f"from the resident weights (only in staged: "
            f"{sorted(set(new_p) - set(old_p))[:5]}, only in resident: "
            f"{sorted(set(old_p) - set(new_p))[:5]})")
    for i, ((_, o), (_, n)) in enumerate(zip(old, new)):
        if (o.shape != n.shape or o.dtype != n.dtype
                or o.device != n.device):
            raise ValueError(
                f"model '{name}': staged leaf {i} is {_desc(n)}, resident "
                f"is {_desc(o)} — a rollout must preserve shapes/dtypes "
                "and devices to reuse the compiled ticks")


class ModelRegistry:
    """Named resident checkpoints + staged candidates with versioning."""

    def __init__(self):
        self._resident: Dict[str, object] = {}
        self._staged: Dict[str, object] = {}
        self._version: Dict[str, int] = {}

    # ------------------------------------------------------------ queries
    @property
    def names(self) -> List[str]:
        return sorted(self._resident)

    def __contains__(self, name: str) -> bool:
        return name in self._resident

    def __len__(self) -> int:
        return len(self._resident)

    def params(self, name: str):
        """The RESIDENT weights for ``name`` (what active pools serve)."""
        return self._resident[name]

    def staged_params(self, name: str):
        """The staged candidate for ``name`` (None = nothing staged)."""
        return self._staged.get(name)

    def version(self, name: str) -> int:
        return self._version[name]

    # ---------------------------------------------------------- lifecycle
    def register(self, name: str, params) -> None:
        """Install a new model at version 1 (gateway build time)."""
        if name in self._resident:
            raise ValueError(f"model '{name}' is already registered; "
                             "stage + promote to replace its weights")
        self._resident[name] = params
        self._version[name] = 1

    def stage(self, name: str, params) -> None:
        """Park a candidate checkpoint for a future rollout."""
        if name not in self._resident:
            raise KeyError(f"model '{name}' is not registered")
        _check_like(name, self._resident[name], params)
        self._staged[name] = params

    def promote(self, name: str) -> int:
        """Staged -> resident (the rollout's final step); returns the new
        version. The gateway calls this only after every pool serving
        ``name`` has drained, installed, and restored."""
        staged = self._staged.pop(name, None)
        if staged is None:
            raise ValueError(f"model '{name}' has no staged checkpoint "
                             "to promote")
        self._resident[name] = staged
        self._version[name] += 1
        return self._version[name]

    def describe(self) -> Dict[str, Dict]:
        """The /v1/models payload: per-model version + staged flag."""
        return {name: {"version": self._version[name],
                       "staged": name in self._staged}
                for name in self.names}
