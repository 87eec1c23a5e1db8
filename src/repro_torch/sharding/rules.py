"""Path-based sharding rules (port of ``repro/sharding/rules.py``).

Conventions (the JAX package's):
  * batch-like dims      -> ("pod", "data") axes (all data axes of the mesh)
  * weight output dims of wq/wk/wv/w_gate/w_up/embeddings/router/unembed
                         -> "model" (tensor parallel)
  * weight input dims of wo/w_down/w_out -> "model"
  * expert dim of MoE expert weights -> "model" (expert parallel)
  * anything indivisible -> replicated on that axis

Rules are name-based over "/"-joined tree paths and tolerate arbitrary
leading stacking dims (layers / (n_apps, attn_every)) by aligning the spec
to the TRAILING dimensions.  The functions read only ``mesh.shape`` (an
ordered ``{axis: size}`` dict), so any object with that dict resolves a
spec, the production meshes of ``launch/mesh.py`` (``meta`` devices)
included.

The placement side has no XLA behind it: ``NamedSharding(mesh, spec)``
says which block of a tensor each mesh device holds, ``split`` cuts a
tensor into those blocks on their devices, ``join`` puts them back
together, and ``device_put`` places a tree by a tree of shardings (a tree
of ``ShardedTensor``).
"""
from __future__ import annotations

import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

Tree = Any

# name -> spec on the trailing dims of the base (unstacked) array
_COL2 = (None, "model")      # (in, out) with out sharded
_ROW2 = ("model", None)      # (in, out) with in sharded
_RULES = [
    # --- embeddings / unembeddings: shard the vocab dim
    (r"(^|/)embed$", ("model", None)),
    (r"(^|/)unembed$", _COL2),
    (r"(^|/)rounding$", _COL2),
    # --- attention (GQA + MLA + shared/cross variants)
    (r"/w?q$|/wq$", _COL2),
    (r"/wk$", _COL2),
    (r"/wv$", _COL2),
    (r"/wg$", _COL2),
    (r"/wo$", _ROW2),
    (r"/w_dq$", _COL2),
    (r"/w_uq$", _COL2),
    (r"/w_dkv$", (None, None)),          # latent small: replicate
    (r"/w_krope$", (None, None)),
    (r"/w_uk$", _COL2),
    (r"/w_uv$", _COL2),
    # --- MoE router + expert weights (expert dim leads the base array).
    # These MUST precede the generic FFN rules: first match wins, and the
    # expert-parallel spec would otherwise be shadowed by /w_gate$ etc.
    (r"/router$", (None, None)),
    (r"/moe/w_gate$", ("model", None, None)),
    (r"/moe/w_up$", ("model", None, None)),
    (r"/moe/w_down$", ("model", None, None)),
    # --- FFN
    (r"/w_gate$", _COL2),
    (r"/w_up$", _COL2),
    (r"/w_down$", _ROW2),
    (r"/sw_gate$", _COL2),
    (r"/sw_up$", _COL2),
    (r"/sw_down$", _ROW2),
    # --- mamba / hybrid
    (r"/w_in$", _COL2),
    (r"/conv_w$", (None, "model")),
    (r"/conv_b$", ("model",)),
    (r"/w_out$", _ROW2),
    # --- rwkv time/channel mix
    (r"/wr$", _COL2),
    (r"/mix_a_\w+$", (None, None)),
    (r"/mix_b_\w+$", (None, None)),
    (r"/w_lora_a$", (None, None)),
    (r"/w_lora_b$", (None, None)),
    # --- diffusion-LM / U-Net style projections
    (r"/time_w\d?$", (None, None)),
    (r"/gate_norm$", ("model",)),
]

# Leaf names that are CORRECT to replicate: norm scales, per-head mixing
# vectors, learned decay/gate vectors, SSM per-head scalars.  The coverage
# test flattens every registry model through the rules and fails on any
# leaf that neither matches a rule nor lands here.
REPLICATE_OK = (
    r"(^|/)(final_norm|enc_norm|ln_in)$",
    r"/(attn_norm|mlp_norm|self_norm|cross_norm|q_norm|kv_norm|norm)$",
    r"/(ln1|ln2|ln_scale)$",
    r"/mu_\w+$",                 # rwkv time/channel-mix interpolants
    r"/(u|w0)$",                 # rwkv bonus / decay-base vectors
    r"/(A_log|D|dt_bias)$",      # mamba per-head SSM scalars
)


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    an axis name, or a tuple of axis names (split over their product,
    the first the slowest).  A one-name tuple is stored as the name, as
    JAX's ``PartitionSpec`` stores it, so ``tuple(P)`` compares equal to
    ``tuple`` of JAX's spec for the same entries."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else e
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def _axis_size(mesh, entry) -> int:
    return int(np.prod([mesh.shape[a] for a in _axes(entry)]))


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn, tree, *rest, path=()):
    """``fn(path_str, leaf, *rest_leaves)`` over a nested dict / list /
    tuple / NamedTuple (a field as ".name" in the path, JAX's
    ``GetAttrKey``), keeping its structure (JAX's
    ``tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        names = ([f".{f}" for f in tree._fields]
                 if hasattr(tree, "_fields") else range(len(tree)))
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                  path=path + (name,))
               for i, (name, v) in enumerate(zip(names, tree))]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(_path_str(path), tree, *rest)


def _divisible(shape: Tuple[int, ...], spec: Tuple, mesh) -> Tuple:
    """Drop axis assignments whose dim isn't divisible by the mesh axis."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        out.append(ax if dim % _axis_size(mesh, ax) == 0 else None)
    return tuple(out)


def rule_for(path_str: str) -> Optional[str]:
    """The first matching rule pattern for a param path (None = no rule)."""
    for pattern, _ in _RULES:
        if re.search(pattern, path_str):
            return pattern
    return None


def replicate_allowed(path_str: str) -> bool:
    """Whether a rule-less leaf is on the explicit replicate allowlist."""
    return any(re.search(p, path_str) for p in REPLICATE_OK)


def spec_for_param(path_str: str, shape: Tuple[int, ...], mesh) -> P:
    """Resolve a parameter's partition spec from its tree path."""
    for pattern, trailing in _RULES:
        if re.search(pattern, path_str):
            n_lead = len(shape) - len(trailing)
            if n_lead < 0:      # e.g. scalar matched by a 2D rule: replicate
                return P()
            spec = (None,) * n_lead + tuple(trailing)
            return P(*_divisible(shape, spec, mesh))
    return P(*((None,) * len(shape)))


# ------------------------------------------------------------- placement
class NamedSharding:
    """Which block of a tensor each device of ``mesh`` holds under
    ``spec`` (JAX's ``NamedSharding``): dim d is cut into
    ``prod(mesh.shape[a] for a in spec[d])`` equal blocks and the device
    at mesh coordinates c holds the block whose index is c's mixed-radix
    number over those axes; axes a spec leaves out replicate."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)
        missing = [a for e in self.spec for a in _axes(e)
                   if a not in mesh.shape]
        if missing:
            raise ValueError(f"spec {self.spec} names axes {missing} that "
                             f"the mesh {mesh.shape} lacks")

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    @property
    def is_replicated(self) -> bool:
        return all(e is None for e in self.spec)

    def index(self, coords: Tuple[int, ...], shape) -> Tuple[slice, ...]:
        """The slices of a ``shape`` tensor that the device at mesh
        coordinates ``coords`` holds."""
        names = list(self.mesh.shape)
        out = []
        for d, dim in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            size = _axis_size(self.mesh, entry)
            if dim % size:
                raise ValueError(f"dim {d} of {tuple(shape)} is not "
                                 f"divisible by {entry} ({size})")
            blk = 0
            for a in _axes(entry):
                blk = blk * self.mesh.shape[a] + coords[names.index(a)]
            n = dim // size
            out.append(slice(blk * n, (blk + 1) * n))
        return tuple(out)

    def split(self, x: torch.Tensor) -> np.ndarray:
        """x's blocks on their devices, as an array of the mesh's shape
        (a block on x's own device is a view)."""
        shards = np.empty(self.mesh.devices.shape, dtype=object)
        for coords in np.ndindex(*shards.shape):
            shards[coords] = x[self.index(coords, x.shape)].to(
                self.mesh.devices[coords])
        return shards

    def join(self, shards: np.ndarray, shape, device) -> torch.Tensor:
        """The whole tensor on ``device`` from its blocks (the all-gather:
        a replicated block is read from the first device holding it)."""
        first = shards.ravel()[0]
        out = torch.empty(tuple(shape), dtype=first.dtype, device=device)
        done = set()
        for coords in np.ndindex(*shards.shape):
            idx = self.index(coords, shape)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:
                done.add(key)
                out[idx] = shards[coords].to(device)
        return out


class ShardedTensor:
    """A tensor placed on a mesh: its blocks (``shards``, an array of the
    mesh's shape, each on its device) and the ``sharding`` that cut them
    (JAX's committed ``jax.Array``)."""

    def __init__(self, sharding: NamedSharding, shards: np.ndarray,
                 shape, dtype):
        self.sharding = sharding
        self.shards = shards
        self.shape = torch.Size(shape)
        self.dtype = dtype

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding!r})")

    def local(self, coords: Tuple[int, ...]) -> torch.Tensor:
        """The block the device at mesh coordinates ``coords`` holds."""
        return self.shards[coords]

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return self.sharding.join(self.shards, self.shape, device)


def device_put(tree: Tree, shardings: Tree) -> Tree:
    """Place every tensor of ``tree`` by the matching leaf of
    ``shardings``: a tree of ``ShardedTensor``."""
    return tree_map_with_path(
        lambda _, x, s: ShardedTensor(s, s.split(x), x.shape, x.dtype),
        tree, shardings)


def shard_params(tree_shapes: Tree, mesh) -> Tree:
    """Tensor (real or meta) tree -> NamedSharding tree."""
    return tree_map_with_path(
        lambda p, leaf: NamedSharding(
            mesh, spec_for_param(p, tuple(leaf.shape), mesh)), tree_shapes)


# --------------------------------------------------------------- activations
def data_axes(mesh) -> Tuple[str, ...]:
    """All batch-sharding axes present in the mesh ('pod' first if present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_spec(mesh, batch: int, ndim: int) -> P:
    """Shard dim0 over the data axes if divisible, else replicate."""
    axes = data_axes(mesh)
    first = axes if batch % _axis_size(mesh, axes) == 0 else None
    return P(first, *([None] * (ndim - 1)))


def shard_batch(tree_shapes: Tree, mesh) -> Tree:
    return tree_map_with_path(
        lambda _, leaf: NamedSharding(
            mesh, batch_spec(mesh, leaf.shape[0], len(leaf.shape))),
        tree_shapes)


def spec_for_cache(path_str: str, shape: Tuple[int, ...], mesh,
                   batch: int) -> P:
    """Cache arrays: (L, B, M, ...) KV / latent caches and recurrent states.

    Policy: shard batch over data axes when divisible; otherwise (e.g.
    long_500k, B=1) shard the sequence dim of KV caches over "data" so the
    cache spreads across the mesh.  Head-like dims shard over "model" when
    divisible: KV caches (L, B, M, Hkv, D) -> dim 3, wkv / ssm states
    (L, B, H, K, K) / (L, B, H, P, N) -> dim 3, else dim 2.
    """
    if path_str.endswith("idx"):
        return P()
    axes = data_axes(mesh)
    dsize = _axis_size(mesh, axes)
    msize = mesh.shape["model"]
    spec = [None] * len(shape)
    if len(shape) >= 2 and shape[1] == batch and batch % dsize == 0:
        spec[1] = axes
    elif len(shape) >= 3 and shape[2] % dsize == 0:
        spec[2] = axes          # shard sequence dim (B indivisible)
    if len(shape) == 5:
        for d in (3, 2):
            if spec[d] is None and shape[d] % msize == 0:
                spec[d] = "model"
                break
    return P(*spec)


def shard_cache(tree_shapes: Tree, mesh, batch: int) -> Tree:
    return tree_map_with_path(
        lambda p, leaf: NamedSharding(
            mesh, spec_for_cache(p, tuple(leaf.shape), mesh, batch)),
        tree_shapes)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
