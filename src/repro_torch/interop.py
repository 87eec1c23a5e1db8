"""Carry weights from the JAX package's parameter pytrees to the port.

The input is a JAX ``init_params`` (or trained) pytree already converted
to numpy arrays — nested dicts and lists of ``np.ndarray`` — so this
module never imports jax.

LM mapping (``repro/models/{dense,vlm,moe,rwkv6,hybrid,encdec}.py`` ->
``repro_torch.models``), for the autoregressive server: the same nested
dict, every leaf a float32 tensor in its JAX layout (stacked layer leaves,
(in, out) matrices; the MoE tree's ``layer0`` plus stacked ``layers``
with their ``moe`` block and MLA or GQA ``attn``; the hybrid's Mamba2
``layers`` grouped (n_apps, attn_every, ...) beside its ``shared`` block;
the enc-dec's ``enc_layers`` and ``dec_layers``); ``lm_params_to_jax``
is the inverse (numpy leaves), so the ``{"params": ...}`` checkpoint the
JAX ``serve_lm --ckpt`` restores crosses both ways.  The vlm tree is the
dense one.

Diffusion-LM mapping (``repro/diffusion_lm/model.py`` ->
``repro_torch.diffusion_lm``): the same nested dict, every leaf as a
float32 tensor in its JAX layout — (in, out) matrices and stacked
(n_layers, ...) layer leaves, no transposes — so the megakernel reads
exactly what the plain version reads.

U-Net mapping (``repro/models/unet.py`` -> ``repro_torch.models.unet``):
  * conv kernels HWIO (kh, kw, cin, cout) -> OIHW (cout, cin, kh, kw);
  * dense matrices (in, out) -> ``nn.Linear.weight`` (out, in): the port
    uses ``nn.Linear``, which multiplies by the transpose;
  * ``*_s`` / ``*_b`` GroupNorm leaves -> ``gn*.weight`` / ``gn*.bias``;
    ``time_b*`` -> the matching Linear's ``bias``.
Any leaf it cannot map, any shape that disagrees with the port's module,
and any port parameter left unfilled raises.  ``unet_params_to_jax`` is the
inverse (a port state dict -> the JAX pytree's nesting, names and layouts,
numpy leaves), so a checkpoint the port writes restores in the JAX package
(``training/checkpoint.py``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.diffusion_lm.model import DiffusionLMConfig, param_shapes
from repro_torch.models import dense, encdec, hybrid, moe, rwkv6
from repro_torch.models.common import ArchConfig
from repro_torch.models.unet import (JAX_LEAVES, UNet, UNetConfig,
                                     jax_leaf_to_port, tree_leaves)

def unet_params_from_jax(tree, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX U-Net pytree (numpy leaves) -> the port's float32 state_dict."""
    expected = {k: tuple(v.shape)
                for k, v in UNet(cfg, device="meta").state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in tree_leaves(tree):
        leaf = np.asarray(leaf)
        if path[-1] not in JAX_LEAVES:
            raise KeyError(f"unmapped JAX U-Net leaf {'/'.join(path)}")
        if leaf.ndim != {"conv": 4, "dense": 2}.get(
                JAX_LEAVES[path[-1]][1], leaf.ndim):
            raise ValueError(f"{'/'.join(path)}: shape {leaf.shape} is not "
                             f"a {JAX_LEAVES[path[-1]][1]} leaf")
        key, arr = jax_leaf_to_port(path, leaf)
        if key not in expected:
            raise KeyError(f"JAX leaf {'/'.join(path)} maps to {key!r}, "
                           "which the port's UNet does not have")
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.shape != expected[key]:
            raise ValueError(f"{key}: converted shape {arr.shape} != port "
                             f"shape {expected[key]}")
        out[key] = torch.from_numpy(arr.copy())
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")
    return out


_UNET_INVERSE = {suffix: (name, kind)
                 for name, (suffix, kind) in JAX_LEAVES.items()}


def _listify(node):
    """Nested dicts whose keys are all decimal become lists (the JAX
    U-Net's ``downs`` / ``ups`` / ``blocks``)."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def unet_params_to_jax(state_dict, cfg: UNetConfig) -> Dict:
    """The port's U-Net state dict -> the JAX U-Net pytree (numpy float32
    leaves in JAX layouts: HWIO convs, (in, out) dense matrices)."""
    expected = UNet(cfg, device="meta").state_dict()
    if sorted(state_dict) != sorted(expected):
        raise KeyError("state dict keys differ from the port's UNet: "
                       f"{sorted(set(state_dict) ^ set(expected))[:5]}")
    tree: Dict = {}
    for key, t in state_dict.items():
        if tuple(t.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != the port's "
                             f"{tuple(expected[key].shape)}")
        parts = key.split(".")
        name, kind = _UNET_INVERSE[".".join(parts[-2:])]
        a = t.detach().float().cpu().numpy()
        if kind == "conv":
            a = a.transpose(2, 3, 1, 0)
        elif kind == "dense":
            a = a.T
        node = tree
        for p in parts[:-2]:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return _listify(tree)


def dlm_params_from_jax(tree, cfg: DiffusionLMConfig) -> Dict:
    """JAX diffusion-LM pytree (numpy leaves, any trunk family) -> the port's
    parameter dict on the CPU: same keys, same layouts, float32."""
    return _same_tree(tree, param_shapes(cfg), ())


def lm_param_shapes(cfg: ArchConfig) -> Dict:
    """The LM family's parameter tree as nested dicts of shapes."""
    shapes = {"dense": dense.param_shapes, "vlm": dense.param_shapes,
              "moe": moe.param_shapes, "ssm": rwkv6.param_shapes,
              "hybrid": hybrid.param_shapes, "audio": encdec.param_shapes}
    if cfg.family not in shapes:
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")
    return shapes[cfg.family](cfg)


def lm_params_from_jax(tree, cfg: ArchConfig) -> Dict:
    """JAX LM pytree of any family (numpy leaves) -> the port's parameter
    dict on the CPU: same keys, same layouts, float32."""
    return _same_tree(tree, lm_param_shapes(cfg), ())


def lm_params_to_jax(params, cfg: ArchConfig) -> Dict:
    """The port's LM parameter dict of any family -> the JAX pytree
    (nested dicts of float32 numpy arrays), every key and shape checked."""
    tree = _same_tree(params, lm_param_shapes(cfg), ())
    return map_leaves(tree, lambda t: t.numpy())


def map_leaves(tree, fn):
    """A nested dict of the same keys with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def _same_tree(tree, shapes, path: Tuple[str, ...]):
    where = "/".join(path) or "<root>"
    if isinstance(shapes, dict):
        if not isinstance(tree, dict):
            raise TypeError(f"{where}: expected a dict of leaves")
        extra = sorted(set(tree) - set(shapes))
        missing = sorted(set(shapes) - set(tree))
        if extra or missing:
            raise KeyError(f"{where}: unmapped JAX leaves {extra}, port "
                           f"parameters with no JAX leaf {missing}")
        return {k: _same_tree(tree[k], shapes[k], path + (k,))
                for k in shapes}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(tree), np.float32)
    if arr.shape != tuple(shapes):
        raise ValueError(f"{where}: JAX shape {arr.shape} != port shape "
                         f"{tuple(shapes)}")
    return torch.from_numpy(arr.copy())
