"""Carry weights from the JAX package's parameter pytrees to the port.

The input is a JAX ``init_params`` (or trained) pytree already converted
to numpy arrays — nested dicts and lists of ``np.ndarray`` — so this
module never imports jax.

Dense-family mapping (``repro/models/dense.py`` ->
``repro_torch.models.dense``), for the autoregressive server: the same
nested dict, every leaf a float32 tensor in its JAX layout (stacked
layer leaves, (in, out) matrices); ``dense_params_to_jax`` is the inverse
(numpy leaves), so the ``{"params": ...}`` checkpoint the JAX
``serve_lm --ckpt`` restores crosses both ways.

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

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.diffusion_lm.model import DiffusionLMConfig, param_shapes
from repro_torch.models import dense
from repro_torch.models.common import ArchConfig
from repro_torch.models.unet import UNet, UNetConfig

_CONV = "conv"
_DENSE = "dense"
_PLAIN = "plain"

# JAX leaf name -> (port parameter suffix, conversion)
_UNET_LEAVES = {
    "time_w1": ("time_w1.weight", _DENSE), "time_b1": ("time_w1.bias", _PLAIN),
    "time_w2": ("time_w2.weight", _DENSE), "time_b2": ("time_w2.bias", _PLAIN),
    "time_w": ("time.weight", _DENSE), "time_b": ("time.bias", _PLAIN),
    "wq": ("wq.weight", _DENSE), "wk": ("wk.weight", _DENSE),
    "wv": ("wv.weight", _DENSE), "wo": ("wo.weight", _DENSE),
    "gn1_s": ("gn1.weight", _PLAIN), "gn1_b": ("gn1.bias", _PLAIN),
    "gn2_s": ("gn2.weight", _PLAIN), "gn2_b": ("gn2.bias", _PLAIN),
    "gn_s": ("gn.weight", _PLAIN), "gn_b": ("gn.bias", _PLAIN),
    "gn_out_s": ("gn_out.weight", _PLAIN),
    "gn_out_b": ("gn_out.bias", _PLAIN),
    "conv_in": ("conv_in.weight", _CONV), "conv1": ("conv1.weight", _CONV),
    "conv2": ("conv2.weight", _CONV), "skip": ("skip.weight", _CONV),
    "down": ("down.weight", _CONV), "up": ("up.weight", _CONV),
    "conv_out": ("conv_out.weight", _CONV),
}


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                              np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, np.asarray(tree)


def _convert(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == _CONV:
        if a.ndim != 4:
            raise ValueError(f"conv kernel must be HWIO, got shape {a.shape}")
        return a.transpose(3, 2, 0, 1)
    if kind == _DENSE:
        if a.ndim != 2:
            raise ValueError(f"dense matrix must be 2-D, got {a.shape}")
        return a.T
    return a


def unet_params_from_jax(tree, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX U-Net pytree (numpy leaves) -> the port's float32 state_dict."""
    expected = {k: tuple(v.shape)
                for k, v in UNet(cfg, device="meta").state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        name = path[-1]
        if name not in _UNET_LEAVES:
            raise KeyError(f"unmapped JAX U-Net leaf {'/'.join(path)}")
        suffix, kind = _UNET_LEAVES[name]
        key = ".".join(path[:-1] + (suffix,))
        if key not in expected:
            raise KeyError(f"JAX leaf {'/'.join(path)} maps to {key!r}, "
                           "which the port's UNet does not have")
        arr = np.ascontiguousarray(_convert(leaf, kind), np.float32)
        if arr.shape != expected[key]:
            raise ValueError(f"{key}: converted shape {arr.shape} != port "
                             f"shape {expected[key]}")
        out[key] = torch.from_numpy(arr.copy())
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")
    return out


_UNET_INVERSE = {suffix: (name, kind)
                 for name, (suffix, kind) in _UNET_LEAVES.items()}


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
        if kind == _CONV:
            a = a.transpose(2, 3, 1, 0)
        elif kind == _DENSE:
            a = a.T
        node = tree
        for p in parts[:-2]:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return _listify(tree)


def dlm_params_from_jax(tree, cfg: DiffusionLMConfig) -> Dict:
    """JAX diffusion-LM pytree (numpy leaves, dense family) -> the port's
    parameter dict on the CPU: same keys, same layouts, float32."""
    return _same_tree(tree, param_shapes(cfg), ())


def dense_params_from_jax(tree, cfg: ArchConfig) -> Dict:
    """JAX dense-family pytree (numpy leaves) -> the port's parameter dict
    on the CPU: same keys, same layouts, float32."""
    return _same_tree(tree, dense.param_shapes(cfg), ())


def dense_params_to_jax(params, cfg: ArchConfig) -> Dict:
    """The port's dense parameter dict -> the JAX pytree (nested dicts of
    float32 numpy arrays), every key and shape checked."""
    tree = _same_tree(params, dense.param_shapes(cfg), ())
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
