"""Checkpoints as path-keyed ``.npz`` files (port of
``repro/training/checkpoint.py``, the same file format).

A tree (nested dicts, lists and tuples of tensors or numpy arrays; a
module's state dict is a flat dict) is flattened in the JAX package's
leaf order — dict keys sorted, sequences in index order — to numpy arrays
stored under ``"<index>|<path>"`` with ``"/"``-joined path names, beside a
JSON ``__meta__``.  A file saved by either package restores in the other:
restore maps the stored leaves onto ``like``'s leaves by position and
checks every shape.  For the U-Net, ``repro_torch.interop`` carries a
JAX-layout tree (``unet_params_to_jax``) to the port's state dict
(``unet_params_from_jax``) and back.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

_SEP = "/"
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _flatten(tree, path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in the JAX package's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


def _unflatten(like, leaves: Iterator):
    """A tree of ``like``'s structure with the next leaves filled in."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array; float types numpy lacks (bfloat16)
    are stored as float32, as the JAX package stores its ml_dtypes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_floating_point() and t.dtype not in _NUMPY_FLOATS:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    return arr if arr.dtype.kind in "fiub" else arr.astype(np.float32)


def save(path: str, tree: Tree, step: Optional[int] = None) -> str:
    """Atomically write the tree to <path>. Returns the final filename."""
    arrays = {f"{i:05d}|{_SEP.join(p)}": _to_numpy(leaf)
              for i, (p, leaf) in enumerate(_flatten(tree))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    os.close(fd)
    meta = {"step": step, "n_leaves": len(arrays)}
    np.savez(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    if os.path.exists(tmp):  # np.savez appended .npz; drop the mkstemp stub
        os.remove(tmp)
    return path


def restore(path: str, like: Tree) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``like`` (shapes verified). Each leaf
    takes the dtype of ``like``'s leaf, and its device when that is a
    tensor."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        keys = sorted(k for k in data.files if k != "__meta__")
        leaves_like = [leaf for _, leaf in _flatten(like)]
        if len(keys) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {len(keys)} leaves, expected "
                f"{len(leaves_like)}")
        new_leaves: List = []
        for k, ref in zip(keys, leaves_like):
            arr = data[k]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch at {k}: {arr.shape} vs "
                                 f"{tuple(ref.shape)}")
            if isinstance(ref, torch.Tensor):
                new_leaves.append(torch.from_numpy(np.array(arr)).to(
                    device=ref.device, dtype=ref.dtype))
            else:
                new_leaves.append(np.asarray(arr, dtype=ref.dtype))
    return _unflatten(like, iter(new_leaves)), meta


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for f in os.listdir(directory):
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)\.npz", f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, f), int(m.group(1))
    return best


def save_step(directory: str, step: int, tree: Tree,
              keep: int = 3, prefix: str = "ckpt_") -> str:
    """Save ckpt_<step>.npz and garbage-collect old ones."""
    path = os.path.join(directory, f"{prefix}{step:08d}.npz")
    save(path, tree, step=step)
    ckpts = sorted(f for f in os.listdir(directory)
                   if re.fullmatch(rf"{re.escape(prefix)}\d+\.npz", f))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(directory, old))
    return path
