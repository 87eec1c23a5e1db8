"""Paper-faithful DDPM/DDIM U-Net eps-network (port of
``repro/models/unet.py``; Ho et al. 2020 §B, DDIM App. D.1).

Wide-ResNet blocks + sinusoidal time embedding + single-head
self-attention at the configured levels, down/up-sampling ladder.

Layout: the public ``UNet.forward`` takes and returns NHWC (B, H, W, C),
as the JAX model does — the sampler's tile layout flattens the state in
that order and the in-kernel noise is keyed on flat position.  Inside,
activations are NCHW for ``nn.Conv2d``.

Numerics follow the JAX model: convolutions have no bias; the stride-2
down-sample reproduces XLA's "SAME" padding (for an even input: 0 before,
1 after — not PyTorch's symmetric ``padding=1``); GroupNorm uses
min(groups, C) contiguous channel groups, population variance, eps 1e-5;
attention is a float32 softmax of q k^T / sqrt(C) written as plain
matmuls.  Dense layers are ``nn.Linear``, so their weights are the JAX
(in, out) matrices transposed (see ``repro_torch.interop``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .common import KeyGen, dense_init, sinusoidal_time_embedding

# init scale of the leaves the JAX model starts near zero (unet.py:65,89,158)
ZERO_INIT_SCALE = 1e-10


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    base_width: int = 128
    width_mults: Tuple[int, ...] = (1, 2, 2, 2)   # per resolution level
    n_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (1,)           # levels with self-attention
    time_dim: int = 512
    groups: int = 8                               # GroupNorm groups


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


def _group_norm(c: int, groups: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(groups, c), c, eps=1e-5)


def same_pad(h: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad an NCHW tensor as XLA's "SAME" does for a k x k conv at
    ``stride`` (the odd pixel of an uneven total goes AFTER)."""
    pads = []
    for size in (h.shape[3], h.shape[2]):             # F.pad order: W, H
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(h, pads)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, time_dim: int, groups: int):
        super().__init__()
        self.gn1 = _group_norm(cin, groups)
        self.conv1 = _conv3(cin, cout)
        self.time = nn.Linear(time_dim, cout)
        self.gn2 = _group_norm(cout, groups)
        self.conv2 = _conv3(cout, cout)
        self.skip = (nn.Conv2d(cin, cout, 1, bias=False) if cin != cout
                     else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.gn1(x)))
        h = h + self.time(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.gn2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class AttnBlock(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.gn = _group_norm(c, groups)
        self.wq = nn.Linear(c, c, bias=False)
        self.wk = nn.Linear(c, c, bias=False)
        self.wv = nn.Linear(c, c, bias=False)
        self.wo = nn.Linear(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        h = self.gn(x).reshape(N, C, H * W).transpose(1, 2)   # (N, HW, C)
        q, k, v = self.wq(h), self.wk(h), self.wv(h)
        att = torch.softmax((q @ k.transpose(1, 2)).float() / math.sqrt(C),
                            dim=-1).to(x.dtype)
        out = self.wo(att @ v)
        return x + out.transpose(1, 2).reshape(N, C, H, W)


class Block(nn.Module):
    """One residual block, with attention where the level has it."""

    def __init__(self, cin: int, cout: int, cfg: UNetConfig, attn: bool):
        super().__init__()
        self.res = ResBlock(cin, cout, cfg.time_dim, cfg.groups)
        self.attn = AttnBlock(cout, cfg.groups) if attn else None

    def forward(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.res(h, temb)
        return self.attn(h) if self.attn is not None else h


class Level(nn.Module):
    """One resolution level: its blocks, then the down- or up-sample conv
    (attribute ``down`` / ``up``, None at the ends of the ladder)."""

    def __init__(self, blocks: List[Block], down: Optional[nn.Conv2d] = None,
                 up: Optional[nn.Conv2d] = None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.down = down
        self.up = up


class UNet(nn.Module):
    """eps_theta(x_t, t): x (B, H, W, C) NHWC, t (B,) int -> (B, H, W, C)."""

    def __init__(self, cfg: UNetConfig, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self._build(cfg)

    def _build(self, cfg: UNetConfig) -> None:
        W0, tdim, g = cfg.base_width, cfg.time_dim, cfg.groups
        self.time_w1 = nn.Linear(W0, tdim)
        self.time_w2 = nn.Linear(tdim, tdim)
        self.conv_in = _conv3(cfg.in_channels, W0)
        widths = [W0 * m for m in cfg.width_mults]
        ch, skip_chs = W0, [W0]
        downs = []
        for lvl, w in enumerate(widths):
            blocks = []
            for _ in range(cfg.n_res_blocks):
                blocks.append(Block(ch, w, cfg, lvl in cfg.attn_levels))
                ch = w
                skip_chs.append(ch)
            down = None
            if lvl < len(widths) - 1:
                down = nn.Conv2d(ch, ch, 3, stride=2, bias=False)
                skip_chs.append(ch)
            downs.append(Level(blocks, down=down))
        self.downs = nn.ModuleList(downs)
        self.mid_res1 = ResBlock(ch, ch, tdim, g)
        self.mid_attn = AttnBlock(ch, g)
        self.mid_res2 = ResBlock(ch, ch, tdim, g)
        ups = []
        for lvl, w in reversed(list(enumerate(widths))):
            blocks = []
            for _ in range(cfg.n_res_blocks + 1):
                blocks.append(Block(ch + skip_chs.pop(), w, cfg,
                                    lvl in cfg.attn_levels))
                ch = w
            ups.append(Level(blocks, up=_conv3(ch, ch) if lvl > 0 else None))
        self.ups = nn.ModuleList(ups)
        self.gn_out = _group_norm(ch, g)
        self.conv_out = _conv3(ch, cfg.in_channels)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = sinusoidal_time_embedding(t, self.cfg.base_width).to(x.dtype)
        temb = self.time_w2(F.silu(self.time_w1(temb)))
        h = self.conv_in(x.permute(0, 3, 1, 2))
        skips = [h]
        for level in self.downs:
            for blk in level.blocks:
                h = blk(h, temb)
                skips.append(h)
            if level.down is not None:
                h = level.down(same_pad(h, 3, 2))
                skips.append(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, temb)), temb)
        for level in self.ups:
            for blk in level.blocks:
                h = blk(torch.cat([h, skips.pop()], dim=1), temb)
            if level.up is not None:
                h = level.up(F.interpolate(h, scale_factor=2,
                                           mode="nearest"))
        h = self.conv_out(F.silu(self.gn_out(h)))
        return h.permute(0, 2, 3, 1)


# JAX leaf name -> (port parameter suffix, conversion): conv kernels HWIO
# -> OIHW, dense (in, out) -> nn.Linear's (out, in), the rest as they are
JAX_LEAVES = {
    "time_w1": ("time_w1.weight", "dense"), "time_b1": ("time_w1.bias", ""),
    "time_w2": ("time_w2.weight", "dense"), "time_b2": ("time_w2.bias", ""),
    "time_w": ("time.weight", "dense"), "time_b": ("time.bias", ""),
    "wq": ("wq.weight", "dense"), "wk": ("wk.weight", "dense"),
    "wv": ("wv.weight", "dense"), "wo": ("wo.weight", "dense"),
    "gn1_s": ("gn1.weight", ""), "gn1_b": ("gn1.bias", ""),
    "gn2_s": ("gn2.weight", ""), "gn2_b": ("gn2.bias", ""),
    "gn_s": ("gn.weight", ""), "gn_b": ("gn.bias", ""),
    "gn_out_s": ("gn_out.weight", ""), "gn_out_b": ("gn_out.bias", ""),
    "conv_in": ("conv_in.weight", "conv"), "conv1": ("conv1.weight", "conv"),
    "conv2": ("conv2.weight", "conv"), "skip": ("skip.weight", "conv"),
    "down": ("down.weight", "conv"), "up": ("up.weight", "conv"),
    "conv_out": ("conv_out.weight", "conv"),
}


def _conv_init(key, k: int, cin: int, cout: int, dtype, scale=None):
    """HWIO (k, k, cin, cout) truncated normal, fan_in = k*k*cin."""
    std = scale if scale is not None else (k * k * cin) ** -0.5
    return dense_init(key, (k, k, cin, cout), dtype, scale=std)


def _init_resblock(kg: KeyGen, cin: int, cout: int, time_dim: int, dtype,
                   dev) -> Dict:
    p = {
        "gn1_s": torch.ones((cin,), dtype=dtype, device=dev),
        "gn1_b": torch.zeros((cin,), dtype=dtype, device=dev),
        "conv1": _conv_init(kg(), 3, cin, cout, dtype),
        "time_w": dense_init(kg(), (time_dim, cout), dtype),
        "time_b": torch.zeros((cout,), dtype=dtype, device=dev),
        "gn2_s": torch.ones((cout,), dtype=dtype, device=dev),
        "gn2_b": torch.zeros((cout,), dtype=dtype, device=dev),
        "conv2": _conv_init(kg(), 3, cout, cout, dtype,
                            scale=ZERO_INIT_SCALE),
    }
    if cin != cout:
        p["skip"] = _conv_init(kg(), 1, cin, cout, dtype)
    return p


def _init_attn(kg: KeyGen, c: int, dtype, dev) -> Dict:
    return {
        "gn_s": torch.ones((c,), dtype=dtype, device=dev),
        "gn_b": torch.zeros((c,), dtype=dtype, device=dev),
        "wq": dense_init(kg(), (c, c), dtype),
        "wk": dense_init(kg(), (c, c), dtype),
        "wv": dense_init(kg(), (c, c), dtype),
        "wo": dense_init(kg(), (c, c), dtype, scale=ZERO_INIT_SCALE),
    }


def init_tree(key: torch.Tensor, cfg: UNetConfig,
              dtype=torch.float32) -> Dict:
    """JAX's U-Net parameter pytree (``unet.py:101``: nesting, names, HWIO
    / (in, out) layouts) for a threefry key, drawn where the key lies, in
    its ``KeyGen`` order.  ``init_params`` loads it into a ``UNet``."""
    kg, dev = KeyGen(key), key.device
    W0, tdim = cfg.base_width, cfg.time_dim

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    params: Dict = {
        "time_w1": dense_init(kg(), (W0, tdim), dtype),
        "time_b1": zeros(tdim),
        "time_w2": dense_init(kg(), (tdim, tdim), dtype),
        "time_b2": zeros(tdim),
        "conv_in": _conv_init(kg(), 3, cfg.in_channels, W0, dtype),
    }
    widths = [W0 * m for m in cfg.width_mults]
    downs: List[Dict] = []
    ch = W0
    skip_chs = [ch]
    for lvl, w in enumerate(widths):
        blocks = []
        for _ in range(cfg.n_res_blocks):
            blk = {"res": _init_resblock(kg, ch, w, tdim, dtype, dev)}
            if lvl in cfg.attn_levels:
                blk["attn"] = _init_attn(kg, w, dtype, dev)
            blocks.append(blk)
            ch = w
            skip_chs.append(ch)
        entry: Dict = {"blocks": blocks}
        if lvl < len(widths) - 1:
            entry["down"] = _conv_init(kg(), 3, ch, ch, dtype)
            skip_chs.append(ch)
        downs.append(entry)
    params["downs"] = downs
    params["mid_res1"] = _init_resblock(kg, ch, ch, tdim, dtype, dev)
    params["mid_attn"] = _init_attn(kg, ch, dtype, dev)
    params["mid_res2"] = _init_resblock(kg, ch, ch, tdim, dtype, dev)
    ups: List[Dict] = []
    for lvl, w in reversed(list(enumerate(widths))):
        blocks = []
        for _ in range(cfg.n_res_blocks + 1):
            sc = skip_chs.pop()
            blk = {"res": _init_resblock(kg, ch + sc, w, tdim, dtype, dev)}
            if lvl in cfg.attn_levels:
                blk["attn"] = _init_attn(kg, w, dtype, dev)
            blocks.append(blk)
            ch = w
        entry = {"blocks": blocks}
        if lvl > 0:
            entry["up"] = _conv_init(kg(), 3, ch, ch, dtype)
        ups.append(entry)
    params["ups"] = ups
    params["gn_out_s"] = ones(ch)
    params["gn_out_b"] = zeros(ch)
    params["conv_out"] = _conv_init(kg(), 3, ch, cfg.in_channels, dtype,
                                    scale=ZERO_INIT_SCALE)
    return params


def jax_leaf_to_port(path: Tuple[str, ...], leaf):
    """(port state-dict key, leaf in the port's layout) of the JAX leaf at
    ``path`` (numpy array or tensor)."""
    suffix, kind = JAX_LEAVES[path[-1]]
    if kind == "conv":
        leaf = leaf.transpose(3, 2, 0, 1) if isinstance(leaf, np.ndarray) \
            else leaf.permute(3, 2, 0, 1)
    elif kind == "dense":
        leaf = leaf.T
    return ".".join(path[:-1] + (suffix,)), leaf


def tree_leaves(tree, path=()):
    """(path, leaf) of every leaf of a JAX-style tree of dicts and lists;
    list indices become decimal path entries."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (str(i),))
    else:
        yield path, tree


def init_params(key: torch.Tensor, cfg: UNetConfig,
                device: DeviceLike = None, dtype=torch.float32) -> UNet:
    """A UNet holding JAX's ``init_params(key, cfg, dtype)`` numbers: the
    JAX tree drawn on ``device`` (CUDA unless named, where the draws run)
    by ``init_tree`` and loaded into the module's layouts."""
    dev = resolve_device(device)
    model = UNet(cfg, device="meta").to_empty(device=dev).to(dtype)
    state = dict(model.named_parameters())
    filled = set()
    with torch.no_grad():
        for path, leaf in tree_leaves(init_tree(key.to(dev), cfg, dtype)):
            name, leaf = jax_leaf_to_port(path, leaf)
            state[name].copy_(leaf)
            filled.add(name)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")
    return model


def make_eps_fn(model: UNet):
    """Adapter to the sampler's eps_fn(x, t) signature (no autograd)."""
    def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(x, t)
    return eps_fn
