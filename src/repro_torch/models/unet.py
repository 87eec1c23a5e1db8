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
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .common import sinusoidal_time_embedding

# init scale of the leaves the JAX model starts near zero (unet.py:65,89,158)
ZERO_INIT_LEAVES = ("conv2.weight", "wo.weight", "conv_out.weight")
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


def init_params(cfg: UNetConfig, generator: torch.Generator,
                device: DeviceLike = None) -> UNet:
    """A UNet with the JAX model's init scheme, drawn from ``generator``
    (a CPU generator; the draw is the same whatever the target device).

    Conv and dense weights: truncated normal on [-3, 3] times fan_in^-0.5
    (fan_in = k*k*cin for convs, in-features for dense), except the
    ZERO_INIT_LEAVES at 1e-10; biases 0; GroupNorm scale 1, shift 0.
    Same scheme as the JAX ``init_params``, not the same numbers.
    """
    dev = resolve_device(device)
    model = UNet(cfg, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() < 2:
                is_gn_scale = name.endswith("weight")
                p.fill_(1.0 if is_gn_scale else 0.0)
                continue
            fan_in = p[0].numel()            # cin*k*k (conv) / in (dense)
            std = (ZERO_INIT_SCALE if name.endswith(ZERO_INIT_LEAVES)
                   else fan_in ** -0.5)
            nn.init.trunc_normal_(p, 0.0, 1.0, -3.0, 3.0,
                                  generator=generator)
            p.mul_(std)
    return model.to(dev)


def make_eps_fn(model: UNet):
    """Adapter to the sampler's eps_fn(x, t) signature (no autograd)."""
    def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(x, t)
    return eps_fn
