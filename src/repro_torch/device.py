"""Device resolution for the port's entry points.

Every entry point (``DiffusionSampler``, ``UNet`` construction,
``init_params``) takes ``device=None`` meaning the CUDA card.  Without a
usable card that default raises: the port never falls back to the CPU
behind the caller's back.  Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device to run on: CUDA unless the caller names another.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and this PyTorch build sees no CUDA device.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (no-op off CUDA)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
