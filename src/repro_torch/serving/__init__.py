"""Serving surfaces of the port (so far the lockstep DiffusionSampler)."""
from .engine import DiffusionSampler

__all__ = ["DiffusionSampler"]
