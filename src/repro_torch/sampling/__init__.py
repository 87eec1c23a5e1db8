"""Declarative sampler front door (port of ``repro.sampling``)."""
from .plan import SamplerPlan
from .specs import SigmaSpec, TauSpec, X0Policy

__all__ = ["SamplerPlan", "SigmaSpec", "TauSpec", "X0Policy"]
