"""Core diffusion math (port of ``repro.core``): schedules, the solver and
the scalar-knob sampler adapter."""
from .sampler import SamplerConfig, sample
from .schedules import NoiseSchedule, make_schedule, make_tau
from .solver import AB_COEFS, MAX_ORDER, mix_history, warmup_weights

__all__ = ["NoiseSchedule", "SamplerConfig", "make_schedule", "make_tau",
           "sample", "AB_COEFS", "MAX_ORDER", "mix_history",
           "warmup_weights"]
