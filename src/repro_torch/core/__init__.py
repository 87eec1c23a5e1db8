"""Core diffusion math (port of ``repro.core``): schedules and the solver."""
from .schedules import NoiseSchedule, make_schedule, make_tau
from .solver import AB_COEFS, MAX_ORDER, mix_history, warmup_weights

__all__ = ["NoiseSchedule", "make_schedule", "make_tau", "AB_COEFS",
           "MAX_ORDER", "mix_history", "warmup_weights"]
