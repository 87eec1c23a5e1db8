"""Core diffusion math (port of ``repro.core``): schedules, the solver,
the scalar-knob sampler adapter and the scheduler's single-step API."""
from .sampler import (SamplerConfig, StepStates, sample, sample_step,
                      slot_tile_step, step_table)
from .schedules import NoiseSchedule, make_schedule, make_tau
from .solver import AB_COEFS, MAX_ORDER, mix_history, warmup_weights

__all__ = ["NoiseSchedule", "SamplerConfig", "StepStates", "make_schedule",
           "make_tau", "sample", "sample_step", "slot_tile_step",
           "step_table", "AB_COEFS", "MAX_ORDER", "mix_history",
           "warmup_weights"]
