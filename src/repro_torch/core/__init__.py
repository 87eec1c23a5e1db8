"""Core diffusion math (port of ``repro.core``): schedules, the solver,
the forward process and losses, the scalar-knob sampler adapter and the
scheduler's single-step API, the ODE view (encode / decode) and latent
interpolation, the v-prediction and classifier-free-guidance adapters
(``extensions``) and the paper's App. A multinomial process
(``discrete``).  ddim_sample / ddpm_sample / multistep_sample are
deprecated shims."""
from . import discrete
from .diffusion import (eps_from_x0, gamma_weights, posterior_sigma,
                        predict_x0, q_sample, sigma_hat, simple_loss,
                        training_loss)
from .extensions import (cfg_eps_fn, eps_fn_from_v_fn, eps_from_v,
                         v_from_eps_x0, v_training_target, x0_from_v)
from .interpolate import slerp, slerp_grid
from .ode import decode, encode, multistep_sample, probability_flow_sample
from .sampler import (SamplerConfig, StepStates, ddim_sample, ddpm_sample,
                      sample, sample_step, slot_tile_step, step_table,
                      trajectory_coefficients)
from .schedules import NoiseSchedule, make_schedule, make_tau
from .solver import AB_COEFS, MAX_ORDER, mix_history, warmup_weights

__all__ = ["NoiseSchedule", "make_schedule", "make_tau",
           "q_sample", "predict_x0", "eps_from_x0", "posterior_sigma",
           "sigma_hat", "gamma_weights", "simple_loss", "training_loss",
           "SamplerConfig", "StepStates", "trajectory_coefficients",
           "sample", "sample_step", "slot_tile_step", "step_table",
           "ddim_sample", "ddpm_sample",
           "encode", "decode", "probability_flow_sample", "multistep_sample",
           "slerp", "slerp_grid", "discrete",
           "v_from_eps_x0", "eps_from_v", "x0_from_v", "eps_fn_from_v_fn",
           "v_training_target", "cfg_eps_fn",
           "AB_COEFS", "MAX_ORDER", "mix_history", "warmup_weights"]
