"""Training of the port (``repro/training``): the optimizers, the train
and serve step builders, and ``checkpoint`` (the JAX package's path-keyed
``.npz`` format)."""
from . import checkpoint
from .optim import (AdafactorConfig, AdafactorState, AdamWConfig,
                    AdamWState, adafactor_init, adafactor_update, adamw_init,
                    adamw_update, clip_by_global_norm, constant, ema_init,
                    ema_update, global_norm, warmup_cosine)
from .steps import (TrainState, init_train_state, lm_loss_fn,
                    make_decode_step, make_diffusion_train_step,
                    make_lm_train_step, make_prefill_step, module_loss)

__all__ = ["AdamWConfig", "AdamWState", "AdafactorConfig",
           "AdafactorState", "adafactor_init", "adafactor_update",
           "adamw_init", "adamw_update", "ema_init", "ema_update",
           "warmup_cosine", "constant", "global_norm", "clip_by_global_norm",
           "TrainState", "init_train_state", "make_lm_train_step",
           "make_diffusion_train_step", "make_prefill_step",
           "make_decode_step", "lm_loss_fn", "module_loss", "checkpoint"]
