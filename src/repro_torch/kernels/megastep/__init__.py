"""The sampler megakernels: eps trunk + Eq. 12 update, K lockstep steps per
launch (B3) or one scheduler tick per launch (B4)."""
from .ops import (DEFAULT_K_FUSE, MEGA_BUDGET, MegaSpec, eligible,
                  megastep_rows, megastep_tiles)

__all__ = ["DEFAULT_K_FUSE", "MEGA_BUDGET", "MegaSpec", "eligible",
           "megastep_rows", "megastep_tiles"]
