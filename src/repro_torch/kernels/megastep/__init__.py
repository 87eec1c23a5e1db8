"""The sampler megakernel: eps trunk + Eq. 12 update, K steps per launch."""
from .ops import (DEFAULT_K_FUSE, MEGA_BUDGET, MegaSpec, eligible,
                  megastep_tiles)

__all__ = ["DEFAULT_K_FUSE", "MEGA_BUDGET", "MegaSpec", "eligible",
           "megastep_tiles"]
