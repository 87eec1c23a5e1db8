"""The paper's U-Net configurations (port of ``repro/configs/__init__.py``,
DDIM App. D.1), as this package's own copy."""
from __future__ import annotations

from repro_torch.models.unet import UNetConfig

# CIFAR10-shaped faithful config (Ho et al. widths), about 36 M parameters
CIFAR10_UNET = UNetConfig(in_channels=3, base_width=128,
                          width_mults=(1, 2, 2, 2), n_res_blocks=2,
                          attn_levels=(1,), time_dim=512)

# small config used by the JAX package's CPU examples and benchmarks
TOY_UNET = UNetConfig(in_channels=3, base_width=32, width_mults=(1, 2),
                      n_res_blocks=1, attn_levels=(1,), time_dim=128)
