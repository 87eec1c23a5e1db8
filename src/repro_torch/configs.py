"""Model configurations of the port, as this package's own copies.

The paper's U-Net (``repro/configs/__init__.py``, DDIM App. D.1), the
smollm-135m dense architecture (``repro/configs/smollm_135m.py``) and the
diffusion-LM configurations the megakernel slice runs on it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.diffusion_lm.model import DiffusionLMConfig
from repro_torch.models.common import ArchConfig
from repro_torch.models.unet import UNetConfig

# CIFAR10-shaped faithful config (Ho et al. widths), about 36 M parameters
CIFAR10_UNET = UNetConfig(in_channels=3, base_width=128,
                          width_mults=(1, 2, 2, 2), n_res_blocks=2,
                          attn_levels=(1,), time_dim=512)

# small config used by the JAX package's CPU examples and benchmarks
TOY_UNET = UNetConfig(in_channels=3, base_width=32, width_mults=(1, 2),
                      n_res_blocks=1, attn_levels=(1,), time_dim=128)

# smollm-135m [dense], hf:HuggingFaceTB/SmolLM-135M (llama-arch small):
# 30 layers, d_model 576, 9 heads (GQA kv 3, head_dim 64), d_ff 1536
SMOLLM_135M = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOLLM_135M_SMOKE = ArchConfig(
    name="smollm-135m-smoke", family="dense",
    n_layers=2, d_model=192, n_heads=3, n_kv_heads=3, head_dim=64,
    d_ff=512, vocab=512,
    source=SMOLLM_135M.source,
)

# The diffusion-LM on the smollm-width trunk (time_dim 256, latent 32, the
# DiffusionLMConfig defaults).  DLM_SMOLLM_MEGA is cut to 2 layers: that is
# the depth at which weights + activations + state at batch 4 x 64 tokens
# fit MEGA_BUDGET (kernels/megastep/ops.py), so 'mega' runs fused.
# DLM_SMOLLM keeps all 30 layers and is not eligible: 'mega' runs it on the
# tile-resident loop.
DLM_SMOLLM_MEGA = DiffusionLMConfig(
    arch=dataclasses.replace(SMOLLM_135M, name="smollm-135m-2l", n_layers=2))
DLM_SMOLLM = DiffusionLMConfig(arch=SMOLLM_135M)
