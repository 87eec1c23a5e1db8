"""Model configurations of the port, as this package's own copies.

The paper's U-Net (``repro/configs/__init__.py``, DDIM App. D.1), the four
dense architectures and their smoke variants (``repro/configs/{smollm_135m,
llama3_2_3b,deepseek_7b,mistral_large_123b}.py``), and the diffusion-LM
configurations the megakernel slice runs on the smollm widths.
``get(name)`` / ``get_smoke(name)`` resolve an ``--arch`` id; the JAX
package's six other ids (moe, ssm, hybrid, audio, vlm) raise
NotImplementedError naming their family.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.diffusion_lm.model import DiffusionLMConfig
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import refuse_unported
from repro_torch.models.unet import UNetConfig

# CIFAR10-shaped faithful config (Ho et al. widths), about 36 M parameters
CIFAR10_UNET = UNetConfig(in_channels=3, base_width=128,
                          width_mults=(1, 2, 2, 2), n_res_blocks=2,
                          attn_levels=(1,), time_dim=512)

# small config used by the JAX package's CPU examples and benchmarks
TOY_UNET = UNetConfig(in_channels=3, base_width=32, width_mults=(1, 2),
                      n_res_blocks=1, attn_levels=(1,), time_dim=128)

# ---- the dense architectures, field for field from repro/configs/*.py;
# SMOKE is each one's reduced same-family variant for CPU tests ----

# smollm-135m [dense], hf:HuggingFaceTB/SmolLM-135M (llama-arch small):
# 30 layers, d_model 576, 9 heads (GQA kv 3, head_dim 64), d_ff 1536,
# vocab 49152, tied embeddings
SMOLLM_135M = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOLLM_135M_SMOKE = ArchConfig(
    name="smollm-135m-smoke", family="dense",
    n_layers=2, d_model=192, n_heads=3, n_kv_heads=3, head_dim=64,
    d_ff=512, vocab=512, tie_embeddings=True,
    source=SMOLLM_135M.source,
)

# llama3.2-3b [dense], small llama3 (hf:meta-llama/Llama-3.2-1B family):
# 28 layers, d_model 3072, 24 heads (GQA kv 8, head_dim 128), d_ff 8192,
# vocab 128256
LLAMA3_2_3B = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, rope_theta=5e5, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)

LLAMA3_2_3B_SMOKE = ArchConfig(
    name="llama3.2-3b-smoke", family="dense",
    n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab=512, rope_theta=5e5, tie_embeddings=True,
    source=LLAMA3_2_3B.source,
)

# deepseek-7b [dense], llama-arch (arXiv:2401.02954): 30 layers, d_model
# 4096, 32 heads (kv 32 -> MHA, head_dim 128), d_ff 11008, vocab 102400
DEEPSEEK_7B = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=102400,
    source="arXiv:2401.02954",
)

DEEPSEEK_7B_SMOKE = ArchConfig(
    name="deepseek-7b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab=512,
    source=DEEPSEEK_7B.source,
)

# mistral-large-123b [dense], hf:mistralai/Mistral-Large-Instruct-2407:
# 88 layers, d_model 12288, 96 heads (GQA kv 8, head_dim 128), d_ff 28672,
# vocab 32768; ~123B parameters
MISTRAL_LARGE_123B = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768, rope_theta=1e6,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

MISTRAL_LARGE_123B_SMOKE = ArchConfig(
    name="mistral-large-123b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab=512, rope_theta=1e6,
    source=MISTRAL_LARGE_123B.source,
)

_DENSE = [(MISTRAL_LARGE_123B, MISTRAL_LARGE_123B_SMOKE),
          (LLAMA3_2_3B, LLAMA3_2_3B_SMOKE),
          (SMOLLM_135M, SMOLLM_135M_SMOKE),
          (DEEPSEEK_7B, DEEPSEEK_7B_SMOKE)]

# the JAX package's other assigned architectures: id -> family, none ported
UNPORTED_ARCHS = {
    "zamba2-2.7b": "hybrid", "kimi-k2-1t-a32b": "moe", "rwkv6-7b": "ssm",
    "seamless-m4t-large-v2": "audio", "deepseek-v2-236b": "moe",
    "llava-next-mistral-7b": "vlm",
}

ARCHS: Dict[str, ArchConfig] = {full.name: full for full, _ in _DENSE}
SMOKES: Dict[str, ArchConfig] = {full.name: smoke for full, smoke in _DENSE}

# every id, in the JAX package's order (repro/configs/__init__.py)
ARCH_IDS = ["mistral-large-123b", "llama3.2-3b", "zamba2-2.7b",
            "kimi-k2-1t-a32b", "rwkv6-7b", "seamless-m4t-large-v2",
            "deepseek-v2-236b", "smollm-135m", "deepseek-7b",
            "llava-next-mistral-7b"]


def _lookup(table: Dict[str, ArchConfig], name: str) -> ArchConfig:
    if name in table:
        return table[name]
    if name in UNPORTED_ARCHS:
        refuse_unported(UNPORTED_ARCHS[name], name)
    raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")


def get(name: str) -> ArchConfig:
    """The full configuration of an architecture id."""
    return _lookup(ARCHS, name)


def get_smoke(name: str) -> ArchConfig:
    """The reduced same-family variant used by CPU smoke tests."""
    return _lookup(SMOKES, name)


# The diffusion-LM on the smollm-width trunk (time_dim 256, latent 32, the
# DiffusionLMConfig defaults).  DLM_SMOLLM_MEGA is cut to 2 layers: that is
# the depth at which weights + activations + state at batch 4 x 64 tokens
# fit MEGA_BUDGET (kernels/megastep/ops.py), so 'mega' runs fused.
# DLM_SMOLLM keeps all 30 layers and is not eligible: 'mega' runs it on the
# tile-resident loop.
DLM_SMOLLM_MEGA = DiffusionLMConfig(
    arch=dataclasses.replace(SMOLLM_135M, name="smollm-135m-2l", n_layers=2))
DLM_SMOLLM = DiffusionLMConfig(arch=SMOLLM_135M)
