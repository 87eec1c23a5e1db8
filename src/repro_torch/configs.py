"""Model configurations of the port, as this package's own copies.

The paper's U-Net (``repro/configs/__init__.py``, DDIM App. D.1), the
JAX package's ten assigned architectures (four dense, two MoE, the ssm,
the hybrid, the audio enc-dec and the VLM), each with its smoke variant
(``repro/configs/<id>.py``), and the diffusion-LM configurations the
megakernel slice runs on the smollm widths.  ``get(name)`` /
``get_smoke(name)`` resolve an ``--arch`` id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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

# deepseek-v2-236b [moe], MLA + 2 shared + 160 routed top-6
# (arXiv:2405.04434): 60 layers, d_model 5120, 128 heads with latent
# attention (kv_lora 512, q_lora 1536, qk_nope 128, qk_rope 64, v 128),
# expert d_ff 1536, vocab 102400; layer 0 a dense FFN of 12288
DEEPSEEK_V2_236B = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,               # dense layer-0 FFN (paper intermediate size)
    vocab=102400,
    n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
    capacity_factor=1.25,
    use_mla=True, kv_lora=512, q_lora=1536,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    source="arXiv:2405.04434",
)

DEEPSEEK_V2_236B_SMOKE = ArchConfig(
    name="deepseek-v2-236b-smoke", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512,
    n_experts=4, top_k=2, n_shared_experts=2, d_ff_expert=64,
    capacity_factor=2.0,
    use_mla=True, kv_lora=48, q_lora=64,
    qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
    source=DEEPSEEK_V2_236B.source,
)

# kimi-k2-1t-a32b [moe], trillion-parameter MoE: 61 layers, d_model 7168,
# 64 heads (GQA kv 8, head_dim 112), 384 routed experts top-8 (+1 shared),
# expert d_ff 2048, vocab 163840; layer 0 a dense FFN of 18432
KIMI_K2_1T_A32B = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=18432,               # dense layer-0 FFN (model card intermediate)
    vocab=163840,
    n_experts=384, top_k=8, n_shared_experts=1, d_ff_expert=2048,
    capacity_factor=1.25,
    source="arXiv:2501.kimi2",
)

KIMI_K2_1T_A32B_SMOKE = ArchConfig(
    name="kimi-k2-1t-a32b-smoke", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    n_experts=4, top_k=2, n_shared_experts=1, d_ff_expert=64,
    capacity_factor=2.0,
    source=KIMI_K2_1T_A32B.source,
)

# llava-next-mistral-7b [vlm], hf:llava-hf/llava-v1.6-mistral-7b-hf: the
# Mistral-7B backbone (32 layers, d_model 4096, 32 heads, GQA kv 8,
# head_dim 128, d_ff 14336, vocab 32000) over 2880 stub image embeddings
# (anyres: 576 base + 4 tiles x 576)
LLAVA_NEXT_MISTRAL_7B = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, rope_theta=1e6,
    n_ctx_embeds=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

LLAVA_NEXT_MISTRAL_7B_SMOKE = ArchConfig(
    name="llava-next-mistral-7b-smoke", family="vlm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, rope_theta=1e6,
    n_ctx_embeds=16,
    source=LLAVA_NEXT_MISTRAL_7B.source,
)

# zamba2-2.7b [hybrid] (arXiv:2411.15242): 54 Mamba2 layers, d_model
# 2560, ssm_state 64 (head dim 64, expand 2: 80 SSM heads), a shared
# attention block (32 heads, kv 32, head_dim 80) every 6 layers, d_ff
# 10240, vocab 32000
ZAMBA2_2_7B = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
    source="arXiv:2411.15242",
)

ZAMBA2_2_7B_SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, attn_every=2,
    source=ZAMBA2_2_7B.source,
)

# rwkv6-7b [ssm], Finch (arXiv:2404.05892): 32 layers, d_model 4096
# (attention-free: 64 wkv heads of size 64), d_ff 14336, vocab 65536
RWKV6_7B = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    source="arXiv:2404.05892",
)

RWKV6_7B_SMOKE = ArchConfig(
    name="rwkv6-7b-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512,
    source=RWKV6_7B.source,
)

# seamless-m4t-large-v2 [audio], the enc-dec backbone (arXiv:2308.11596):
# 24 encoder + 24 decoder layers, d_model 1024, 16 heads (kv 16 -> MHA,
# head_dim 64), d_ff 8192, vocab 256206, over 1024 stub frame embeddings
SEAMLESS_M4T_LARGE_V2 = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206,
    enc_layers=24, dec_layers=24, n_ctx_embeds=1024,
    source="arXiv:2308.11596",
)

SEAMLESS_M4T_LARGE_V2_SMOKE = ArchConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512,
    enc_layers=2, dec_layers=2, n_ctx_embeds=24,
    source=SEAMLESS_M4T_LARGE_V2.source,
)

# (full, smoke) in the JAX package's order (repro/configs/__init__.py)
_ALL = [(MISTRAL_LARGE_123B, MISTRAL_LARGE_123B_SMOKE),
        (LLAMA3_2_3B, LLAMA3_2_3B_SMOKE),
        (ZAMBA2_2_7B, ZAMBA2_2_7B_SMOKE),
        (KIMI_K2_1T_A32B, KIMI_K2_1T_A32B_SMOKE),
        (RWKV6_7B, RWKV6_7B_SMOKE),
        (SEAMLESS_M4T_LARGE_V2, SEAMLESS_M4T_LARGE_V2_SMOKE),
        (DEEPSEEK_V2_236B, DEEPSEEK_V2_236B_SMOKE),
        (SMOLLM_135M, SMOLLM_135M_SMOKE),
        (DEEPSEEK_7B, DEEPSEEK_7B_SMOKE),
        (LLAVA_NEXT_MISTRAL_7B, LLAVA_NEXT_MISTRAL_7B_SMOKE)]

ARCHS: Dict[str, ArchConfig] = {full.name: full for full, _ in _ALL}
SMOKES: Dict[str, ArchConfig] = {full.name: smoke for full, smoke in _ALL}
ARCH_IDS = list(ARCHS)


def get(name: str) -> ArchConfig:
    """The full configuration of an architecture id."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    """The reduced same-family variant used by CPU smoke tests."""
    if name not in SMOKES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return SMOKES[name]


# The diffusion-LM on the smollm-width trunk (time_dim 256, latent 32, the
# DiffusionLMConfig defaults).  DLM_SMOLLM_MEGA is cut to 2 layers: that is
# the depth at which weights + activations + state at batch 4 x 64 tokens
# fit MEGA_BUDGET (kernels/megastep/ops.py), so 'mega' runs fused.
# DLM_SMOLLM keeps all 30 layers and is not eligible: 'mega' runs it on the
# tile-resident loop.
DLM_SMOLLM_MEGA = DiffusionLMConfig(
    arch=dataclasses.replace(SMOLLM_135M, name="smollm-135m-2l", n_layers=2))
DLM_SMOLLM = DiffusionLMConfig(arch=SMOLLM_135M)
