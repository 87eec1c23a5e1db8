"""Blockwise online-softmax attention: the CUDA kernel, its plain version
and the MHA / GQA layout wrappers."""
from .kernel import flash_attention
from .ops import gqa_flash, mha_flash

__all__ = ["flash_attention", "gqa_flash", "mha_flash"]
