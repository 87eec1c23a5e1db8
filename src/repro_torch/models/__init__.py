"""Models of the port: the paper's U-Net (the eps-model), and the LM
families with their cache serving paths, behind the family registry
(``get_api``): the dense llama family, the MoE family (MLA or GQA
attention), rwkv6 (ssm), the Mamba2 hybrid, the enc-dec (audio) and the
VLM."""
from . import dense, encdec, hybrid, mamba2, moe, rwkv6, vlm
from .common import ArchConfig
from .registry import FAMILIES, ModelApi, get_api
from .runtime_flags import FLAGS, PerfFlags, perf_flags
from .unet import UNet, UNetConfig, init_params, make_eps_fn

__all__ = ["ArchConfig", "FAMILIES", "FLAGS", "ModelApi", "PerfFlags",
           "UNet", "UNetConfig", "dense", "encdec", "get_api", "hybrid",
           "init_params", "make_eps_fn", "mamba2", "moe", "perf_flags",
           "rwkv6", "vlm"]
