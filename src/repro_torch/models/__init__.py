"""Models of the port: the paper's U-Net (the eps-model), and the dense
llama family, the MoE family (MLA or GQA attention) and the VLM with
their cache serving paths, behind the family registry (``get_api``)."""
from . import dense, moe, vlm
from .common import ArchConfig
from .registry import FAMILIES, ModelApi, get_api
from .runtime_flags import FLAGS, PerfFlags, perf_flags
from .unet import UNet, UNetConfig, init_params, make_eps_fn

__all__ = ["ArchConfig", "FAMILIES", "FLAGS", "ModelApi", "PerfFlags",
           "UNet", "UNetConfig", "dense", "get_api", "init_params",
           "make_eps_fn", "moe", "perf_flags", "vlm"]
