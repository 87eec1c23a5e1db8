"""Models of the port: the paper's U-Net (the eps-model) and the dense
llama family with its KV-cache serving path, behind the family registry
(``get_api``)."""
from . import dense
from .common import ArchConfig
from .registry import FAMILIES, ModelApi, get_api
from .runtime_flags import FLAGS, PerfFlags, perf_flags
from .unet import UNet, UNetConfig, init_params, make_eps_fn

__all__ = ["ArchConfig", "FAMILIES", "FLAGS", "ModelApi", "PerfFlags",
           "UNet", "UNetConfig", "dense", "get_api", "init_params",
           "make_eps_fn", "perf_flags"]
