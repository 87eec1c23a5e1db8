"""eps-models of the port (so far the paper's U-Net)."""
from .unet import UNet, UNetConfig, init_params, make_eps_fn

__all__ = ["UNet", "UNetConfig", "init_params", "make_eps_fn"]
