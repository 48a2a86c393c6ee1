from .unet import UNet, get_model, init_unet
from .convert import unet_state_dict_from_flax

__all__ = ["UNet", "get_model", "init_unet", "unet_state_dict_from_flax"]
