from .unet import UNet, get_model, init_unet
from .b0 import EfficientNetB0, get_b0
from .convert import b0_state_dict_from_flax, unet_state_dict_from_flax

__all__ = ["UNet", "get_model", "init_unet", "EfficientNetB0", "get_b0",
           "b0_state_dict_from_flax", "unet_state_dict_from_flax"]
