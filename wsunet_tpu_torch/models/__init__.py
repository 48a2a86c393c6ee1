from .unet import UNet, UniformDropout, get_model, init_unet, kb_predict
from .b0 import EfficientNetB0, get_b0, init_b0
from .convert import (b0_state_dict_from_flax, flax_b0_params_from_state_dict,
                      flax_params_from_unet_state_dict,
                      unet_state_dict_from_flax)

__all__ = ["UNet", "UniformDropout", "get_model", "init_unet", "kb_predict",
           "EfficientNetB0", "get_b0", "init_b0", "b0_state_dict_from_flax",
           "flax_b0_params_from_state_dict",
           "flax_params_from_unet_state_dict", "unet_state_dict_from_flax"]
