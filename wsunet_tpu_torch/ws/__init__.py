from .estimate import attack_sweep, parse_filter_model
from .unet_eval import infer_unet, predict_batch

__all__ = ["attack_sweep", "parse_filter_model", "infer_unet",
           "predict_batch"]
