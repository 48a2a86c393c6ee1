from .estimate import attack_batches, attack_sweep, parse_filter_model
from .estimate import run as ws_run
from .filters_eval import filters_sweep, mae_wmae
from .filters_eval import run as filters_run
from .unet_eval import (get_unet_estimator, infer_unet, load_pretrained_unet,
                        predict_batch, predict_sweep)
from .unet_eval import run as unet_run

__all__ = ["attack_batches", "attack_sweep", "parse_filter_model", "ws_run",
           "filters_sweep", "mae_wmae", "filters_run",
           "get_unet_estimator", "infer_unet", "load_pretrained_unet",
           "predict_batch", "predict_sweep", "unet_run"]
