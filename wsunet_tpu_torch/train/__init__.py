from .checkpoint import (load_checkpoint, load_config, load_params,
                         save_checkpoint, save_config, save_params)
from .losses import get_loss, l1_loss, l1ws_loss, l2_loss, ws_loss

__all__ = ["load_config", "load_params", "save_config", "save_params",
           "save_checkpoint", "load_checkpoint", "get_loss", "l1_loss",
           "l2_loss", "ws_loss", "l1ws_loss"]
