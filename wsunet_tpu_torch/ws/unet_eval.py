"""U-Net inference + WS prediction error (port of the array part of
``wsunet_tpu/ws/unet_eval.py``).

- ``infer_unet``: center-crop 512, /255 -> model -> crop 1-px border ->
  x255, batched.
- ``predict_batch``: the batch step of the JAX ``_predict_frame``: uint8
  [B, H, W] -> (beta_hat, l1) per image with the unweighted, unclipped
  U-Net WS variant.

The catalog/CSV ``run`` and the Orbax checkpoint loader wait for a later
slice; a model comes in as a torch ``UNet`` (``models.convert`` maps Flax
weights onto it).
"""

import typing

import torch

from .._device import resolve_device
from ..data.transforms import center_crop
from ..ops.ws import ws_estimate_unet
from ..utils.errors import UserError


def _to_device(model: torch.nn.Module, x, device) -> torch.Tensor:
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise UserError(f"the model is on {p.device}, the call asks for "
                        f"{dev}; move it with model.to(device)")
    return torch.as_tensor(x, device=dev)


@torch.no_grad()
def infer_unet(model, x, device=None) -> torch.Tensor:
    """[B, H, W] f32 pixels (0..255) -> [B, 510, 510] prediction
    (0..255), on ``device`` (None = CUDA)."""
    x = _to_device(model, x, device).to(torch.float32)
    xc = center_crop(x, 512)[:, None] / 255.0
    y = model(xc)
    return y[:, 0, 1:-1, 1:-1].to(torch.float32) * 255.0


@torch.no_grad()
def predict_batch(model, pixels_u8, device=None
                  ) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W] -> (beta_hat [B], l1 [B]), on ``device``."""
    x = _to_device(model, pixels_u8, device).to(torch.float32)
    x_hat = infer_unet(model, x, device=x.device)
    return ws_estimate_unet(center_crop(x, 512), x_hat)
