"""Gradient saliency of the U-Net predictor (port of the core of
``wsunet_tpu/analyses/saliency.py``).

- ``unet_saliency``: the gradient of one output pixel of a torch ``UNet``
  with respect to the input image, by ``torch.autograd`` where JAX takes
  ``jax.grad``.  With ``fast_conv=True`` the forward runs kernel B1 and
  the backward the VJP of its plain version (``ops.fused_reflect_conv``).
- ``sobel_locations``: the interesting-point finder (Sobel gradients
  through ``ops.filter_predict``, then ratio maxima and box-filtered
  gradient-magnitude extrema), on the CPU.

The model comes in as a torch ``UNet``: the checkpoint lookup of the JAX
version (``get_model_name``, Orbax restore) waits for a checkpoint format
the port can read, and so does ``plot_saliency_grid``.
"""

import typing

import numpy as np
import torch

from .._device import resolve_device
from ..io import imread_gray_u8
from ..ops.filters import filter_predict
from ..utils.errors import UserError

SOBEL_H = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype="float32")
SOBEL_V = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype="float32")
BOX9 = np.ones((3, 3), dtype="float32")


def sobel_locations(fname) -> typing.Dict[str, tuple]:
    """gh_max / gv_max / g_max / g_min interesting points of an image
    file (indices into the VALID filter grid, as in the JAX package)."""
    x = torch.from_numpy(imread_gray_u8(fname).astype("float32"))[None]
    gh = filter_predict(x, SOBEL_H)[0].numpy()
    gv = filter_predict(x, SOBEL_V)[0].numpy()
    g = filter_predict(torch.from_numpy(np.sqrt(gh ** 2 + gv ** 2))[None],
                       BOX9)[0].numpy()
    return {
        "gh_max": np.unravel_index(np.abs(gh / (.1 + gv)).argmax(), gh.shape),
        "gv_max": np.unravel_index(np.abs(gv / (.1 + gh)).argmax(), gv.shape),
        "g_max": np.unravel_index(g.argmax(), g.shape),
        "g_min": np.unravel_index(g.argmin(), g.shape),
    }


def unet_saliency(model, image_u8: np.ndarray, i: int, j: int, n: int = 8,
                  device=None) -> np.ndarray:
    """(2n+1)x(2n+1) patch around (i, j) of the gradient of output pixel
    (i, j) with respect to the input pixels (0..255), times 255: the
    gradient with respect to the model's input x/255.  ``image_u8`` is
    [H, W]; ``device=None`` means CUDA, and the model must lie there."""
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise UserError(f"the model is on {p.device}, the call asks for "
                        f"{dev}; move it with model.to(device)")
    img = np.asarray(image_u8)
    if img.ndim != 2:
        raise ValueError(f"expected an [H, W] image, got {img.shape}")
    x = torch.as_tensor(img, dtype=torch.float32, device=dev)
    x.requires_grad_(True)
    y = model((x / 255.0)[None, None])
    (grad,) = torch.autograd.grad(y[0, 0, i, j], x)
    slc = grad.cpu().numpy() * 255.0
    return slc[i - n:i + n + 1, j - n:j + n + 1]
