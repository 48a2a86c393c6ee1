"""Weighted-stego (WS) change-rate estimation (port of
``wsunet_tpu/ops/ws.py``).

- ``ws_attack``: uint8-domain LSB flip, a weighted sum with uniform 1/N
  or (inverse-)variance weights, clip at 0, optional bias correction.
- ``ws_estimate_unet``: the U-Net variant: mean instead of a weighted
  sum, no clipping, 1-px border crop applied to x before the product.

Everything operates on [B, H, W] batches on the device of its input.
"""

import typing

import numpy as np
import torch

from .filters import NAMED_FILTERS_2D, conv2d_valid, filter_predict


def lsb_flip_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """x ^ 1 in the uint8 domain."""
    return torch.bitwise_xor(x_u8.to(torch.uint8), 1)


def ws_weights(x: torch.Tensor, weighted: int,
               mean_kernel=None) -> torch.Tensor:
    """Per-pixel weights over the VALID interior, [B, H-2, W-2].

    weighted == 0 : uniform 1/N
    weighted == 1 : 1 / (5 + local variance), normalized per image
    weighted == -1: (5 + local variance), normalized per image
    """
    B, H, W = x.shape
    n = (H - 2) * (W - 2)
    if weighted == 0:
        return torch.full((B, H - 2, W - 2), 1.0 / n, dtype=x.dtype,
                          device=x.device)
    if mean_kernel is None:
        mean_kernel = NAMED_FILTERS_2D["AVG"]
    k = np.asarray(mean_kernel, dtype="float32")[::-1, ::-1]
    mu = conv2d_valid(x, k)
    mu2 = conv2d_valid(x * x, k)
    var = mu2 - mu * mu
    w = 1.0 / (5.0 + var) if int(weighted) == 1 else (5.0 + var)
    return w / torch.sum(w, dim=(1, 2), keepdim=True)


def ws_attack(
    x_u8: torch.Tensor,
    pixel_kernel=None,
    pixel_estimator: typing.Callable = None,
    mean_kernel=None,
    weighted: int = 0,
    correct_bias: bool = False,
) -> torch.Tensor:
    """WS attack on a uint8 batch [B, H, W] -> beta_hat [B].

    The pixel predictor is either a 3x3 kernel (KB/AVG path) or a callable
    ``f32 [B,H,W] -> [B,H-2,W-2]`` (the U-Net path)."""
    x = x_u8.to(torch.float32)
    x_bar = lsb_flip_u8(x_u8).to(torch.float32)

    if pixel_estimator is None:
        def pixel_estimator(v):
            return filter_predict(v, pixel_kernel)
    x_hat = pixel_estimator(x)

    w = ws_weights(x, weighted, mean_kernel)

    x1 = x[:, 1:-1, 1:-1]
    x1_bar = x_bar[:, 1:-1, 1:-1]
    beta_hat = torch.sum(w * (x1 - x1_bar) * (x1 - x_hat), dim=(1, 2))
    beta_hat = torch.clamp(beta_hat, min=0.0)

    if correct_bias:
        x_bias = pixel_estimator(x_bar - x)
        beta_hat = beta_hat - beta_hat * torch.sum(
            w * (x1 - x1_bar) * x_bias, dim=(1, 2))
    return beta_hat


def ws_estimate_unet(
    x: torch.Tensor,
    x_hat: torch.Tensor,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """(beta_hat, l1) per image for a U-Net prediction.

    x is the f32 luminance [B, H, W], x_hat the model output cropped to
    [B, H-2, W-2]; the LSB flip happens on x cast to uint8 (before the
    XOR, as the JAX package and the reference do); the mean is unweighted
    and unclipped."""
    x1 = x[:, 1:-1, 1:-1]
    x1_bar = lsb_flip_u8(x1.to(torch.uint8)).to(torch.float32)
    beta_hat = torch.mean((x1 - x1_bar) * (x1 - x_hat), dim=(1, 2))
    l1 = torch.mean(torch.abs(x1 - x_hat), dim=(1, 2))
    return beta_hat, l1
