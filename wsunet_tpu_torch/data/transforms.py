"""Image transforms (port of ``wsunet_tpu/data/transforms.py``; this
slice needs only ``center_crop``)."""

import torch


def center_crop(x: torch.Tensor, size: int = 512) -> torch.Tensor:
    """CenterCrop of the last two axes, [..., H, W] (torchvision
    CenterCrop parity for even overhang).  The JAX version crops
    [..., H, W, C]; the port keeps images channel-free or NCHW."""
    h, w = x.shape[-2], x.shape[-1]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return x[..., top:top + size, left:left + size]
