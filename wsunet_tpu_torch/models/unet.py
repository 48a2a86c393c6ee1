"""U-Net cover-pixel predictor (port of ``wsunet_tpu/models/unet.py``),
NCHW.

- encoder: per step, two [3x3 reflect-padded conv + ReLU], then 2x2
  maxpool; widths 64 -> 1024, ``nsteps`` in 0..4
- decoder: 2x2 stride-2 transposed conv, concat ``[up, skip]``, then two
  [3x3 reflect conv + ReLU]
- head: 1x1 conv + sigmoid
- ``disable_center`` zeroes the center tap of the very first conv, as a
  multiplicative mask on its kernel.

Submodules carry the Flax module names (``e1_conv1``, ``e2.conv1``,
``up2``, ``d1.conv2``, ``outconv``), so ``convert.unet_state_dict_from_flax``
maps a Flax checkpoint one to one.  Parameters stay f32; ``compute_dtype``
(f32 by default, bf16 for serving) is the type the convolutions run in.
The convolutions are cuDNN's ``F.conv2d``, as the JAX package leaves them
to XLA; on CUDA the f32 path runs with TF32 off.  ``UniformDropout`` is a
training-time module (the identity at eval) and waits for the training
slice.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import disable_tf32

WIDTHS = [64, 128, 256, 512, 1024]


class _Conv3x3Reflect(nn.Conv2d):
    """Reflect pad 1 px, then a VALID 3x3 conv (+ bias), in the dtype of
    the input."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3)

    def forward(self, x, weight=None):
        w = self.weight if weight is None else weight
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                        w.to(x.dtype), self.bias.to(x.dtype))


class _ConvBlock(nn.Module):
    """Two reflect-padded 3x3 convs with ReLU."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = _Conv3x3Reflect(in_channels, features)
        self.conv2 = _Conv3x3Reflect(features, features)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class UNet(nn.Module):
    """nsteps-deep U-Net, sigmoid head, optional center-tap disabling.
    [B, C_in, H, W] -> [B, C_out, H, W] in the input's dtype."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 nsteps: int = 2, disable_center: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if not 0 <= nsteps <= 4:
            raise ValueError(f"nsteps must be in 0..4, got {nsteps}")
        self.nsteps = nsteps
        self.compute_dtype = compute_dtype
        self.e1_conv1 = _Conv3x3Reflect(in_channels, WIDTHS[0])
        self.e1_conv2 = _Conv3x3Reflect(WIDTHS[0], WIDTHS[0])
        for step in range(1, nsteps + 1):
            self.add_module(f"e{step + 1}",
                            _ConvBlock(WIDTHS[step - 1], WIDTHS[step]))
        for step in range(nsteps, 0, -1):
            self.add_module(f"up{step}", nn.ConvTranspose2d(
                WIDTHS[step], WIDTHS[step - 1], 2, stride=2))
            self.add_module(f"d{step}",
                            _ConvBlock(2 * WIDTHS[step - 1], WIDTHS[step - 1]))
        self.outconv = nn.Conv2d(WIDTHS[0], out_channels, 1)
        mask = torch.ones(1, 1, 3, 3)
        if disable_center:
            mask[0, 0, 1, 1] = 0.0
        self.register_buffer("center_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.to(self.compute_dtype)
        if x.is_cuda and x.dtype == torch.float32:
            disable_tf32()
        h = F.relu(self.e1_conv1(
            x, weight=self.e1_conv1.weight * self.center_mask))
        h = F.relu(self.e1_conv2(h))
        skips = [h]
        for step in range(1, self.nsteps + 1):
            h = F.max_pool2d(h, 2, stride=2)
            h = getattr(self, f"e{step + 1}")(h)
            skips.append(h)
        for step in range(self.nsteps, 0, -1):
            up = getattr(self, f"up{step}")
            h = F.conv_transpose2d(h, up.weight.to(h.dtype),
                                   up.bias.to(h.dtype), stride=2)
            h = torch.cat([h, skips[step - 1]], dim=1)
            h = getattr(self, f"d{step}")(h)
        out = F.conv2d(h, self.outconv.weight.to(h.dtype),
                       self.outconv.bias.to(h.dtype))
        return torch.sigmoid(out).to(in_dtype)


@torch.no_grad()
def init_unet(model: UNet, seed: int) -> UNet:
    """Fill every kernel from a seeded generator, LeCun-normal like Flax's
    default initializer (std = 1/sqrt(fan_in)), and zero the biases, so a
    model at full width can run without a checkpoint."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        if isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                      nn.ConvTranspose2d):
            fan_in = p.shape[0] * p.shape[2] * p.shape[3]
        else:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
        p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
    return model


def get_model(name: str, in_channels: int = 1, out_channels: int = 1,
              disable_center: bool = False,
              compute_dtype: torch.dtype = torch.float32) -> UNet:
    """Model factory; names are ``unet_<nsteps>``."""
    if not name.lower().startswith("unet"):
        raise NotImplementedError(name)
    return UNet(in_channels=in_channels, out_channels=out_channels,
                nsteps=int(name.split("_")[1]),
                disable_center=disable_center, compute_dtype=compute_dtype)
