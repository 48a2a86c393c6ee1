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
maps a Flax checkpoint one to one.  Parameters stay f32 and OIHW;
``compute_dtype`` (f32 by default, bf16 for serving) is the type the
convolutions run in; on CUDA the f32 path runs with TF32 off.

``fast_conv`` picks the route of every 3x3 reflect conv, as in JAX:

- ``False`` (default): reflect pad, then cuDNN's ``F.conv2d``, NCHW.
- ``"borderfix"``: zero-padded SAME conv plus exact border corrections
  (``ops.reflect_conv``).
- ``True``: kernel B1 (``ops.fused_reflect_conv``), bias and ReLU fused.

Both fast routes take NHWC, so their activations are ``channels_last``:
the NHWC view ``h.permute(0, 2, 3, 1)`` of a channels-last tensor is
contiguous, and max pooling, the transposed convs and the skip concat
keep that layout.

``drop_rate`` adds ``UniformDropout`` on the input, after the cast to
``compute_dtype``: in training mode, dropped pixels are replaced by their
KB prediction (``kb_predict``), one mask shared across channels; in eval
mode it is the identity.  ``uniform_dropout`` is its pure core, given the
keep mask; in training mode the caller passes the mask (the trainer draws
it with the rest of a step's draws, ``train.train_unet.Sampler.draw``).

``init_unet`` fills a model as Flax's default initialisers do: every
kernel LeCun-normal (a normal cut at +-2 sigma, rescaled so that its
standard deviation is 1/sqrt(fan_in)), every bias zero.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import disable_tf32
from ..ops.fused_reflect_conv import conv3x3_reflect_fused
from ..ops.reflect_conv import conv3x3_reflect_borderfix
from .initializers import lecun_normal

WIDTHS = [64, 128, 256, 512, 1024]
FAST_CONV = (False, "borderfix", True)
_KB = np.array(
    [[-1, 2, -1],
     [2, 0, 2],
     [-1, 2, -1]], dtype="float32") / 4.0


def kb_predict(x: torch.Tensor) -> torch.Tensor:
    """KB-filter prediction of every pixel from its 8 neighbours, with
    reflect padding, per channel: [B, C, H, W] -> [B, C, H, W], in x's
    dtype."""
    c = x.shape[1]
    k = torch.as_tensor(_KB, dtype=x.dtype, device=x.device)
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                    k.expand(c, 1, 3, 3), groups=c)


def uniform_dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Keep the pixels where ``keep`` [B, 1, H, W] is 1 (or True) and
    replace the others, in every channel, by their KB prediction."""
    keep = keep.to(x.dtype)
    return x * keep + kb_predict(x) * (1.0 - keep)


class UniformDropout(nn.Module):
    """Replace a ``rate`` share of the pixels by their KB prediction, in
    training mode only (the reference's UniformDropout).  There the keep
    mask [B, 1, H, W] is required: the trainer's Sampler draws it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                keep: torch.Tensor = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if keep is None:
            raise ValueError("UniformDropout in training mode needs its "
                             "keep mask")
        return uniform_dropout(x, keep)


# the most elements F.pad's reflect mode takes on CUDA, which indexes in
# 32 bits (a bf16 batch of 128 at 512x512 x 64 channels is 2**31)
PAD_MAX_ELEMENTS = 2**31 - 1


def reflect_pad(x: torch.Tensor) -> torch.Tensor:
    """The one-pixel reflect padding of every 3x3 conv of the default
    route: [B, ..., H, W] -> [B, ..., H + 2, W + 2], a slice of the batch
    at a time where the output holds more than ``PAD_MAX_ELEMENTS``."""
    h, w = x.shape[-2:]
    out = x.numel() // (h * w) * (h + 2) * (w + 2)
    parts = -(-out // PAD_MAX_ELEMENTS)
    if parts == 1 or x.shape[0] == 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    return torch.cat([F.pad(c, (1, 1, 1, 1), mode="reflect")
                      for c in x.chunk(parts)])


class _Conv3x3Reflect(nn.Conv2d):
    """ReLU of a reflect-padded 3x3 conv (+ bias), in the dtype of the
    input, by the route ``fast`` names (see ``fast_conv`` above).  The
    default route pads with ``pad`` (``reflect_pad``; the row-sharded
    forward passes its halo exchange)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3)

    def forward(self, x, weight=None, fast=False, pad=reflect_pad):
        w = (self.weight if weight is None else weight).to(x.dtype)
        b = self.bias.to(x.dtype)
        if not fast:
            return F.relu(F.conv2d(pad(x), w, b))
        xn = x.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1)
        hwio = w.permute(2, 3, 1, 0).contiguous()
        conv = (conv3x3_reflect_borderfix if fast == "borderfix"
                else conv3x3_reflect_fused)
        return conv(xn, hwio, b, relu=True).permute(0, 3, 1, 2)


class _ConvBlock(nn.Module):
    """Two reflect-padded 3x3 convs with ReLU."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = _Conv3x3Reflect(in_channels, features)
        self.conv2 = _Conv3x3Reflect(features, features)

    def forward(self, x, fast=False, pad=reflect_pad):
        return self.conv2(self.conv1(x, fast=fast, pad=pad), fast=fast,
                          pad=pad)


class UNet(nn.Module):
    """nsteps-deep U-Net, sigmoid head, optional center-tap disabling.
    [B, C_in, H, W] -> [B, C_out, H, W] in the input's dtype."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 nsteps: int = 2, drop_rate: float = None,
                 disable_center: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 fast_conv=False):
        super().__init__()
        if not 0 <= nsteps <= 4:
            raise ValueError(f"nsteps must be in 0..4, got {nsteps}")
        if not any(fast_conv is v for v in FAST_CONV):
            raise ValueError(f"fast_conv must be one of {FAST_CONV}, got "
                             f"{fast_conv!r}")
        self.nsteps = nsteps
        self.compute_dtype = compute_dtype
        self.fast_conv = fast_conv
        self.input_dropout = (None if drop_rate is None
                              else UniformDropout(drop_rate))
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

    def forward(self, x: torch.Tensor, keep: torch.Tensor = None,
                pad=reflect_pad) -> torch.Tensor:
        """``keep``: the input dropout's mask [B, 1, H, W], required in
        training mode when ``drop_rate`` is set.  ``pad`` pads the input
        of every 3x3 conv on the default route by one pixel on each side
        (``parallel.spatial`` passes its halo exchange); the fast routes
        pad at their own tile edges and take only ``reflect_pad``."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype)
        if x.is_cuda and x.dtype == torch.float32:
            disable_tf32()
        if self.input_dropout is not None:
            x = self.input_dropout(x, keep=keep)
        fast = self.fast_conv
        if fast and pad is not reflect_pad:
            raise ValueError(f"fast_conv={fast!r} pads at its own tile "
                             f"edges and takes no other padding")
        h = self.e1_conv1(x, weight=self.e1_conv1.weight * self.center_mask,
                          fast=fast, pad=pad)
        h = self.e1_conv2(h, fast=fast, pad=pad)
        skips = [h]
        for step in range(1, self.nsteps + 1):
            h = F.max_pool2d(h, 2, stride=2)
            h = getattr(self, f"e{step + 1}")(h, fast=fast, pad=pad)
            skips.append(h)
        for step in range(self.nsteps, 0, -1):
            up = getattr(self, f"up{step}")
            h = F.conv_transpose2d(h, up.weight.to(h.dtype),
                                   up.bias.to(h.dtype), stride=2)
            h = torch.cat([h, skips[step - 1]], dim=1)
            h = getattr(self, f"d{step}")(h, fast=fast, pad=pad)
        out = F.conv2d(h, self.outconv.weight.to(h.dtype),
                       self.outconv.bias.to(h.dtype))
        return torch.sigmoid(out).to(in_dtype)


@torch.no_grad()
def init_unet(model: UNet, seed: int) -> UNet:
    """Fill every kernel from a seeded CPU generator as Flax's
    ``lecun_normal`` does (``variance_scaling(1, "fan_in",
    "truncated_normal")``: a standard normal cut at +-2, times
    1/sqrt(fan_in) / 0.8796..., so the standard deviation is
    1/sqrt(fan_in) and the support +-2.27/sqrt(fan_in)), and zero the
    biases.  The draws are torch's, not ``jax.random``'s: the distribution
    is JAX's, the values are not."""
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
        p.copy_(lecun_normal(p.shape, fan_in, gen))
    return model


def get_model(name: str, in_channels: int = 1, out_channels: int = 1,
              drop_rate: float = None, disable_center: bool = False,
              compute_dtype: torch.dtype = torch.float32,
              fast_conv=False) -> UNet:
    """Model factory; names are ``unet_<nsteps>``; ``fast_conv`` in
    ``FAST_CONV``."""
    if not name.lower().startswith("unet"):
        raise NotImplementedError(name)
    return UNet(in_channels=in_channels, out_channels=out_channels,
                nsteps=int(name.split("_")[1]), drop_rate=drop_rate,
                disable_center=disable_center, compute_dtype=compute_dtype,
                fast_conv=fast_conv)
