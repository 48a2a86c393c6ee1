"""Plain PyTorch reference of the ws-unet U-Net predictor and its WS
estimate (uibk-uncover/ws-unet, ``src/unet/model/unet.py``), float32.

No kernel, cache or batching of the program: every 3x3 conv is a reflect
pad of one pixel and ``F.conv2d``, the decoder upsamples with a 2x2
stride-2 transposed conv and concatenates ``[up, skip]``, the head is a
1x1 conv and a sigmoid.  Weights come as a state dict
(``harness.weights``) and are used as given.  TF32 is switched off here
unless a caller asks for it (the control runs this in TF32).
"""

import numpy as np
import torch
import torch.nn.functional as F


def _conv3x3_relu(x, sd, name):
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.relu(F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"]))


def depth(sd: dict) -> int:
    """The U-Net's number of down steps, from its weights."""
    return sum(1 for k in sd if k.startswith("up") and k.endswith(".weight"))


def forward(sd: dict, x: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W] in [0, 1] -> [B, 1, H, W] prediction in [0, 1]."""
    nsteps = depth(sd)
    h = _conv3x3_relu(x, sd, "e1_conv1")
    h = _conv3x3_relu(h, sd, "e1_conv2")
    skips = [h]
    for s in range(1, nsteps + 1):
        h = F.max_pool2d(h, 2, stride=2)
        h = _conv3x3_relu(h, sd, f"e{s + 1}.conv1")
        h = _conv3x3_relu(h, sd, f"e{s + 1}.conv2")
        skips.append(h)
    for s in range(nsteps, 0, -1):
        h = F.conv_transpose2d(h, sd[f"up{s}.weight"], sd[f"up{s}.bias"],
                               stride=2)
        h = torch.cat([h, skips[s - 1]], dim=1)
        h = _conv3x3_relu(h, sd, f"d{s}.conv1")
        h = _conv3x3_relu(h, sd, f"d{s}.conv2")
    return torch.sigmoid(F.conv2d(h, sd["outconv.weight"], sd["outconv.bias"]))


def center_crop(x: torch.Tensor, size: int = 512) -> torch.Tensor:
    """The centred size x size window of the last two axes (all of an axis
    shorter than size)."""
    h, w = x.shape[-2:]
    top, left = max(0, (h - size) // 2), max(0, (w - size) // 2)
    return x[..., top:top + size, left:left + size]


@torch.no_grad()
def ws_predict(sd: dict, pixels_u8: np.ndarray, device,
               block: int = 16) -> tuple:
    """(beta_hat, l1), float64 numpy [N], of uint8 images [N, H, W]: the
    centre 512 crop, the U-Net's prediction of every pixel but the
    one-pixel border, and over that interior the WS estimate
    mean((x - x^1)(x - x_hat)) (x^1: the LSB flipped) and the mean
    absolute prediction error, in 0..255 units.  Runs ``block`` images at
    a time; the means are taken in float64."""
    beta, l1 = [], []
    for i in range(0, len(pixels_u8), block):
        x = torch.as_tensor(pixels_u8[i:i + block], device=device)
        x = center_crop(x.to(torch.float32))
        y = forward(sd, x[:, None] / 255.0)[:, 0, 1:-1, 1:-1] * 255.0
        x1 = x[:, 1:-1, 1:-1]
        x1_bar = torch.bitwise_xor(x1.to(torch.uint8), 1).to(torch.float32)
        d = (x1 - y).double()
        beta.append(((x1 - x1_bar).double() * d).mean(dim=(1, 2)).cpu())
        l1.append(d.abs().mean(dim=(1, 2)).cpu())
    return torch.cat(beta).numpy(), torch.cat(l1).numpy()
