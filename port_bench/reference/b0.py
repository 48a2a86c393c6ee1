"""Plain PyTorch reference of ws-unet's EfficientNet-B0 detector
(EfficientNet-B0: Tan & Le, arXiv:1905.11946), float32, inference.

As published, with ws-unet's changes: the stem conv at stride 1
(``no_stem_stride``); the 8 products of stem channels 0-7 and 8-15
appended before the stem's norm (``quadratic_stem``, 40 channels into
stage 0); a second input plane, the image with its LSBs cleared
(``lsbr_reference``); both planes normalised with ImageNet's green
moments; a two-class head whose softmax gives P(stego).  Batch norm in
eval mode (running statistics, eps 1e-3), swish, squeeze-excite at a
quarter of the block's input width, TensorFlow's SAME padding at stride 2.
Weights come as a state dict (``harness.weights``) and are used as given;
the stages, the stem's stride and its quadratic width come from the
configuration's file.
"""

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-3
GREEN_MEAN, GREEN_STD = 0.456, 0.224


def _bn(x, sd, name):
    scale = sd[f"{name}.weight"] * torch.rsqrt(sd[f"{name}.running_var"] + EPS)
    shift = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _conv(x, w, stride=1, groups=1, bias=None):
    k = w.shape[-1]
    if stride == 1:
        return F.conv2d(x, w, bias, padding=k // 2, groups=groups)
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, bias, stride=stride, groups=groups)


def logits(sd: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[B, 2, H, W] normalised planes -> [B, 2] logits, with the stages,
    the stem's stride and its quadratic channels of the configuration
    ``cfg`` (``configs/efficientnet_b0_nostride.json``)."""
    h = _conv(x, sd["conv_stem.weight"],
              stride=1 if cfg["no_stem_stride"] else 2)
    if cfg["quadratic_stem"]:
        q = cfg["quadratic_width"]
        h = torch.cat([h, h[:, :q] * h[:, q:2 * q]], dim=1)
    h = F.silu(_bn(h, sd, "bn_stem"))
    width = h.shape[1]
    for si, (t, c, n, s, k) in enumerate(cfg["stages"]):
        for bi in range(n):
            p = f"stage{si}_block{bi}"
            stride = s if bi == 0 else 1
            x_in = h
            if t != 1:
                h = F.silu(_bn(_conv(h, sd[f"{p}.expand_conv.weight"]), sd,
                               f"{p}.expand_bn"))
            h = _conv(h, sd[f"{p}.dw_conv.weight"], stride=stride,
                      groups=h.shape[1])
            h = F.silu(_bn(h, sd, f"{p}.dw_bn"))
            se = h.mean(dim=(2, 3), keepdim=True)
            se = F.silu(F.conv2d(se, sd[f"{p}.se.reduce.weight"],
                                 sd[f"{p}.se.reduce.bias"]))
            se = F.conv2d(se, sd[f"{p}.se.expand.weight"],
                          sd[f"{p}.se.expand.bias"])
            h = h * torch.sigmoid(se)
            h = _bn(_conv(h, sd[f"{p}.project_conv.weight"]), sd,
                    f"{p}.project_bn")
            if stride == 1 and width == c:
                h = h + x_in
            width = c
    h = F.silu(_bn(_conv(h, sd["conv_head.weight"]), sd, "bn_head"))
    return F.linear(h.mean(dim=(2, 3)), sd["classifier.weight"],
                    sd["classifier.bias"])


@torch.no_grad()
def p_stego(sd: dict, pixels_u8: np.ndarray, device, cfg: dict,
            block: int = 16) -> np.ndarray:
    """P(stego), float64 numpy [N], of uint8 images [N, H, W]: the centre
    512 crop, /255, the LSB-cleared plane, ImageNet green normalisation,
    the network, softmax.  ``block`` images at a time."""
    out = []
    for i in range(0, len(pixels_u8), block):
        x = torch.as_tensor(pixels_u8[i:i + block], device=device)
        h, w = x.shape[-2:]
        top, left = max(0, (h - 512) // 2), max(0, (w - 512) // 2)
        x = x[:, None, top:top + 512, left:left + 512]
        ref = torch.bitwise_and(x, 0xFE)
        planes = torch.cat([x, ref], dim=1).to(torch.float32) / 255.0
        planes = (planes - GREEN_MEAN) / GREEN_STD
        out.append(torch.softmax(logits(sd, planes, cfg).double(), dim=1)[:, 1]
                   .cpu())
    return torch.cat(out).numpy()
