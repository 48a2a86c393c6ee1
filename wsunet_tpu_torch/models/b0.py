"""EfficientNet-B0 binary stego detector (port of
``wsunet_tpu/models/b0.py``), NCHW.

Stages, widths, the MBConv blocks with squeeze-excite and the switches are
the JAX package's:

- ``no_stem_stride``: the stem conv at stride 1, so every stage runs at
  twice the resolution of a normal B0;
- ``quadratic_stem``: the 8 products ``h[:, :8] * h[:, 8:16]`` of the stem
  conv's output appended before its norm (40 channels into stage 0);
- ``parity_features``: ``cos(pi * x255)`` of the first input plane
  appended as an input channel, computed in f32 before any cast, where
  x255 undoes the ImageNet green normalisation of ``detect.b0_eval``;
- ``norm``: ``"batch"`` (running statistics, eps 1e-3; Flax momentum 0.9
  is torch momentum 0.1) or ``"group"`` (groups of 8 channels, eps 1e-3).

Flax's ``padding="SAME"`` at stride 2 pads as TensorFlow does, by the
input size: on an even size k=3 pads 0 before and 1 after, k=5 1 and 2;
a symmetric ``padding=k // 2`` would shift every strided output.  So the
strided convs (the stem unless ``no_stem_stride``, and the depthwise conv
of the first block of stages 1, 2, 3 and 5) pad explicitly with
``_same_pad``; the stride-1 convs pad k // 2 on each side, which SAME is.

Parameters stay f32; ``compute_dtype`` (f32, or bf16) is the type the
convolutions and activations run in, the norms compute in f32, and the
classifier runs in f32 as in JAX.  Submodules carry the Flax names
(``conv_stem``, ``bn_stem``, ``stage<s>_block<b>.dw_conv``, ``se.reduce``,
``classifier``, ...), so ``convert.b0_state_dict_from_flax`` maps a Flax
checkpoint one to one.  The weights always come from a checkpoint here:
the high-pass stem initialiser belongs to training (not ported yet).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import disable_tf32

# (expand_ratio, channels, repeats, stride, kernel)
B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
STEM_WIDTH = 32
HEAD_WIDTH = 1280
QUAD_PAIRS = 8   # product channels appended by the quadratic stem


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad [B, C, H, W] as TensorFlow's (and XLA's) SAME does for a
    k x k window at ``stride``: ceil(size / stride) outputs, the odd pixel
    of the padding after."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):     # F.pad: last axis first
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Conv(nn.Conv2d):
    """A conv in the dtype of its input, with SAME padding (explicit and
    TF-style when strided)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(cin, cout, k, stride=stride,
                         padding=k // 2 if stride == 1 else 0,
                         groups=groups, bias=bias)

    def forward(self, x):
        if self.stride[0] != 1:
            x = _same_pad(x, self.kernel_size[0], self.stride[0])
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class _GroupNorm(nn.GroupNorm):
    """Group norm over groups of 8 channels, computed in f32 as Flax does
    (its statistics are promoted to f32), in the input's dtype out."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


def _make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "group":
        return _GroupNorm(channels // 8, channels, eps=1e-3)
    # any other kind is batch norm, as in JAX; in eval mode only the
    # running statistics matter
    return nn.BatchNorm2d(channels, eps=1e-3, momentum=0.1)


class _SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.reduce = _Conv(channels, reduced, 1, bias=True)
        self.expand = _Conv(reduced, channels, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class _MBConv(nn.Module):
    """Expand 1x1 (unless expand_ratio is 1), depthwise kxk, squeeze-excite
    (width from the block's input), project 1x1; the residual only when
    stride is 1 and the width is kept."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int,
                 stride: int, kernel: int, norm: str = "batch",
                 se_ratio: float = 0.25):
        super().__init__()
        mid = in_ch * expand_ratio
        self.residual = stride == 1 and in_ch == out_ch
        if expand_ratio != 1:
            self.expand_conv = _Conv(in_ch, mid, 1)
            self.expand_bn = _make_norm(norm, mid)
        self.dw_conv = _Conv(mid, mid, kernel, stride=stride, groups=mid)
        self.dw_bn = _make_norm(norm, mid)
        self.se = _SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        self.project_conv = _Conv(mid, out_ch, 1)
        self.project_bn = _make_norm(norm, out_ch)

    def forward(self, x):
        h = x
        if hasattr(self, "expand_conv"):
            h = F.silu(self.expand_bn(self.expand_conv(h)))
        h = F.silu(self.dw_bn(self.dw_conv(h)))
        h = self.project_bn(self.project_conv(self.se(h)))
        return h + x if self.residual else h


class EfficientNetB0(nn.Module):
    """[B, in_channels, H, W] (ImageNet-green normalised) -> logits [B,
    num_classes], f32."""

    def __init__(self, num_classes: int = 2, in_channels: int = 1,
                 no_stem_stride: bool = False, drop_rate: float = 0.2,
                 quadratic_stem: bool = False,
                 parity_features: bool = False, norm: str = "batch",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.quadratic_stem = quadratic_stem
        self.parity_features = parity_features
        self.compute_dtype = compute_dtype
        cin = in_channels + (1 if parity_features else 0)
        self.conv_stem = _Conv(cin, STEM_WIDTH, 3,
                               stride=1 if no_stem_stride else 2)
        width = STEM_WIDTH + (QUAD_PAIRS if quadratic_stem else 0)
        self.bn_stem = _make_norm(norm, width)
        for si, (t, c, n, s, k) in enumerate(B0_STAGES):
            for bi in range(n):
                self.add_module(f"stage{si}_block{bi}", _MBConv(
                    width, c, t, s if bi == 0 else 1, k, norm=norm))
                width = c
        self.conv_head = _Conv(width, HEAD_WIDTH, 1)
        self.bn_head = _make_norm(norm, HEAD_WIDTH)
        self.dropout = nn.Dropout(drop_rate)
        self.classifier = nn.Linear(HEAD_WIDTH, num_classes)

    def forward(self, x):
        if x.is_cuda and self.compute_dtype == torch.float32:
            disable_tf32()
        if self.parity_features:
            # recover the 0..255 scale in f32 before any cast: the parity
            # cosine needs the exact integer phase
            x255 = (x[:, :1].float() * 0.224 + 0.456) * 255.0
            x = torch.cat([x, torch.cos(math.pi * x255).to(x.dtype)], dim=1)
        h = self.conv_stem(x.to(self.compute_dtype))
        if self.quadratic_stem:
            h = torch.cat(
                [h, h[:, :QUAD_PAIRS] * h[:, QUAD_PAIRS:2 * QUAD_PAIRS]],
                dim=1)
        h = F.silu(self.bn_stem(h))
        for name, block in self.named_children():
            if name.startswith("stage"):
                h = block(h)
        h = F.silu(self.bn_head(self.conv_head(h)))
        h = self.dropout(h.mean(dim=(2, 3)))
        return self.classifier(h.float())


def get_b0(in_channels: int, num_classes: int = 2,
           no_stem_stride: bool = False, drop_rate: float = 0.2,
           quadratic_stem: bool = False, parity_features: bool = False,
           norm: str = "batch",
           compute_dtype: torch.dtype = torch.float32) -> EfficientNetB0:
    """Factory with the JAX ``get_b0``'s switches (``stem_init`` is a
    training option and is not taken)."""
    return EfficientNetB0(
        num_classes=num_classes, in_channels=in_channels,
        no_stem_stride=no_stem_stride, drop_rate=drop_rate,
        quadratic_stem=quadratic_stem, parity_features=parity_features,
        norm=norm, compute_dtype=compute_dtype)
