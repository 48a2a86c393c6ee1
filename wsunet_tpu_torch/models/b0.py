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
- ``norm``: ``"batch"`` (``FlaxBatchNorm``: running statistics, eps 1e-3,
  updated in training mode as Flax's ``BatchNorm(momentum=0.9)`` updates
  them) or ``"group"`` (groups of 8 channels, eps 1e-3);
- ``stem_init``: ``"highpass"`` seeds the stem with the steganalysis
  extractors of the JAX ``_highpass_stem_init`` (``init_b0``).

Flax's ``padding="SAME"`` at stride 2 pads as TensorFlow does, by the
input size: on an even size k=3 pads 0 before and 1 after, k=5 1 and 2;
a symmetric ``padding=k // 2`` would shift every strided output.  So the
strided convs (the stem unless ``no_stem_stride``, and the depthwise conv
of the first block of stages 1, 2, 3 and 5) pad explicitly with
``_same_pad``; the stride-1 convs pad k // 2 on each side, which SAME is.

In eval mode with batch norm, an f32 forward on the card runs the middle
of each MBConv block (the expand norm and SiLU, the SAME-padded depthwise
conv, its norm and SiLU, the squeeze-excite mean) as one launch of kernel
B3 (``ops.fused_mbconv_dw``; ``_MBConv.takes_b3``); training mode, group
norm, bf16 and the CPU run the modules' own composition.

Parameters stay f32; ``compute_dtype`` (f32, or bf16) is the type the
convolutions and activations run in, the norms compute in f32, and the
classifier runs in f32 as in JAX.  Submodules carry the Flax names
(``conv_stem``, ``bn_stem``, ``stage<s>_block<b>.dw_conv``, ``se.reduce``,
``classifier``, ...), so ``convert.b0_state_dict_from_flax`` maps a Flax
checkpoint one to one and ``convert.flax_b0_params_from_state_dict`` maps
it back.

For training (``train.train_b0``):

- ``init_b0`` fills a model as Flax's default initialisers do (every conv
  kernel and the classifier's kernel LeCun-normal with the fan-in of the
  Flax HWIO / [in, out] shape, zero biases, unit norm scales, running
  mean 0 and variance 1), and with ``stem_init="highpass"`` overwrites the
  stem's first 16 output channels with the JAX package's fixed
  extractors, bit for bit;
- ``FlaxBatchNorm`` normalises with the biased batch variance in training
  mode, as ``nn.BatchNorm2d`` does, but also moves its running variance
  towards the biased one (``nn.BatchNorm2d`` takes the unbiased variance
  there, n / (n - 1) times larger);
- the head dropout (``HeadDropout``) takes its keep mask [B, 1280] from
  the caller in training mode, so a step can replay Flax's mask (the
  trainer's ``B0Sampler.draw`` draws it).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import disable_tf32
from ..ops import fused_mbconv_dw
from ..utils import profiling
from .initializers import lecun_normal

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


class FlaxBatchNorm(nn.BatchNorm2d):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-3)`` over NCHW.

    Eval mode normalises with the running statistics (``nn.BatchNorm2d``'s
    own forward).  Training mode computes the statistics in f32 as Flax
    does (mean and mean of squares, var = max(0, E[x^2] - E[x]^2), the
    biased variance), normalises with them, and moves the running
    statistics: ``r = 0.9 * r + 0.1 * batch``, the variance biased too.

    With a ``mesh`` (``set_batch_norm_mesh``) each rank holds a block of
    the global batch, and the statistics are those of the global batch,
    as JAX's batch-sharded batch norm reduces over the whole batch axis:
    the per-channel sums and sums of squares are summed over the ranks by
    an all-reduce that carries their gradient, and the running statistics
    move identically on every rank."""

    mesh = None

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-3, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.mesh is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
        else:
            sums = self.mesh.all_reduce_autograd(torch.stack([
                xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]))
            count = xf.shape[0] * xf.shape[2] * xf.shape[3] * self.mesh.world
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
            self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + \
            self.bias[:, None, None]
        return y.to(x.dtype)


def set_batch_norm_mesh(model: nn.Module, mesh) -> None:
    """Make every ``FlaxBatchNorm`` of ``model`` take its training-mode
    statistics over the global batch of ``mesh`` (a ``parallel.Mesh``
    with a process group), or, with None, over its own input."""
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm):
            m.mesh = mesh


def _make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "group":
        return _GroupNorm(channels // 8, channels, eps=1e-3)
    # any other kind is batch norm, as in JAX
    return FlaxBatchNorm(channels)


class HeadDropout(nn.Module):
    """Flax's ``nn.Dropout(rate)`` on the pooled features: in training
    mode the kept features are scaled by 1 / (1 - rate) and the others
    zeroed.  There the keep mask (bool, x's shape) is required, so a
    training step can replay Flax's."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, keep: torch.Tensor = None):
        if not self.training or self.rate == 0.0:
            return x
        if keep is None:
            raise ValueError("HeadDropout in training mode needs its keep "
                             "mask")
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class _SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.reduce = _Conv(channels, reduced, 1, bias=True)
        self.expand = _Conv(reduced, channels, 1, bias=True)

    def forward(self, x, s=None):
        """``s``: the mean of ``x`` over each plane, [B, C, 1, 1], where
        the caller has it (kernel B3's sums); else it is taken here."""
        if s is None:
            s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


def _stats(bn: FlaxBatchNorm, dtype: torch.dtype):
    return fused_mbconv_dw.BatchNormStats(
        bn.weight.to(dtype), bn.bias.to(dtype), bn.running_mean.to(dtype),
        bn.running_var.to(dtype), bn.eps)


class _MBConv(nn.Module):
    """Expand 1x1 (unless expand_ratio is 1), depthwise kxk, squeeze-excite
    (width from the block's input), project 1x1; the residual only when
    stride is 1 and the width is kept.

    Where ``takes_b3`` holds, the middle of the block (the expand norm and
    SiLU, the SAME-padded depthwise conv, its norm and SiLU, and the
    squeeze-excite mean) runs as one launch of kernel B3
    (``ops.fused_mbconv_dw``); elsewhere as the modules' own composition.
    Each forward counts ``b0.dw_kernel.hit`` or ``.miss``
    (``utils.profiling``)."""

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

    def takes_b3(self, h) -> bool:
        """Whether the depthwise stage of ``h`` (the expand conv's output)
        runs through B3: in eval mode (training needs batch statistics),
        with batch norm, on an f32 CUDA tensor."""
        return (not self.training and isinstance(self.dw_bn, FlaxBatchNorm)
                and h.dtype == torch.float32 and h.is_cuda)

    def forward(self, x):
        h = x
        expand = hasattr(self, "expand_conv")
        if expand:
            h = self.expand_conv(h)
        if self.takes_b3(h):
            profiling.count("b0.dw_kernel.hit")
            h, s = fused_mbconv_dw.mbconv_dw(
                h.contiguous(), self.dw_conv.weight.to(h.dtype),
                _stats(self.dw_bn, h.dtype),
                _stats(self.expand_bn, h.dtype) if expand else None,
                stride=self.dw_conv.stride[0])
            h = self.se(h, (s / (h.shape[2] * h.shape[3]))[:, :, None, None])
        else:
            profiling.count("b0.dw_kernel.miss")
            if expand:
                h = F.silu(self.expand_bn(h))
            h = self.se(F.silu(self.dw_bn(self.dw_conv(h))))
        h = self.project_bn(self.project_conv(h))
        return h + x if self.residual else h


class EfficientNetB0(nn.Module):
    """[B, in_channels, H, W] (ImageNet-green normalised) -> logits [B,
    num_classes], f32."""

    def __init__(self, num_classes: int = 2, in_channels: int = 1,
                 no_stem_stride: bool = False, drop_rate: float = 0.2,
                 stem_init: str = "default", quadratic_stem: bool = False,
                 parity_features: bool = False, norm: str = "batch",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem_init = stem_init
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
        self.dropout = HeadDropout(drop_rate)
        self.classifier = nn.Linear(HEAD_WIDTH, num_classes)

    def forward(self, x, keep: torch.Tensor = None):
        """``keep``: the head dropout's mask [B, 1280], required in
        training mode when ``drop_rate`` is not 0."""
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
        h = self.dropout(h.mean(dim=(2, 3)), keep=keep)
        # in the parameters' dtype: f32 as in JAX (f64 for a model moved
        # to float64 as a reference)
        return self.classifier(h.to(self.classifier.weight.dtype))


def dw_shapes(side: int, no_stem_stride: bool = False,
              quadratic_stem: bool = False) -> list:
    """(C, H, k, stride, prologue) of the depthwise stage of each of the
    16 MBConv blocks of a forward on a side x side image, in order: the
    shapes of kernel B3's launches (the stage's input is H x H, C wide;
    ``prologue``: the block has an expand conv)."""
    size = side if no_stem_stride else -(-side // 2)
    width = STEM_WIDTH + (QUAD_PAIRS if quadratic_stem else 0)
    out = []
    for t, c, n, s, k in B0_STAGES:
        for b in range(n):
            stride = s if b == 0 else 1
            out.append((width * t, size, k, stride, t != 1))
            size = -(-size // stride)
            width = c
    return out


# steganalysis high-pass kernels (the JAX package's _HP_KERNELS): KB
# residual, 2nd differences, diagonals, laplacian-like
HP_KERNELS = [
    [[-1, 2, -1], [2, -4, 2], [-1, 2, -1]],
    [[0, 0, 0], [1, -2, 1], [0, 0, 0]],
    [[0, 1, 0], [0, -2, 0], [0, 1, 0]],
    [[1, 0, 0], [0, -2, 0], [0, 0, 1]],
    [[0, 0, 1], [0, -2, 0], [1, 0, 0]],
    [[1, 1, 1], [1, -8, 1], [1, 1, 1]],
    [[0, -1, 0], [-1, 4, -1], [0, -1, 0]],
    [[-1, -1, -1], [2, 2, 2], [-1, -1, -1]],
]


def highpass_stem(base: torch.Tensor) -> torch.Tensor:
    """The JAX ``_highpass_stem_init`` on an OIHW stem kernel ``base`` (its
    LeCun-normal draw): a 3x3 kernel keeps ``base`` in output channels 16
    and up; outputs 0-7 become the LSB-plane extractor (+8 times the
    centre tap on input 0, -8 times it on input 1) when the kernel has at
    least two input planes (parity or LSBr-reference plane included), and
    the high-pass bank / 4 on input 0 otherwise; outputs 8-15 the bank / 4
    on input 0.  Every other input plane of outputs 0-15 is 0."""
    cout, cin, kh, kw = base.shape
    if (kh, kw) != (3, 3):
        return base
    kernels = [np.asarray(k, np.float32) / 4.0 for k in HP_KERNELS]
    center = np.zeros((3, 3), np.float32)
    center[1, 1] = 1.0
    fixed = np.zeros((cout, cin, 3, 3), np.float32)
    n_seed = min(2 * QUAD_PAIRS, cout)
    for o in range(n_seed):
        if o < QUAD_PAIRS:
            if cin >= 2:
                fixed[o, 0] = center * 8.0
                fixed[o, 1] = -center * 8.0
            else:
                fixed[o, 0] = kernels[o % len(kernels)]
        else:
            fixed[o, 0] = kernels[(o - QUAD_PAIRS) % len(kernels)]
    out = base.clone()
    out[:n_seed] = torch.from_numpy(fixed[:n_seed]).to(base.dtype)
    return out


@torch.no_grad()
def init_b0(model: EfficientNetB0, seed: int) -> EfficientNetB0:
    """Fill ``model`` from a seeded CPU generator with Flax's defaults:
    conv kernels LeCun-normal with fan-in k*k*(C_in / groups) (k*k for
    the depthwise convs), the classifier's kernel with fan-in 1280, zero
    biases, norm scales 1 and biases 0, running mean 0 and variance 1.
    The model's ``stem_init`` (``get_b0``'s switch) ``"highpass"`` then
    seeds the stem (``highpass_stem``).  The draws are torch's, not
    ``jax.random``'s: the distribution is JAX's, the values are not (the
    high-pass channels are)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(lecun_normal(mod.weight.shape, fan_in, gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
            mod.reset_parameters()
    if model.stem_init == "highpass":
        model.conv_stem.weight.copy_(highpass_stem(model.conv_stem.weight))
    return model


def get_b0(in_channels: int, num_classes: int = 2,
           no_stem_stride: bool = False, drop_rate: float = 0.2,
           stem_init: str = "default", quadratic_stem: bool = False,
           parity_features: bool = False, norm: str = "batch",
           compute_dtype: torch.dtype = torch.float32) -> EfficientNetB0:
    """Factory with the JAX ``get_b0``'s switches (``stem_init`` takes
    effect in ``init_b0``)."""
    return EfficientNetB0(
        num_classes=num_classes, in_channels=in_channels,
        no_stem_stride=no_stem_stride, drop_rate=drop_rate,
        stem_init=stem_init, quadratic_stem=quadratic_stem,
        parity_features=parity_features, norm=norm,
        compute_dtype=compute_dtype)
