"""Restormer as a cover-pixel predictor (Zamir et al., "Restormer:
Efficient Transformer for High-Resolution Image Restoration", CVPR 2022,
arXiv:2111.09881; github.com/swz30/Restormer,
``basicsr/models/archs/restormer_arch.py``), NCHW, float32.

``restormer_gray`` is the published grayscale Gaussian-denoising
configuration (``Denoising/Options/GaussianGrayDenoising_Restormer.yml``):
one input and one output plane, ``dim`` 48, ``num_blocks`` [4, 6, 6, 8],
4 refinement blocks, ``heads`` [1, 2, 4, 8], ``ffn_expansion_factor``
2.66, no conv bias, the bias-free layer norm, no dual-pixel branch;
26,109,076 parameters.  A denoiser maps a noisy image to its clean
estimate, the U-Net predictor's job in ``unet-eval``: stego in, cover
estimate out, on the same [B, 1, H, W] pixels in [0, 1].

- A four-level encoder-decoder: ``patch_embed`` (3x3 conv, 1 -> 48);
  levels of (channels, heads, blocks) (48, 1, 4), (96, 2, 6), (192, 4, 6)
  and the latent (384, 8, 8); ``down`` is a 3x3 conv C -> C/2 and
  ``pixel_unshuffle(2)``, ``up`` a 3x3 conv C -> 2C and
  ``pixel_shuffle(2)``; decoders 3 and 2 concatenate ``[up, skip]`` and
  reduce it with a 1x1 conv, decoder 1 keeps the 96 channels; 4
  refinement blocks; a 3x3 conv 96 -> 1 plus the input image.  No
  sigmoid, no clip.
- A block: ``x + MDTA(LN(x))``, then ``x + GDFN(LN(x))``.  The norm is
  the published bias-free one over the channels of each pixel,
  ``x / sqrt(var(x) + 1e-5) * weight``, with x itself not centred.
  MDTA: a 1x1 conv to 3C and a 3x3 depthwise conv, split into q, k, v
  viewed as [B, heads, C / heads, H W]; q and k L2-normalised along H W;
  ``softmax(q k^T * temperature[head]) v``; a 1x1 conv.  GDFN: a 1x1
  conv to 2 * int(2.66 C), a 3x3 depthwise conv, ``gelu(x1) * x2``
  (exact GELU), a 1x1 conv back to C.
- An input whose H or W is not a multiple of 8 is reflect-padded at the
  bottom and right to the next multiple and the output cropped back, as
  the published test script does; each padded batch counts on
  ``restormer.padded``.

Submodules carry the published names, so a published state dict loads
one to one.  ``init_restormer`` fills a model as those modules' own
initialisers do, from a seeded generator.

Spans (``utils.profiling``, recorded only while a profiler runs):
``restormer.forward`` around a forward, and in each block
``restormer.attention`` (norm, MDTA and its residual add) and
``restormer.ffn`` (norm, GDFN and its residual add).

Float32 only, on cuDNN and cuBLAS with TF32 off: ``compute_dtype`` other
than float32, ``fast_conv`` (B1 pads by reflection, Restormer's 3x3
convs by zeros), ``drop_rate`` and ``disable_center`` (the U-Net's input
options) raise ``UserError``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import disable_tf32
from ..utils.errors import UserError
from ..utils.profiling import count, span

# the published configurations, by network name
NETWORKS = {
    "restormer_gray": dict(dim=48, num_blocks=(4, 6, 6, 8),
                           num_refinement_blocks=4, heads=(1, 2, 4, 8),
                           ffn_expansion_factor=2.66),
}
# the encoder's three halvings: H and W are padded to a multiple of this
MULTIPLE = 8


class _Scale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class LayerNorm(nn.Module):
    """The published ``BiasFree_LayerNorm`` over the channels of each
    pixel, in NCHW: the variance about the mean (``unbiased=False``), x
    not centred."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = _Scale(dim)

    def forward(self, x):
        var = x.var(1, keepdim=True, unbiased=False)
        return x / torch.sqrt(var + 1e-5) * self.body.weight[:, None, None]


class Attention(nn.Module):
    """MDTA: multi-head attention across channels."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, c // self.heads, h * w)
                   for t in self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1))
        q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        attn = (q @ k.transpose(-2, -1) * self.temperature).softmax(dim=-1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class FeedForward(nn.Module):
    """GDFN: the gated depthwise feed-forward."""

    def __init__(self, dim: int, expansion: float):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, expansion: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, expansion)

    def forward(self, x):
        with span("restormer.attention"):
            x = x + self.attn(self.norm1(x))
        with span("restormer.ffn"):
            return x + self.ffn(self.norm2(x))


def _blocks(n: int, dim: int, heads: int, expansion: float):
    return nn.Sequential(*[TransformerBlock(dim, heads, expansion)
                           for _ in range(n)])


class _Resample(nn.Module):
    """The published ``Downsample`` / ``Upsample``: a 3x3 conv, then the
    pixel (un)shuffle, under ``body``."""

    def __init__(self, dim: int, out: int, shuffle: nn.Module):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(dim, out, 3, padding=1, bias=False), shuffle)

    def forward(self, x):
        return self.body(x)


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, 3, padding=1, bias=False)

    def forward(self, x):
        return self.proj(x)


class Restormer(nn.Module):
    """[B, C_in, H, W] -> [B, C_out, H, W] in the input's dtype: the
    image plus the network's residual (module docstring)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 dim: int = 48, num_blocks=(4, 6, 6, 8),
                 num_refinement_blocks: int = 4, heads=(1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66):
        super().__init__()
        f = ffn_expansion_factor
        self.patch_embed = _PatchEmbed(in_channels, dim)
        self.encoder_level1 = _blocks(num_blocks[0], dim, heads[0], f)
        self.down1_2 = _Resample(dim, dim // 2, nn.PixelUnshuffle(2))
        self.encoder_level2 = _blocks(num_blocks[1], dim * 2, heads[1], f)
        self.down2_3 = _Resample(dim * 2, dim, nn.PixelUnshuffle(2))
        self.encoder_level3 = _blocks(num_blocks[2], dim * 4, heads[2], f)
        self.down3_4 = _Resample(dim * 4, dim * 2, nn.PixelUnshuffle(2))
        self.latent = _blocks(num_blocks[3], dim * 8, heads[3], f)
        self.up4_3 = _Resample(dim * 8, dim * 16, nn.PixelShuffle(2))
        self.reduce_chan_level3 = nn.Conv2d(dim * 8, dim * 4, 1, bias=False)
        self.decoder_level3 = _blocks(num_blocks[2], dim * 4, heads[2], f)
        self.up3_2 = _Resample(dim * 4, dim * 8, nn.PixelShuffle(2))
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, 1, bias=False)
        self.decoder_level2 = _blocks(num_blocks[1], dim * 2, heads[1], f)
        self.up2_1 = _Resample(dim * 2, dim * 4, nn.PixelShuffle(2))
        self.decoder_level1 = _blocks(num_blocks[0], dim * 2, heads[0], f)
        self.refinement = _blocks(num_refinement_blocks, dim * 2, heads[0],
                                  f)
        self.output = nn.Conv2d(dim * 2, out_channels, 3, padding=1,
                                bias=False)

    def _body(self, x):
        enc1 = self.encoder_level1(self.patch_embed(x))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        h = self.latent(self.down3_4(enc3))
        h = self.reduce_chan_level3(torch.cat([self.up4_3(h), enc3], 1))
        h = self.decoder_level3(h)
        h = self.reduce_chan_level2(torch.cat([self.up3_2(h), enc2], 1))
        h = self.decoder_level2(h)
        h = self.decoder_level1(torch.cat([self.up2_1(h), enc1], 1))
        return self.output(self.refinement(h)) + x

    def forward(self, x: torch.Tensor, keep: torch.Tensor = None):
        """``keep`` is the trainer's dropout mask, which this network has
        no use for: it must be None."""
        if keep is not None:
            raise ValueError("Restormer has no input dropout")
        with span("restormer.forward"):
            in_dtype = x.dtype
            x = x.to(torch.float32)
            if x.is_cuda:
                disable_tf32()
            h, w = x.shape[-2:]
            pad_h, pad_w = -h % MULTIPLE, -w % MULTIPLE
            if pad_h or pad_w:
                count("restormer.padded")
                x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
            return self._body(x)[..., :h, :w].to(in_dtype)


@torch.no_grad()
def init_restormer(model: Restormer, seed: int) -> Restormer:
    """Fill every parameter as the published modules' own initialisers
    do, drawn from a CPU generator seeded with ``seed``: each conv weight
    uniform in +-1/sqrt(fan_in) (``nn.Conv2d``'s Kaiming-uniform with a =
    sqrt(5)), the norms' weights and the temperatures 1."""
    gen = torch.Generator().manual_seed(int(seed) % 2 ** 64)
    for p in model.parameters():
        if p.dim() == 4:
            bound = 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                  generator=gen))
        else:
            p.fill_(1.0)
    return model


def restormer(name: str, in_channels: int = 1, out_channels: int = 1,
              drop_rate: float = None, disable_center: bool = False,
              compute_dtype: torch.dtype = torch.float32,
              fast_conv=False) -> Restormer:
    """The published configuration ``name`` (in ``NETWORKS``), refusing
    what it does not run: another dtype, ``fast_conv``, the U-Net's input
    dropout and centre-tap mask."""
    if compute_dtype != torch.float32:
        raise UserError(f"{name} runs in float32 only, not {compute_dtype}")
    if fast_conv is not False:
        raise UserError(f"{name} has no fast_conv route (its 3x3 convs pad "
                        f"with zeros; kernel B1 pads by reflection)")
    if drop_rate is not None or disable_center:
        raise UserError(f"{name} takes neither drop_rate nor "
                        f"disable_center (U-Net input options)")
    return Restormer(in_channels, out_channels, **NETWORKS[name])
