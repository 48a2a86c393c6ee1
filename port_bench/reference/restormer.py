"""Plain PyTorch reference of Restormer as a WS cover predictor (Zamir et
al., CVPR 2022, arXiv:2111.09881; github.com/swz30/Restormer,
``basicsr/models/archs/restormer_arch.py``, and the padding of its test
scripts), float32.

The published forward written as functions of a state dict under the
published module names (``patch_embed.proj.weight``,
``encoder_level1.0.attn.qkv.weight``, ...); the widths, blocks and heads
are read off the tensors (``shapes`` gives the names and shapes of a
configuration's).  No kernel, cache or batching of the program,
and nothing imported from it.  Each block is ``x + attention(LN(x))``,
then ``x + feed_forward(LN(x))``:

- ``layer_norm``: ``BiasFree_LayerNorm`` on the published ``to_3d`` view
  [B, H W, C]: ``x / sqrt(var(x, unbiased=False) + 1e-5) * weight``, x not
  centred;
- ``attention``: 1x1 conv to 3C, 3x3 depthwise conv, q, k, v as
  ``rearrange('b (head c) h w -> b head c (h w)')``, q and k
  ``F.normalize``d along the last axis, ``softmax(q k^T * temperature)
  v``, back to [B, C, H, W], 1x1 conv;
- ``feed_forward``: 1x1 conv to 2 * hidden, 3x3 depthwise conv, halves
  x1, x2, ``gelu(x1) * x2``, 1x1 conv.

An image whose sides are not multiples of 8 is reflect-padded at the
bottom and right and the output cropped back, as the published test
scripts do.  Departures from the published code: none but the functional
form and ``approximate``, which swaps the exact GELU for its tanh form
(a control of the benchmark's check, not the model).  ``ws_predict``
runs with TF32 off (``reference.precision``) unless ``tf32`` asks for it
(the other control).
"""

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import precision
from port_bench.reference.unet import center_crop


def shapes(config: dict) -> dict:
    """{name: shape} of the published state dict at a configuration's
    widths (``dim``, ``num_blocks``, ``num_refinement_blocks``, ``heads``,
    ``ffn_expansion_factor``, ``inp_channels``, ``out_channels``), in the
    published modules' order; every conv without a bias."""
    dim, f, heads = config["dim"], config["ffn_expansion_factor"], \
        config["heads"]
    nb = config["num_blocks"]
    out = {"patch_embed.proj.weight": (dim, config["inp_channels"], 3, 3)}

    def blocks(name, n, c, h):
        hidden = int(c * f)
        for i in range(n):
            p = f"{name}.{i}."
            out.update({
                p + "norm1.body.weight": (c,),
                p + "attn.temperature": (h, 1, 1),
                p + "attn.qkv.weight": (3 * c, c, 1, 1),
                p + "attn.qkv_dwconv.weight": (3 * c, 1, 3, 3),
                p + "attn.project_out.weight": (c, c, 1, 1),
                p + "norm2.body.weight": (c,),
                p + "ffn.project_in.weight": (2 * hidden, c, 1, 1),
                p + "ffn.dwconv.weight": (2 * hidden, 1, 3, 3),
                p + "ffn.project_out.weight": (c, hidden, 1, 1)})

    blocks("encoder_level1", nb[0], dim, heads[0])
    out["down1_2.body.0.weight"] = (dim // 2, dim, 3, 3)
    blocks("encoder_level2", nb[1], 2 * dim, heads[1])
    out["down2_3.body.0.weight"] = (dim, 2 * dim, 3, 3)
    blocks("encoder_level3", nb[2], 4 * dim, heads[2])
    out["down3_4.body.0.weight"] = (2 * dim, 4 * dim, 3, 3)
    blocks("latent", nb[3], 8 * dim, heads[3])
    out["up4_3.body.0.weight"] = (16 * dim, 8 * dim, 3, 3)
    out["reduce_chan_level3.weight"] = (4 * dim, 8 * dim, 1, 1)
    blocks("decoder_level3", nb[2], 4 * dim, heads[2])
    out["up3_2.body.0.weight"] = (8 * dim, 4 * dim, 3, 3)
    out["reduce_chan_level2.weight"] = (2 * dim, 4 * dim, 1, 1)
    blocks("decoder_level2", nb[1], 2 * dim, heads[1])
    out["up2_1.body.0.weight"] = (4 * dim, 2 * dim, 3, 3)
    blocks("decoder_level1", nb[0], 2 * dim, heads[0])
    blocks("refinement", config["num_refinement_blocks"], 2 * dim, heads[0])
    out["output.weight"] = (config["out_channels"], 2 * dim, 3, 3)
    return out


def layer_norm(x, weight):
    b, c, h, w = x.shape
    x3 = x.flatten(2).transpose(1, 2)
    sigma = x3.var(-1, keepdim=True, unbiased=False)
    y = x3 / torch.sqrt(sigma + 1e-5) * weight
    return y.transpose(1, 2).reshape(b, c, h, w)


def attention(x, sd, p):
    b, c, h, w = x.shape
    heads = sd[p + "temperature"].shape[0]
    qkv = F.conv2d(x, sd[p + "qkv.weight"])
    qkv = F.conv2d(qkv, sd[p + "qkv_dwconv.weight"], padding=1,
                   groups=qkv.shape[1])
    q, k, v = (t.reshape(b, heads, c // heads, h * w)
               for t in qkv.chunk(3, dim=1))
    q = F.normalize(q, dim=-1)
    k = F.normalize(k, dim=-1)
    attn = (q @ k.transpose(-2, -1)) * sd[p + "temperature"]
    out = attn.softmax(dim=-1) @ v
    return F.conv2d(out.reshape(b, c, h, w), sd[p + "project_out.weight"])


def feed_forward(x, sd, p, approximate="none"):
    y = F.conv2d(x, sd[p + "project_in.weight"])
    y = F.conv2d(y, sd[p + "dwconv.weight"], padding=1, groups=y.shape[1])
    x1, x2 = y.chunk(2, dim=1)
    return F.conv2d(F.gelu(x1, approximate=approximate) * x2,
                    sd[p + "project_out.weight"])


def level(x, sd, name, approximate="none"):
    """The transformer blocks ``<name>.0``, ``<name>.1``, ... in turn."""
    i = 0
    while f"{name}.{i}.norm1.body.weight" in sd:
        p = f"{name}.{i}."
        x = x + attention(layer_norm(x, sd[p + "norm1.body.weight"]), sd,
                          p + "attn.")
        x = x + feed_forward(layer_norm(x, sd[p + "norm2.body.weight"]), sd,
                             p + "ffn.", approximate)
        i += 1
    return x


def _conv3x3(x, sd, name):
    return F.conv2d(x, sd[f"{name}.weight"], padding=1)


def forward(sd: dict, x: torch.Tensor, approximate="none") -> torch.Tensor:
    """[B, 1, H, W] -> [B, 1, H, W]: the input plus the network's
    residual."""
    h, w = x.shape[-2:]
    pad_h, pad_w = -h % 8, -w % 8
    x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect") \
        if pad_h or pad_w else x
    a = approximate
    enc1 = level(_conv3x3(x, sd, "patch_embed.proj"), sd, "encoder_level1",
                 a)
    enc2 = level(F.pixel_unshuffle(_conv3x3(enc1, sd, "down1_2.body.0"), 2),
                 sd, "encoder_level2", a)
    enc3 = level(F.pixel_unshuffle(_conv3x3(enc2, sd, "down2_3.body.0"), 2),
                 sd, "encoder_level3", a)
    lat = level(F.pixel_unshuffle(_conv3x3(enc3, sd, "down3_4.body.0"), 2),
                sd, "latent", a)
    d3 = torch.cat([F.pixel_shuffle(_conv3x3(lat, sd, "up4_3.body.0"), 2),
                    enc3], 1)
    d3 = level(F.conv2d(d3, sd["reduce_chan_level3.weight"]), sd,
               "decoder_level3", a)
    d2 = torch.cat([F.pixel_shuffle(_conv3x3(d3, sd, "up3_2.body.0"), 2),
                    enc2], 1)
    d2 = level(F.conv2d(d2, sd["reduce_chan_level2.weight"]), sd,
               "decoder_level2", a)
    d1 = torch.cat([F.pixel_shuffle(_conv3x3(d2, sd, "up2_1.body.0"), 2),
                    enc1], 1)
    d1 = level(level(d1, sd, "decoder_level1", a), sd, "refinement", a)
    return (_conv3x3(d1, sd, "output") + x)[..., :h, :w]


@torch.no_grad()
def ws_predict(sd: dict, pixels_u8: np.ndarray, device, block: int = 16,
               approximate="none", tf32: bool = False) -> tuple:
    """(beta_hat, l1), float64 numpy [N], of uint8 images [N, H, W], as
    ``reference.unet.ws_predict`` gives them with this network as the
    predictor: the centre 512 crop, /255, the prediction of every pixel
    but the one-pixel border, x255, the WS estimate and the mean absolute
    prediction error, in float64.  Runs ``block`` images at a time, in
    full float32 (in TF32 with ``tf32``)."""
    with precision(tf32):
        return _ws_predict(sd, pixels_u8, device, block, approximate)


def _ws_predict(sd, pixels_u8, device, block, approximate):
    beta, l1 = [], []
    for i in range(0, len(pixels_u8), block):
        x = torch.as_tensor(pixels_u8[i:i + block], device=device)
        x = center_crop(x.to(torch.float32))
        y = forward(sd, x[:, None] / 255.0, approximate)[:, 0, 1:-1, 1:-1]
        y = y * 255.0
        x1 = x[:, 1:-1, 1:-1]
        x1_bar = torch.bitwise_xor(x1.to(torch.uint8), 1).to(torch.float32)
        d = (x1 - y).double()
        beta.append(((x1 - x1_bar).double() * d).mean(dim=(1, 2)).cpu())
        l1.append(d.abs().mean(dim=(1, 2)).cpu())
    return torch.cat(beta).numpy(), torch.cat(l1).numpy()
