"""Image transforms (port of ``wsunet_tpu/data/transforms.py``).

The JAX versions take NHWC batches in [0, 1]; these take NCHW tensors
(``center_crop`` also channel-free [..., H, W]) and append planes along
the channel axis, dim 1.  The random augmentations (``random_flip``,
``random_rot90``) act on the last two axes, so they take channel-free
[B, H, W] batches and NCHW alike; each has a pure core that takes its
draws (``flip``, ``rot90``) and a wrapper that draws them from an explicit
``torch.Generator``.  ``crop`` is the trainer's per-image random crop,
given its offsets.
"""

import torch


def center_crop(x: torch.Tensor, size: int = 512) -> torch.Tensor:
    """CenterCrop of the last two axes, [..., H, W] (torchvision
    CenterCrop parity for even overhang).  The JAX version crops
    [..., H, W, C]; the port keeps images channel-free or NCHW."""
    h, w = x.shape[-2], x.shape[-1]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return x[..., top:top + size, left:left + size]


def lsbr_reference(x: torch.Tensor) -> torch.Tensor:
    """Append the zeroed-LSB reference plane: x*255 rounded (half to
    even, as ``jnp.round``), its LSB cleared, /255."""
    ref = torch.bitwise_and(torch.round(x * 255.0).to(torch.int32), ~1)
    return torch.cat([x, ref.to(x.dtype) / 255.0], dim=1)


def parity_oracle(x: torch.Tensor) -> torch.Tensor:
    """Append the LSB parity plane of x*255 rounded."""
    par = torch.bitwise_and(torch.round(x * 255.0).to(torch.int32), 1)
    return torch.cat([x, par.to(x.dtype)], dim=1)


def demosaic_oracle(x: torch.Tensor) -> torch.Tensor:
    """Append 3 Bayer-position planes (R at even/even, G where the row and
    column parities differ, B at odd/odd)."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(h, device=x.device)[:, None] % 2
    cols = torch.arange(w, device=x.device)[None, :] % 2
    planes = torch.stack([(rows == 0) & (cols == 0), rows != cols,
                          (rows == 1) & (cols == 1)]).to(x.dtype)
    planes = planes.expand(x.shape[0], 3, h, w)
    return torch.cat([x, planes], dim=1)


def _moment(v, x: torch.Tensor) -> torch.Tensor:
    """``v`` in x's dtype on x's device: a scalar filled there (no host
    copy, so that a CUDA graph can capture it), a sequence as [C, 1, 1]."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=x.dtype, device=x.device)
    return torch.as_tensor(v, dtype=x.dtype, device=x.device).reshape(
        -1, 1, 1)


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std with per-channel (or scalar) moments, each cast to
    x's dtype first, as in JAX."""
    return (x - _moment(mean, x)) / _moment(std, x)


def crop(x: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
         size: int) -> torch.Tensor:
    """Per-image ``size`` x ``size`` crops of [B, H, W] at rows ``top``
    [B] and columns ``left`` [B] (the JAX trainer's ``dynamic_slice``),
    by one gather on x's device."""
    ar = torch.arange(size, device=x.device)
    rows = (top[:, None] + ar)[:, :, None]
    cols = (left[:, None] + ar)[:, None, :]
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, rows, cols]


def flip(x: torch.Tensor, flip_h: torch.Tensor,
         flip_v: torch.Tensor) -> torch.Tensor:
    """Per-image flips of [B, ..., H, W]: ``flip_h`` [B] (bool) reverses W,
    then ``flip_v`` [B] reverses H, as the JAX ``random_flip`` does."""
    shape = (-1,) + (1,) * (x.ndim - 1)
    x = torch.where(flip_h.reshape(shape), x.flip(-1), x)
    return torch.where(flip_v.reshape(shape), x.flip(-2), x)


def rot90(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Rotate each image of [B, ..., H, W] (H == W) by ``k`` [B] (0..3)
    quarter turns, ``torch.rot90(x, k, dims=(-2, -1))``: on the HWC image
    that is ``jnp.rot90(v, k, axes=(0, 1))``.  Every rotation is taken and
    one selected per image, with no host sync."""
    shape = (-1,) + (1,) * (x.ndim - 1)
    k = k.reshape(shape)
    out = x
    for r in range(1, 4):
        out = torch.where(k == r, torch.rot90(x, r, dims=(-2, -1)), out)
    return out


def random_flip(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Independent random horizontal and vertical flips per batch
    element, drawn from ``generator`` (on x's device)."""
    fh = torch.rand(x.shape[0], generator=generator, device=x.device) < 0.5
    fv = torch.rand(x.shape[0], generator=generator, device=x.device) < 0.5
    return flip(x, fh, fv)


def random_rot90(x: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """Rotate each batch element by an independent random multiple of 90
    degrees, drawn from ``generator`` (on x's device)."""
    k = torch.randint(0, 4, (x.shape[0],), generator=generator,
                      device=x.device)
    return rot90(x, k)
