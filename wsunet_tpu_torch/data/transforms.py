"""Image transforms (port of ``wsunet_tpu/data/transforms.py``).

The JAX versions take NHWC batches in [0, 1]; these take NCHW tensors
(``center_crop`` also channel-free [..., H, W]) and append planes along
the channel axis, dim 1.  The random augmentations belong to training and
are not ported yet.
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
