"""Weighted-stego (WS) change-rate estimation (port of
``wsunet_tpu/ops/ws.py``).

- ``ws_attack``: uint8-domain LSB flip, a weighted sum with uniform 1/N
  or (inverse-)variance weights, clip at 0, optional bias correction.
- ``ws_attack_sca``: the selection-channel-aware score, the unclipped WS
  mean over the lowest-HILL-cost ``frac`` of the interior (``-sca`` rows).
- ``ws_estimate_unet``: the U-Net variant: mean instead of a weighted
  sum, no clipping, 1-px border crop applied to x before the product.
- ``ws_estimate_inloss``: the differentiable estimate of the training
  losses, on [B, C, H, W] (or [B, H, W]) in [0, 1].

Everything else operates on [B, H, W] batches on the device of its input.
"""

import typing

import numpy as np
import torch

from .filters import NAMED_FILTERS_2D, conv2d_valid, filter_predict


def lsb_flip_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """x ^ 1 in the uint8 domain."""
    return torch.bitwise_xor(x_u8.to(torch.uint8), 1)


def ws_weights(x: torch.Tensor, weighted: int,
               mean_kernel=None) -> torch.Tensor:
    """Per-pixel weights over the VALID interior, [B, H-2, W-2].

    weighted == 0 : uniform 1/N
    weighted == 1 : 1 / (5 + local variance), normalized per image
    weighted == -1: (5 + local variance), normalized per image
    """
    B, H, W = x.shape
    n = (H - 2) * (W - 2)
    if weighted == 0:
        return torch.full((B, H - 2, W - 2), 1.0 / n, dtype=x.dtype,
                          device=x.device)
    if mean_kernel is None:
        mean_kernel = NAMED_FILTERS_2D["AVG"]
    k = np.asarray(mean_kernel, dtype="float32")[::-1, ::-1]
    mu = conv2d_valid(x, k)
    mu2 = conv2d_valid(x * x, k)
    var = mu2 - mu * mu
    w = 1.0 / (5.0 + var) if int(weighted) == 1 else (5.0 + var)
    return w / torch.sum(w, dim=(1, 2), keepdim=True)


def ws_attack(
    x_u8: torch.Tensor,
    pixel_kernel=None,
    pixel_estimator: typing.Callable = None,
    mean_kernel=None,
    weighted: int = 0,
    correct_bias: bool = False,
) -> torch.Tensor:
    """WS attack on a uint8 batch [B, H, W] -> beta_hat [B].

    The pixel predictor is either a 3x3 kernel (KB/AVG path) or a callable
    ``f32 [B,H,W] -> [B,H-2,W-2]`` (the U-Net path)."""
    x = x_u8.to(torch.float32)
    x_bar = lsb_flip_u8(x_u8).to(torch.float32)

    if pixel_estimator is None:
        def pixel_estimator(v):
            return filter_predict(v, pixel_kernel)
    x_hat = pixel_estimator(x)

    w = ws_weights(x, weighted, mean_kernel)

    x1 = x[:, 1:-1, 1:-1]
    x1_bar = x_bar[:, 1:-1, 1:-1]
    beta_hat = torch.sum(w * (x1 - x1_bar) * (x1 - x_hat), dim=(1, 2))
    beta_hat = torch.clamp(beta_hat, min=0.0)

    if correct_bias:
        x_bias = pixel_estimator(x_bar - x)
        beta_hat = beta_hat - beta_hat * torch.sum(
            w * (x1 - x1_bar) * x_bias, dim=(1, 2))
    return beta_hat


def _quantile_linear(v: torch.Tensor, frac: float) -> torch.Tensor:
    """Per-row ``frac`` quantile of [B, N] f32 with linear interpolation,
    computed as ``jnp.quantile`` computes it (position frac * (N - 1) in
    f32, the two neighbours of the sorted row weighted in f32).  Sorting
    takes any N; ``torch.quantile`` refuses more than 2**24 elements."""
    n = v.shape[1]
    pos = np.float32(frac) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1) - w_hi
    s = torch.sort(v, dim=1).values
    return s[:, lo] * w_lo + s[:, hi] * w_hi


def ws_attack_sca(
    x_u8: torch.Tensor,
    pixel_kernel=None,
    pixel_estimator: typing.Callable = None,
    frac: float = 0.05,
) -> torch.Tensor:
    """Selection-channel-aware WS score of a uint8 batch [B, H, W] -> [B]:

        mean over {rho_i <= Q_frac(rho)} of (x_i - xbar_i)(x_i - xhat_i)

    with rho the HILL cost of the image (wet 1e10) over the interior.
    ``<=`` keeps the threshold pixel itself, so ties at the quantile grow
    the region.  Unclipped: a detector score, not a rate estimate."""
    from .hill import hill_cost

    x = x_u8.to(torch.float32)
    # the flip is taken on the uint8 values (an f32 input is cast first)
    x_bar = lsb_flip_u8(x_u8.to(torch.uint8)).to(torch.float32)
    if pixel_estimator is None:
        def pixel_estimator(v):
            return filter_predict(v, pixel_kernel)
    x_hat = pixel_estimator(x)
    x1 = x[:, 1:-1, 1:-1]
    x1_bar = x_bar[:, 1:-1, 1:-1]
    s = (x1 - x1_bar) * (x1 - x_hat)

    rho = hill_cost(x, wet_cost=1e10)[:, 1:-1, 1:-1]
    B = x.shape[0]
    thresh = _quantile_linear(rho.reshape(B, -1), frac)[:, None, None]
    low = rho <= thresh
    return (torch.sum(torch.where(low, s, torch.zeros_like(s)), dim=(1, 2))
            / torch.sum(low, dim=(1, 2)))


def ws_estimate_unet(
    x: torch.Tensor,
    x_hat: torch.Tensor,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """(beta_hat, l1) per image for a U-Net prediction.

    x is the f32 luminance [B, H, W], x_hat the model output cropped to
    [B, H-2, W-2]; the LSB flip happens on x cast to uint8 (before the
    XOR, as the JAX package and the reference do); the mean is unweighted
    and unclipped."""
    x1 = x[:, 1:-1, 1:-1]
    x1_bar = lsb_flip_u8(x1.to(torch.uint8)).to(torch.float32)
    beta_hat = torch.mean((x1 - x1_bar) * (x1 - x_hat), dim=(1, 2))
    l1 = torch.mean(torch.abs(x1 - x_hat), dim=(1, 2))
    return beta_hat, l1


def ws_estimate_inloss(inputs: torch.Tensor,
                       outputs: torch.Tensor) -> torch.Tensor:
    """In-graph WS estimate for the training losses, [B] from [B, C, H, W]
    (or [B, H, W]) in [0, 1]: x255, round (half to even, as ``jnp.round``)
    then XOR 1 on int32, uniform weights 1/(pixels per image), the sum per
    image, clipped at 0.  Differentiable with respect to ``outputs``; the
    flipped pixels carry no gradient.  The clip is ``torch.maximum``,
    whose gradient splits a tie at 0 in half, as ``jnp.maximum``'s does."""
    x = inputs * 255.0
    y = outputs * 255.0
    x_bar = torch.bitwise_xor(torch.round(x).to(torch.int32), 1).to(
        x.dtype).detach()
    axes = tuple(range(1, x.ndim))
    n = int(np.prod(x.shape[1:]))
    beta_hat = torch.sum((x - x_bar) * (x - y), dim=axes) / n
    return torch.maximum(beta_hat, beta_hat.new_zeros(()))
