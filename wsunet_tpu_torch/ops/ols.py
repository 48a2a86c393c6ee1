"""OLS-fitted linear pixel predictors, gray / color4 / color8 (port of
``wsunet_tpu/ops/ols.py``).

The taps are fitted by least squares over a cover batch: the normal
equations X^T X theta = X^T y accumulate on the batch's device, then the
host solves them in float64.

Tap layouts (the reference's 9/18/27-tap ``BETAS_PER_MODEL``):

- gray:   8 regressors, the ring neighbours of the target plane;
- color4: 17, the 9 taps (centre included) of one helper plane, then the
  8 of the target;
- color8: 26, 9 + 9 helper taps, then the 8 of the target.

The target's centre is the regressand, never a regressor.

**Accumulation dtype: float64.**  The JAX package sums X^T X in f32 (sums
near 1e10 at 512x512, where an f32 ulp is about 1e3) before its f64
solve.  Here the pixels are integers 0..255, so every product and every
sum over fewer than 2^53 / 255^2 (about 1.4e11) pixels is exact in f64:
the port's normal equations are exact and independent of summation
order, and what separates its taps from JAX's is JAX's f32 rounding,
amplified by the conditioning of X^T X (neighbouring pixels are strongly
correlated).  ``tests/test_torch_ols.py`` states the bound that results.
Where the regressors are linearly dependent (colour layouts on a grayscale
catalog, whose planes are equal) the exact equations are singular and the
fit raises ``UserError``; JAX's rounded ones solve to arbitrary taps.
"""

import numpy as np
import torch

from ..utils.errors import UserError
from .filters import _NEIGHBOR_OFFSETS, conv2d_valid, taps_to_kernel2d


def _neighborhood(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, (H-2)(W-2), 9]: the ring-ordered neighbours, then
    the centre."""
    h, w = x.shape[-2] - 2, x.shape[-1] - 2
    cols = [x[:, i:i + h, j:j + w].reshape(x.shape[0], -1)
            for (i, j) in _NEIGHBOR_OFFSETS]
    cols.append(x[:, 1:-1, 1:-1].reshape(x.shape[0], -1))
    return torch.stack(cols, dim=-1)


def _design(x: torch.Tensor):
    """Regressors [B, N, K] and target [B, N] of a batch: [B, H, W] (gray)
    or [B, C, H, W] with the helper planes first and the target plane
    last (each helper gives 9 taps, the target its 8 ring neighbours)."""
    if x.ndim == 3:
        m = _neighborhood(x)
        return m[..., :8], m[..., 8]
    m_t = _neighborhood(x[:, -1])
    cols = [_neighborhood(x[:, c]) for c in range(x.shape[1] - 1)]
    return torch.cat(cols + [m_t[..., :8]], dim=-1), m_t[..., 8]


def _solve(pixels, chunk: int = 16) -> np.ndarray:
    """theta of the normal equations over a batch (numpy array or tensor,
    0..255), summed in float64 on the batch's device ``chunk`` images at a
    time, solved in float64 on the host."""
    pixels = torch.as_tensor(pixels)
    xtx = xty = 0.0
    for i in range(0, pixels.shape[0], chunk):
        X, y = _design(pixels[i:i + chunk].to(torch.float64))
        xtx = xtx + torch.einsum("bnk,bnl->kl", X, X)
        xty = xty + torch.einsum("bnk,bn->k", X, y)
    try:
        return np.linalg.solve(xtx.cpu().numpy(), xty.cpu().numpy())
    except np.linalg.LinAlgError:
        # exact sums make linearly dependent regressors exactly singular
        # (JAX's f32 sums solve to arbitrary taps instead)
        raise UserError("OLS: the normal equations are singular (are two "
                        "of the planes equal, e.g. colour layouts on a "
                        "grayscale catalog?)") from None


def fit_ols(pixels) -> np.ndarray:
    """The 8 neighbour taps fitted over a cover batch [B, H, W] (0..255),
    in ring order, as [8, 1] (the layout of ``NAMED_FILTERS``)."""
    return _solve(pixels).reshape(8, 1)


def ols_kernel2d(pixels) -> np.ndarray:
    """The fitted taps as a 3x3 correlation kernel."""
    return taps_to_kernel2d(fit_ols(pixels))


def fit_ols_color(pixels, channels) -> np.ndarray:
    """A color4 / color8 fit over a cover batch [B, C, H, W] (0..255).

    ``channels`` orders the planes that take part: helpers first, the
    predicted (target) plane last, e.g. (1, 0) predicts R from G's 9 taps
    and R's 8 neighbours.  Returns the flat taps (9 a helper, then the 8
    of the target)."""
    channels = tuple(channels)
    if len(channels) not in (2, 3):
        raise ValueError("color OLS takes 2 (color4) or 3 (color8) channels")
    return _solve(torch.as_tensor(pixels)[:, list(channels)])


def ols_color_kernels(pixels, channels) -> dict:
    """The colour fit as one 3x3 correlation kernel a plane, {plane:
    kernel}: the target plane's prediction is the sum over the planes of
    ``conv2d_valid(x[:, plane], kernel)``."""
    channels = tuple(channels)
    theta = fit_ols_color(pixels, channels)
    kernels = {c: taps_to_kernel2d(theta[9 * i:9 * (i + 1)])
               for i, c in enumerate(channels[:-1])}
    kernels[channels[-1]] = taps_to_kernel2d(
        theta[9 * (len(channels) - 1):])
    return kernels


def ols_color_predict(x4: torch.Tensor, kernels: dict) -> torch.Tensor:
    """f32 [B, C, H, W] -> [B, H-2, W-2], the target plane's prediction."""
    out = None
    for c, k in kernels.items():
        p = conv2d_valid(x4[:, c], k)
        out = p if out is None else out + p
    return out
