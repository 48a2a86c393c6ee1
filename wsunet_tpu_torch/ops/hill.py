"""HILL embedding-cost map (port of ``wsunet_tpu/ops/hill.py``), batched.

    rho = lowpass_15( 1 / lowpass_3( |x (*) H_KB| ) )

with H_KB the 3x3 KB high-pass, both low-passes box averages, and all three
"same"-size filters on a *symmetric* pad (numpy's ``mode="symmetric"``:
the edge pixel is repeated, which ``F.pad`` has no mode for, so the pad is
built by index).  The box averages are two 1-D passes, each a sum of
shifted slices in tap order: an infinite cost (zero texture) stays
infinite and never turns its neighbours into NaN, as a transform-based
convolution algorithm could.  Infinities are left in the map; callers
clamp them to the wet cost 1e10.
"""

import numpy as np
import torch

from .filters import conv2d_valid

H_KB = np.array(
    [[-1, 2, -1],
     [2, -4, 2],
     [-1, 2, -1]], dtype="float32")


def _symmetric_index(n: int, p: int, device) -> torch.Tensor:
    """Indices of numpy's symmetric extension of an axis of ``n`` by ``p``
    on each side (period 2n, mirrored with the edge repeated)."""
    i = torch.arange(-p, n + p, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def _pad_symmetric(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """[B, H, W] padded by ph rows and pw columns on each side."""
    if ph:
        x = x.index_select(1, _symmetric_index(x.shape[1], ph, x.device))
    if pw:
        x = x.index_select(2, _symmetric_index(x.shape[2], pw, x.device))
    return x


def _box_1d(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """VALID correlation of [B, H, W] with ``size`` taps of 1/size along
    ``dim``, summed tap by tap."""
    w = np.float32(1.0 / size)
    n = x.shape[dim] - size + 1
    acc = x.narrow(dim, 0, n) * w
    for k in range(1, size):
        acc = acc + x.narrow(dim, k, n) * w
    return acc


def _box_same_symmetric(x: torch.Tensor, size: int) -> torch.Tensor:
    """size x size box average with a symmetric pad, as two 1-D passes."""
    p = size // 2
    x = _box_1d(_pad_symmetric(x, p, 0), size, 1)
    return _box_1d(_pad_symmetric(x, 0, p), size, 2)


def hill_cost(x: torch.Tensor, wet_cost: float = None) -> torch.Tensor:
    """HILL cost rho of a [B, H, W] (or [H, W]) pixel batch; with
    ``wet_cost``, inf, NaN and larger costs are clamped to it."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    x = x.to(torch.float32)
    r = conv2d_valid(_pad_symmetric(x, 1, 1), H_KB)
    xi = _box_same_symmetric(torch.abs(r), 3)
    rho = _box_same_symmetric(1.0 / xi, 15)   # inf where xi == 0
    if wet_cost is not None:
        bad = torch.isinf(rho) | torch.isnan(rho) | (rho > wet_cost)
        rho = torch.where(bad, torch.full_like(rho, wet_cost), rho)
    return rho[0] if squeeze else rho
