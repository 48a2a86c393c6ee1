"""Linear pixel-prediction filters (port of ``wsunet_tpu/ops/filters.py``).

- ``NAMED_FILTERS_2D`` / ``NAMED_FILTERS``: the KB / AVG / AVG9 / identity
  kernels, as 3x3 arrays and as 8- or 9-tap vectors.
- ``conv2d_valid``: batched VALID *correlation* of [B, H, W] with a 3x3
  kernel (``F.conv2d`` is a correlation, like XLA's conv).
- ``filter_predict``: the reference's ``convolve(x/255, k, 'valid')*255``,
  a true convolution, so the kernel is flipped before the correlation.
- ``filter_residuals``: the residual ``centre - prediction`` on raw
  pixels, one valid correlation with (delta_centre - taps).
- ``get_coefficients``: a named filter as its tap vector or 3x3 kernel.

All functions take [B, H, W] or [H, W] float32 tensors and run on the
tensor's device; on CUDA the f32 convolution runs with TF32 off.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .._device import disable_tf32

NAMED_FILTERS_2D = {
    "KB": np.array(
        [[-1, +2, -1],
         [+2, 0, +2],
         [-1, +2, -1]], dtype="float32") / 4.0,
    "AVG": np.array(
        [[1, 1, 1],
         [1, 0, 1],
         [1, 1, 1]], dtype="float32") / 8.0,
    "AVG9": np.ones((3, 3), dtype="float32") / 9.0,
    "1": np.array(
        [[0, 0, 0],
         [0, 1, 0],
         [0, 0, 0]], dtype="float32"),
}

# 9-tap neighborhood order of the reference's N x 9 matrices:
# x00,x01,x02,x12,x22,x21,x20,x10 (clockwise ring), then x11 (center).
_NEIGHBOR_OFFSETS = [
    (0, 0), (0, 1), (0, 2), (1, 2), (2, 2), (2, 1), (2, 0), (1, 0),
]

NAMED_FILTERS = {
    "KB": np.array([[-1], [+2], [-1], [+2], [-1], [+2], [-1], [+2]],
                   dtype="float64") / 4.0,
    "AVG": np.ones((8, 1), dtype="float64") / 8.0,
    # 9-tap variants carry an explicit center coefficient (last entry)
    "AVG9": np.ones((9, 1), dtype="float64") / 9.0,
    "1": np.array([[0]] * 8 + [[1]], dtype="float64"),
}


def get_coefficients(filter_name: str, flatten: bool = True) -> np.ndarray:
    """A named filter's tap vector (``flatten``) or its 3x3 kernel."""
    return NAMED_FILTERS[filter_name] if flatten \
        else NAMED_FILTERS_2D[filter_name]


def taps_to_kernel2d(taps: np.ndarray, center: float = 0.0) -> np.ndarray:
    """Convert a 9-tap (8 neighbors [+ optional center]) vector into a 3x3
    kernel in spatial orientation."""
    taps = np.asarray(taps).reshape(-1)
    k = np.zeros((3, 3), dtype="float32")
    for coef, (i, j) in zip(taps[:8], _NEIGHBOR_OFFSETS):
        k[i, j] = coef
    k[1, 1] = taps[8] if taps.size > 8 else center
    return k


def conv2d_valid(x: torch.Tensor, kernel) -> torch.Tensor:
    """Batched VALID correlation of [B, H, W] (or [H, W]) with a 2-D
    kernel -> [B, H-2, W-2].  Callers wanting a true convolution flip the
    kernel first."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    if x.is_cuda and x.dtype == torch.float32:
        disable_tf32()
    k = torch.as_tensor(np.ascontiguousarray(kernel), dtype=x.dtype,
                        device=x.device)
    out = F.conv2d(x[:, None], k[None, None])[:, 0]
    return out[0] if squeeze else out


def filter_predict(x: torch.Tensor, kernel) -> torch.Tensor:
    """Predict each interior pixel from its 3x3 neighborhood: scale to
    [0, 1], true convolution VALID, scale back.  [B, H, W] ->
    [B, H-2, W-2]."""
    k_flipped = np.asarray(kernel, dtype="float32")[::-1, ::-1]
    return conv2d_valid(x / 255.0, k_flipped) * 255.0


def filter_residuals(x: torch.Tensor, kernel2d) -> torch.Tensor:
    """Residual ``centre - prediction`` of every interior pixel on raw
    pixel values, [B, H, W] -> [B, H-2, W-2] in f32: one valid correlation
    with the kernel (delta_centre - taps), as the JAX package fuses the
    reference's N x 9 product."""
    k = -np.asarray(kernel2d, dtype="float32")
    k[1, 1] += 1.0
    return conv2d_valid(x.to(torch.float32), k)
