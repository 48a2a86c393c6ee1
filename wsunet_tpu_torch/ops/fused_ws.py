"""Fused WS attack, uint8 [B, H, W] -> beta_hat [B] (kernel B2).

Replaces the Pallas TPU kernel ``wsunet_tpu/ops/pallas_ws.py::
ws_attack_fused`` (body ``_ws_kernel``).  Per image, with a named 3x3
filter k and ``weighted`` in {0, 1, -1}:

    sign     = 2*(x & 1) - 1                  # == x - (x ^ 1)
    x_hat    = correlation of x with k, unscaled
    contrib  = sign * (x - x_hat), over the interior (1-px border masked)
    weighted == 0 : beta = sum(contrib) / ((H-2)(W-2))
    weighted == 1 : var = AVG(x^2) - AVG(x)^2, w = 1/(5+var),
                    beta = sum(w * contrib) / sum(w)
    weighted == -1: the same with w = 5 + var
    beta_hat = max(beta, 0)

``ws_attack_fused`` is the wrapper: a CUDA tensor goes to the Triton
kernel (``_fused_ws_triton``, imported at the first launch), a CPU tensor
to ``ws_attack_fused_plain``; anything else raises.  There is no fallback
from the kernel to the plain version.

``ws_attack_fused_plain`` is written in the Pallas kernel's own
formulation (correlation, the interior, w / sum(w)), not by calling
``ops.ws.ws_attack`` (a convolution of x/255 with clipping of a weighted
sum), so a test can tell a wrong formulation from a wrong kernel.

Bound on the card: one read of B*H*W bytes plus about 2*taps + 5
operations a pixel (+38 when weighted); see ``ws_fused_cost``.
"""

import numpy as np
import torch

from .filters import NAMED_FILTERS_2D

# Launches of the Triton kernel since the last reset (one per wrapper
# call on a CUDA tensor; calls that take the plain version do not count).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check(x_u8: torch.Tensor, kernel_name: str, weighted: int) -> None:
    if kernel_name not in NAMED_FILTERS_2D:
        raise ValueError(f"unknown filter {kernel_name!r}; "
                         f"expected one of {sorted(NAMED_FILTERS_2D)}")
    if weighted not in (0, 1, -1):
        raise ValueError(f"weighted must be 0, 1 or -1, got {weighted!r}")
    if x_u8.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 tensor, got {x_u8.dtype}")
    if x_u8.ndim != 3 or x_u8.shape[1] < 3 or x_u8.shape[2] < 3:
        raise ValueError(
            f"expected [B, H, W] with H, W >= 3, got {tuple(x_u8.shape)}")


def _correlate_interior(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """sum over nonzero taps of k[di, dj] * x[i+di-1, j+dj-1] on the
    interior, in the Pallas kernel's tap order -> [B, H-2, W-2]."""
    _, H, W = x.shape
    acc = None
    for di in range(3):
        for dj in range(3):
            c = float(k[di, dj])
            if c == 0.0:
                continue
            term = c * x[:, di:di + H - 2, dj:dj + W - 2]
            acc = term if acc is None else acc + term
    return acc


def ws_attack_fused_plain(x_u8: torch.Tensor, kernel_name: str = "KB",
                          weighted: int = 0) -> torch.Tensor:
    """The plain PyTorch version of B2, on any device."""
    _check(x_u8, kernel_name, weighted)
    _, H, W = x_u8.shape
    x = x_u8.to(torch.float32)
    sign = 2.0 * (x_u8[:, 1:-1, 1:-1] & 1).to(torch.float32) - 1.0
    x_hat = _correlate_interior(x, NAMED_FILTERS_2D[kernel_name])
    contrib = sign * (x[:, 1:-1, 1:-1] - x_hat)
    if weighted == 0:
        beta = torch.sum(contrib, dim=(1, 2)) * (1.0 / ((H - 2) * (W - 2)))
    else:
        avg = NAMED_FILTERS_2D["AVG"]
        mu = _correlate_interior(x, avg)
        mu2 = _correlate_interior(x * x, avg)
        var = mu2 - mu * mu
        w = 1.0 / (5.0 + var) if weighted == 1 else 5.0 + var
        beta = torch.sum(contrib * w, dim=(1, 2)) / torch.sum(w, dim=(1, 2))
    return torch.clamp(beta, min=0.0)


def ws_attack_fused(x_u8: torch.Tensor, kernel_name: str = "KB",
                    weighted: int = 0) -> torch.Tensor:
    """Fused WS attack: uint8 [B, H, W] -> beta_hat [B] (f32).

    CUDA tensor -> Triton kernel; CPU tensor -> the plain version."""
    global launches
    _check(x_u8, kernel_name, weighted)
    if x_u8.device.type == "cpu":
        return ws_attack_fused_plain(x_u8, kernel_name, weighted)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no B2 kernel for device {x_u8.device}")
    if not x_u8.is_contiguous():
        raise ValueError("expected a contiguous [B, H, W] tensor")
    from ._fused_ws_triton import launch
    out = launch(x_u8, NAMED_FILTERS_2D[kernel_name], weighted)
    launches += 1
    return out


def ws_fused_cost(B: int, H: int, W: int, kernel_name: str,
                  weighted: int) -> dict:
    """Bytes and f32 operations that B2 needs for one call, counted from
    the formulation above: each input byte read once, each output written
    once; per interior pixel 2*taps-1 for x_hat, 1 for the residual, 2 for
    the sign, 1 for the product and 1 for the sum; weighted adds AVG(x)
    and AVG(x^2) (15 each), x^2, var (2), w (2), w*contrib and two sums."""
    taps = int(np.count_nonzero(NAMED_FILTERS_2D[kernel_name]))
    per_px = 2 * taps - 1 + 5
    if weighted:
        per_px += 15 + 15 + 1 + 2 + 2 + 1 + 2
    return {"bytes": B * H * W + 4 * B,
            "ops": B * (H - 2) * (W - 2) * per_px}
