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

``ws_attack_fused`` is the wrapper.  A CUDA tensor goes to the CUDA
kernel ``csrc/ws_fused.cu`` (built with nvcc at first use with B1's
sources, ``_cuda_build``, and loaded with ctypes): one launch a call, no
scratch tensor, the launch plan from ``_plan``.  A CPU tensor goes to
``ws_attack_fused_plain``; anything else raises.  There is no fallback
from the kernel to the plain version: a failed build or launch raises.

``ws_attack_fused_plain`` is written in the Pallas kernel's own
formulation (correlation, the interior, w / sum(w)), not by calling
``ops.ws.ws_attack`` (a convolution of x/255 with clipping of a weighted
sum), so a test can tell a wrong formulation from a wrong kernel.

Bound on the card: one read of B*H*W bytes plus about 2*taps + 5
operations a pixel (+38 when weighted); see ``ws_fused_cost``.
"""

import ctypes

import numpy as np
import torch

from ..utils import profiling
from .filters import NAMED_FILTERS_2D

# Launches of the CUDA kernel since the last reset (one per wrapper call
# on a CUDA tensor; calls that take the plain version do not count).
launches = 0

SOURCE = "ws_fused"
# the kernel's template argument for each filter
_FILTER_ID = {"KB": 0, "AVG": 1, "AVG9": 2, "1": 3}
# Launch constants, the same as in csrc/ws_fused.cu: the ring's stages,
# the dynamic shared memory a block may take, the rows of a band (at most
# BAND_ROWS, fewer when (rows + 2) * W would pass STAGE_TARGET bytes), and
# the cluster size (8 is portable; 16 needs the non-portable attribute
# and a card on which such a cluster fits).
STAGES = 3
SMEM_MAX = 200 * 1024
BAND_ROWS = 16
STAGE_TARGET = 12 * 1024
CLUSTER = 8
CLUSTER_WIDE = 16


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


def _stage_bytes(W: int, R: int) -> int:
    """Shared memory of one stage (``stage_bytes`` in the source): the
    band's (R + 2) * W bytes, their offset modulo 16 and the over-read of
    the last thread's 4-byte loads, rounded up to 128."""
    return -(-((R + 2) * W + 32) // 128) * 128


def _band_rows(W: int, rows: int) -> int:
    return min(BAND_ROWS, rows, max(1, STAGE_TARGET // W - 2))


def _plan(B: int, H: int, W: int, max_cluster: int = CLUSTER_WIDE) -> tuple:
    """(CL, rows per block, band rows) of one launch on [B, H, W].

    One cluster of CL blocks takes an image: 16 where the card takes such
    a cluster (``max_cluster``; ``scripts/b2_sweep.py`` times 16 ahead of 8
    at B=128 as at B=8), else 8, the portable size.  The H - 2 interior
    rows are split into contiguous runs of ``rows per block``, and CL is
    cut so that no block is empty.  A block walks its rows in bands of
    ``band rows``.  Raises ValueError for an image too wide for the ring of
    bands in shared memory."""
    n = H - 2
    cl = CLUSTER_WIDE if max_cluster >= CLUSTER_WIDE else CLUSTER
    rpb = -(-n // cl)
    cl = -(-n // rpb)
    R = _band_rows(W, rpb)
    if STAGES * _stage_bytes(W, R) + 16 > SMEM_MAX:
        raise ValueError(f"images of width {W} do not fit B2's shared "
                         "memory ring")
    return cl, rpb, R


# (device index, W) -> the largest cluster the card takes; the library
# whose entry points have their types set
_max_cluster = {}
_bound = None


def _bind_types(lib):
    """Set the types of csrc/ws_fused.cu's C entry points on ``lib``."""
    fn = lib.ws_fused_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + \
        [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ws_fused_max_cluster.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ws_fused_max_cluster.restype = ctypes.c_int
    lib.ws_fused_recip.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.ws_fused_recip.restype = ctypes.c_int
    lib.ws_fused_error_string.argtypes = [ctypes.c_int]
    lib.ws_fused_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x_u8: torch.Tensor, kernel_name: str,
            weighted: int) -> torch.Tensor:
    global launches, _bound
    from . import _cuda_build

    lib = _cuda_build.load_all(_cuda_build.SOURCES)[SOURCE]
    if lib is not _bound:
        _bound = _bind_types(lib)
    B, H, W = x_u8.shape
    out = torch.empty((B,), dtype=torch.float32, device=x_u8.device)
    if B == 0:
        return out
    with torch.cuda.device(x_u8.device):
        dev = torch.cuda.current_device()
        if (dev, W) not in _max_cluster:
            _max_cluster[dev, W] = lib.ws_fused_max_cluster(
                W, _band_rows(W, BAND_ROWS))
        cl, rpb, R = _plan(B, H, W, _max_cluster[dev, W])
        err = lib.ws_fused_launch(
            x_u8.data_ptr(), out.data_ptr(), B, H, W,
            _FILTER_ID[kernel_name], weighted, cl, rpb, R,
            1.0 / ((H - 2) * (W - 2)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"B2 launch failed: CUDA error {err} "
                           f"({lib.ws_fused_error_string(err).decode()})")
    launches += 1
    profiling.check_output(out, "B2")
    return out


def ws_attack_fused(x_u8: torch.Tensor, kernel_name: str = "KB",
                    weighted: int = 0) -> torch.Tensor:
    """Fused WS attack: uint8 [B, H, W] -> beta_hat [B] (f32).

    CUDA tensor -> the CUDA kernel; CPU tensor -> the plain version."""
    _check(x_u8, kernel_name, weighted)
    if x_u8.device.type == "cpu":
        return ws_attack_fused_plain(x_u8, kernel_name, weighted)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no B2 kernel for device {x_u8.device}")
    if not x_u8.is_contiguous():
        raise ValueError("expected a contiguous [B, H, W] tensor")
    return _launch(x_u8, kernel_name, weighted)


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
