"""The middle of Restormer's gated depthwise feed-forward (GDFN) in one
pass (kernel B4), f32 NCHW:

    y[b, j] = gelu(dw3x3(u[b, j], w[j])) * dw3x3(u[b, h + j], w[h + j])

for j < h.  u [B, 2h, H, W] is the block's ``project_in`` output, w
[2h, 1, 3, 3] its ``dwconv`` taps; the conv pads one row and column of
zeros, stride 1; the GELU is the exact (erf) one.  y [B, h, H, W] is what
``project_out`` reads.

The JAX package has no Restormer, so B4 replaces no TPU kernel.  It was
added because PyTorch runs this middle as four passes over device memory
(a library depthwise conv over 2h channels, then the GELU and the product
on the strided halves that ``chunk`` leaves), which no library kernel
fuses.

- ``gdfn_gate`` is the wrapper.  A CUDA tensor goes to the hand-written
  CUDA kernel ``csrc/gdfn_gate.cu`` (built with nvcc at first use with the
  other kernels, ``_cuda_build``, and loaded with ctypes): one launch a
  call, the launch plan from ``_plan``.  A CPU tensor goes to the plain
  version; anything else raises.  There is no fallback from the kernel to
  the plain version.  The gradient is the VJP of the plain version (there
  is no backward kernel: B4 serves eval-mode forwards).
- ``gdfn_gate_plain`` is the same function in plain PyTorch: the grouped
  conv, ``chunk`` and exact ``F.gelu``, as ``models.restormer.FeedForward``
  ran it before B4.
- ``gdfn_gate_cost``: the bytes a call needs; B4 is bound by them (18
  FMAs and an erff an output against 12 bytes).

The kernel loads rows with TMA, whose row pitch is a multiple of 16
bytes.  A u whose width is not a multiple of 4, or whose base is not
16-byte aligned, is first copied with zero columns on its right up to
the next multiple of 4 (``_padded``), and y cropped back: the conv pads
with zeros there anyway, so the outputs are the same.  At 512^2 every
level's width is a multiple of 4 and no copy is made.

``models.restormer.FeedForward`` routes its middle here in eval mode on
an f32 CUDA tensor, and counts ``restormer.gdfn_kernel.hit`` / ``.miss``
(``utils.profiling``).
"""

import ctypes

import torch
import torch.nn.functional as F

from .._device import disable_tf32
from ..utils import profiling

# Launches of the CUDA kernel since the last reset (one per wrapper call
# on a CUDA tensor; calls that take the plain version do not count).
launches = 0

SOURCE = "gdfn_gate"
# Launch constants, the same as in csrc/gdfn_gate.cu: threads a block,
# output rows a thread slides down, the widest tile, the most threads down
# a column of a tile.
THREADS = 128
RS = 4
TW_MAX = 128
S_MAX = 16


def reset_launches() -> None:
    global launches
    launches = 0


def _plan(W: int) -> tuple:
    """(tw, rows): a tile's output columns and rows.  A tile is as wide as
    the plane up to ``TW_MAX`` columns, a thread to every 4 of them; the
    block's other threads go down the tile, ``RS`` rows each, so a tile
    holds ``RS * min(THREADS // (tw // 4), S_MAX)`` rows.  The kernel
    walks a plane's tiles column tile by column tile, band by band, the
    last of each ragged where H or W is not a multiple."""
    tw = min(TW_MAX, W)
    return tw, RS * min(THREADS // (tw // 4), S_MAX)


def _check(u: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what neither version takes: the kernel takes float32, the
    plain version on the CPU float64 too (for gradcheck)."""
    if u.dtype != torch.float32 and not (u.dtype == torch.float64
                                         and u.device.type == "cpu"):
        raise TypeError(f"expected float32, got {u.dtype} on {u.device}")
    if u.ndim != 4 or u.shape[1] % 2:
        raise ValueError(f"expected u [B, 2h, H, W], got {tuple(u.shape)}")
    C = u.shape[1]
    if tuple(w.shape) != (C, 1, 3, 3):
        raise ValueError(f"expected w [{C}, 1, 3, 3], got {tuple(w.shape)}")
    if w.dtype != u.dtype:
        raise TypeError(f"expected {u.dtype} taps, got {w.dtype}")
    if w.device != u.device:
        raise ValueError(f"u lies on {u.device}, w on {w.device}")
    if not (u.is_contiguous() and w.is_contiguous()):
        raise ValueError("expected a contiguous NCHW u and contiguous taps")


def gdfn_gate_plain(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of B4, on any device: y [B, h, H, W]."""
    if u.is_cuda and u.dtype == torch.float32:
        disable_tf32()
    x1, x2 = F.conv2d(u, w, padding=1, groups=u.shape[1]).chunk(2, dim=1)
    return F.gelu(x1) * x2


def _padded(u: torch.Tensor) -> torch.Tensor:
    """u if its width is a multiple of 4 and its base 16-byte aligned;
    else a fresh (aligned) copy with zero columns on the right up to the
    next multiple of 4."""
    pad = -u.shape[-1] % 4
    if pad == 0 and u.data_ptr() % 16 == 0:
        return u
    return F.pad(u, (0, pad)) if pad else u.clone()


def _launch(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    from . import _cuda_build

    B, C, H, W = u.shape
    h = C // 2
    if u.numel() == 0:
        return u.new_empty((B, h, H, W))
    u = _padded(u)
    Wp = u.shape[-1]
    lib = _cuda_build.load_all(_cuda_build.SOURCES)[SOURCE]
    fn = lib.gdfn_gate_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty((B, h, H, Wp), dtype=u.dtype, device=u.device)
    tw, rows = _plan(Wp)
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), w.data_ptr(), y.data_ptr(), B, h, H, Wp, tw,
                 rows, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        lib.gdfn_gate_error_string.restype = ctypes.c_char_p
        lib.gdfn_gate_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"B4 launch failed: error {err} "
                           f"({lib.gdfn_gate_error_string(err).decode()})")
    launches += 1
    if Wp != W:
        y = y[..., :W].contiguous()
    profiling.check_output(y, "B4")
    return y


def _forward(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(u, w)
    if u.device.type == "cpu":
        return gdfn_gate_plain(u, w)
    if u.device.type != "cuda":
        raise ValueError(f"no B4 kernel for device {u.device}")
    return _launch(u, w)


class _GdfnGate(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU).  Backward: the VJP
    of the plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, u, w):
        ctx.save_for_backward(u, w)
        return _forward(u, w)

    @staticmethod
    def backward(ctx, gy):
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            y = gdfn_gate_plain(*leaves)
            grads = iter(torch.autograd.grad(
                y, [t for t, n in zip(leaves, need) if n], gy))
        return tuple(next(grads) if n else None for n in need)


def gdfn_gate(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y of the GDFN's middle: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor; differentiable in u and w."""
    if not torch.is_grad_enabled():
        return _forward(u, w)
    return _GdfnGate.apply(u, w)


def gdfn_gate_cost(B: int, h: int, H: int, W: int) -> dict:
    """The bytes one call needs, f32: u read once, y written once, the 9
    taps of each of the 2h channels read once."""
    return {"bytes": 4 * (B * 3 * h * H * W + 2 * h * 9)}
