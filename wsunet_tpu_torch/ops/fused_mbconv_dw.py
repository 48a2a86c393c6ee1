"""The depthwise stage of an EfficientNet-B0 MBConv block in one pass
(kernel B3), f32 NCHW:

    a = silu(bn_exp(x))                       # the prologue, if any
    y = silu(bn_dw(dwconv_k,s(pad_SAME(a))))  # [B, C, Ho, Wo]
    s = sum over (Ho, Wo) of y                # [B, C]

x is the raw output of the block's expand 1x1 conv (stage 0 has no
expand: there x is the block's input, already activated, and there is no
prologue), w the depthwise taps [C, 1, k, k] (k 3 or 5, stride 1 or 2).
Both norms are eval-mode batch norms (``BatchNormStats``: weight, bias,
running mean and variance, eps).  Padding is TensorFlow's SAME, as
``models.b0._same_pad`` and ``_Conv`` pad: ceil(size / stride) outputs,
the odd pixel of the padding after; padded taps are 0 after the prologue.

The JAX package has no Pallas kernel for B0 (XLA fuses this middle on the
TPU); B3 replaces none.  It was added because PyTorch runs it as seven
passes over device memory, which no library kernel fuses.

- ``mbconv_dw`` is the wrapper.  A CUDA tensor goes to the hand-written
  CUDA kernel ``csrc/mbconv_dw.cu`` (built with nvcc at first use with the
  other kernels, ``_cuda_build``, and loaded with ctypes): one launch a
  call, the launch plan from ``_plan``.  A CPU tensor goes to the plain
  version; anything else raises.  There is no fallback from the kernel to
  the plain version.  The gradient is the VJP of the plain version (there
  is no backward kernel: B3 serves eval-mode forwards).
- ``mbconv_dw_plain`` is the same function in plain PyTorch, written from
  the raw statistics (scale and shift, as the kernel computes them), not
  by calling the model's modules, so a test can tell a wrong formulation
  from a wrong kernel.
- ``mbconv_dw_cost``: the bytes a call needs; B3 is bound by them (about
  6 operations a byte against the card's f32 ridge near 20).

``models.b0._MBConv`` routes its depthwise stage here in eval mode, with
batch norm, on an f32 CUDA tensor, and counts ``b0.dw_kernel.hit`` /
``.miss`` (``utils.profiling``).
"""

import ctypes
import typing

import torch
import torch.nn.functional as F

from .._device import disable_tf32
from ..utils import profiling

# Launches of the CUDA kernel since the last reset (one per wrapper call
# on a CUDA tensor; calls that take the plain version do not count).
launches = 0

SOURCE = "mbconv_dw"
# Launch constants, the same as in csrc/mbconv_dw.cu: threads a block, the
# tiles whose copies are in flight while one is computed, the ring column
# of input column 0, the planes a block may take, the portable cluster
# size.
THREADS = 256
DEPTH = 1
OFF = 4
JOBS_MAX = 16
CLUSTER = 8
# The plan's targets (timed by scripts/b3_sweep.py): output items (4
# columns of a row) a tile, the shared memory of a block's ring (3 blocks
# an SM), the blocks a launch should have before a plane is split into
# bands (4 waves of 132 SMs at 8 blocks each), the blocks that fill the
# card once, and the tiles a block should walk so that copies are in
# flight while it computes.
ITEMS = 4 * THREADS
SMEM_TARGET = 72 * 1024
MIN_BLOCKS = 4096
FULL_BLOCKS = 132 * 8
MIN_TILES = 8


class BatchNormStats(typing.NamedTuple):
    """An eval-mode batch norm: y = (x - mean) / sqrt(var + eps) * weight
    + bias, per channel."""
    weight: torch.Tensor
    bias: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    eps: float


def reset_launches() -> None:
    global launches
    launches = 0


def same_pads(size: int, k: int, stride: int) -> tuple:
    """(before, after) of TensorFlow's SAME padding of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _ring_bytes(W: int, k: int, stride: int, tr: int) -> int:
    """Shared memory of a block's ring of input rows (``launch`` in the
    source): room for DEPTH + 1 tiles of (tr - 1) * stride + k rows, each
    row input column 0 at OFF, wide enough for the last output item's
    window."""
    padl = same_pads(W, k, stride)[0]
    base = (OFF - padl) & ~3
    nv = (OFF - padl - base + 3 * stride + k + 3) // 4
    q = -(-(-(-W // stride)) // 4)
    rs = -(-max(OFF + W, base + 4 * (q - 1) * stride + 4 * nv) // 4) * 4
    return 4 * rs * (DEPTH + 1) * ((tr - 1) * stride + k)


def _plan(B: int, C: int, H: int, W: int, k: int, stride: int) -> tuple:
    """(tile rows, cluster size, planes a block) of one launch.

    A tile takes at most as many output rows as make ``ITEMS`` 4-column
    items, at most the plane's, and fewer while the ring would pass
    ``SMEM_TARGET``; within that, the plane's tiles are made even in
    size.  A plane is split into the bands of a cluster of 2,
    4 or 8 blocks while the launch has fewer than ``MIN_BLOCKS`` blocks
    and each band keeps two tiles or more; an unsplit block takes 2, 4, ...
    ``JOBS_MAX`` whole planes while it has fewer than ``MIN_TILES`` tiles
    and the launch keeps twice ``FULL_BLOCKS`` blocks.  Planes too wide for
    a one-row tile's ring make the launch fail."""
    Ho, Wo = -(-H // stride), -(-W // stride)
    most = min(Ho, -(-ITEMS // -(-Wo // 4)))
    while most > 1 and _ring_bytes(W, k, stride, most) > SMEM_TARGET:
        most -= 1
    tr = -(-Ho // -(-Ho // most))     # the plane's tiles evened out
    planes = B * C
    cl = 1
    while cl < CLUSTER and planes * cl < MIN_BLOCKS and \
            -(-Ho // (2 * cl)) >= 2 * tr:
        cl *= 2
    jobs, tiles = 1, -(-Ho // tr)
    while cl == 1 and jobs < JOBS_MAX and jobs * tiles < MIN_TILES and \
            planes >= 2 * jobs * FULL_BLOCKS:
        jobs *= 2
    return tr, cl, jobs


def _check(x: torch.Tensor, w: torch.Tensor, dw_norm: BatchNormStats,
           exp_norm, stride: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected x [B, C, H, W], got {tuple(x.shape)}")
    C = x.shape[1]
    if w.ndim != 4 or w.shape[0] != C or w.shape[1] != 1 or \
            w.shape[2] != w.shape[3] or w.shape[2] not in (3, 5):
        raise ValueError(f"expected w [{C}, 1, k, k] with k 3 or 5, got "
                         f"{tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride!r}")
    tensors = [w, *dw_norm[:4]] + ([] if exp_norm is None else
                                   list(exp_norm[:4]))
    for t in tensors[1:]:
        if tuple(t.shape) != (C,):
            raise ValueError(f"expected norm vectors [{C}], got "
                             f"{tuple(t.shape)}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 taps and norms, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"x lies on {x.device}, a parameter on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous taps and norm vectors")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous NCHW x")


def _scale_shift(n: BatchNormStats) -> tuple:
    """[C, 1, 1] scale and shift: (1 / sqrt(var + eps)) * weight and
    bias - mean * scale, as the kernel computes them."""
    scale = (1.0 / torch.sqrt(n.var + n.eps)) * n.weight
    shift = n.bias - n.mean * scale
    return scale[:, None, None], shift[:, None, None]


def mbconv_dw_plain(x: torch.Tensor, w: torch.Tensor,
                    dw_norm: BatchNormStats,
                    exp_norm: BatchNormStats = None,
                    stride: int = 1) -> tuple:
    """The plain PyTorch version of B3, on any device: (y [B, C, Ho, Wo],
    s [B, C])."""
    if x.is_cuda and x.dtype == torch.float32:
        disable_tf32()
    if exp_norm is not None:
        scale, shift = _scale_shift(exp_norm)
        x = F.silu(x * scale + shift)
    k = w.shape[-1]
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, stride),
                                    same_pads(x.shape[3], k, stride))
    z = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride,
                 groups=x.shape[1])
    scale, shift = _scale_shift(dw_norm)
    y = F.silu(z * scale + shift)
    return y, y.sum(dim=(2, 3))


def _launch(x: torch.Tensor, w: torch.Tensor, dw_norm: BatchNormStats,
            exp_norm, stride: int) -> tuple:
    global launches
    from . import _cuda_build

    lib = _cuda_build.load_all(_cuda_build.SOURCES)[SOURCE]
    fn = lib.mbconv_dw_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float] + \
        [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2 + \
        [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, C, H, W = x.shape
    k = w.shape[-1]
    Ho, Wo = -(-H // stride), -(-W // stride)
    y = torch.empty((B, C, Ho, Wo), dtype=x.dtype, device=x.device)
    s = torch.empty((B, C), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y, s.zero_()
    tr, cl, jobs = _plan(B, C, H, W, k, stride)
    exp_ptrs = [None] * 4 if exp_norm is None else \
        [t.data_ptr() for t in exp_norm[:4]]
    exp_eps = 0.0 if exp_norm is None else exp_norm.eps
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), *exp_ptrs, exp_eps,
                 *[t.data_ptr() for t in dw_norm[:4]], dw_norm.eps,
                 y.data_ptr(), s.data_ptr(), B, C, H, W, k, stride, tr, cl,
                 jobs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        lib.mbconv_dw_error_string.restype = ctypes.c_char_p
        lib.mbconv_dw_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"B3 launch failed: CUDA error {err} "
                           f"({lib.mbconv_dw_error_string(err).decode()})")
    launches += 1
    profiling.check_output(y, "B3")
    return y, s


def _forward(x, w, dw_norm, exp_norm, stride) -> tuple:
    _check(x, w, dw_norm, exp_norm, stride)
    if x.device.type == "cpu":
        return mbconv_dw_plain(x, w, dw_norm, exp_norm, stride)
    if x.device.type != "cuda":
        raise ValueError(f"no B3 kernel for device {x.device}")
    return _launch(x, w, dw_norm, exp_norm, stride)


class _MBConvDW(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU).  Backward: the VJP
    of the plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, stride, dw_eps, exp_eps, *vectors):
        ctx.stride, ctx.eps = stride, (dw_eps, exp_eps)
        ctx.save_for_backward(x, w, *vectors)
        return _forward(x, w, *_norms(vectors, dw_eps, exp_eps), stride)

    @staticmethod
    def backward(ctx, gy, gs):
        saved = ctx.saved_tensors
        need = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                *ctx.needs_input_grad[5:]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in
                      zip(saved, need)]
            x, w, *vectors = leaves
            y, s = mbconv_dw_plain(x, w, *_norms(vectors, *ctx.eps),
                                   ctx.stride)
            grads = iter(torch.autograd.grad(
                (y, s), [t for t, n in zip(leaves, need) if n], (gy, gs),
                allow_unused=True))
        got = [next(grads) if n else None for n in need]
        return (got[0], got[1], None, None, None, *got[2:])


def _norms(vectors, dw_eps, exp_eps) -> tuple:
    dw = BatchNormStats(*vectors[:4], dw_eps)
    exp = BatchNormStats(*vectors[4:], exp_eps) if len(vectors) > 4 else None
    return dw, exp


def mbconv_dw(x: torch.Tensor, w: torch.Tensor, dw_norm: BatchNormStats,
              exp_norm: BatchNormStats = None, stride: int = 1) -> tuple:
    """(y, s) of the MBConv depthwise stage: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor; differentiable in x, w and
    the norms' tensors."""
    if not torch.is_grad_enabled():
        return _forward(x, w, dw_norm, exp_norm, stride)
    vectors = [*dw_norm[:4], *([] if exp_norm is None else exp_norm[:4])]
    return _MBConvDW.apply(x, w, stride, dw_norm.eps,
                           None if exp_norm is None else exp_norm.eps,
                           *vectors)


def mbconv_dw_cost(B: int, C: int, H: int, W: int, k: int, stride: int,
                   prologue: bool) -> dict:
    """The bytes one call needs, f32: x read once, y and the sums written
    once, the k*k taps and the 4 vectors of each norm read once."""
    Ho, Wo = -(-H // stride), -(-W // stride)
    norms = 8 if prologue else 4
    return {"bytes": 4 * (B * C * H * W + B * C * Ho * Wo + k * k * C
                          + norms * C + B * C)}
