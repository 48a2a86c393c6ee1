"""Reflect-padded 3x3 conv with bias and optional ReLU fused (kernel B1).

Replaces the Pallas TPU kernel ``wsunet_tpu/experiments/
pallas_reflect_conv.py::_forward`` (body ``_kernel``, public entry
``conv3x3_reflect_fused``) with the JAX package's layout:

    out = relu?(conv3x3(reflect_pad_1(x), w) + b)

x NHWC ``[B, H, W, C]`` contiguous, w HWIO ``[3, 3, C, Cout]``, b
``[Cout]``, all f32 or all bf16; the output is NHWC in x's dtype.

- ``conv3x3_reflect_fused`` is the wrapper.  A CUDA tensor goes to one
  of three hand-written CUDA kernels (built with nvcc at first use,
  ``_cuda_build``), a CPU tensor to the plain version; anything else
  raises.  On CUDA there is no fallback: unlike the Pallas kernel's
  ``_supported`` gate, the kernels together take every shape (C_in 1 and
  up, any H, W >= 2, any batch).
- ``conv3x3_reflect_fused_plain`` is the port of ``_reference``: reflect
  pad, VALID conv, + b, ReLU.
- The gradient is a ``torch.autograd.Function`` whose forward is the
  wrapper and whose backward is the VJP of the plain version, as the JAX
  custom VJP's ``_bwd`` is (there is no backward kernel); ``relu`` is not
  differentiable.

``_variant(C, dtype)`` picks the kernel from the input channels and the
type alone.  Each is its own C entry point; none falls back to another.
What bounds each on an H100 and what its design does about it:

- ``"wgmma"`` (bf16, C a multiple of 8, C >= 16: every ``unet_2`` layer
  but the first; ``csrc/reflect_conv3x3_wgmma.cu``).  Bound by the tensor
  cores' 2*9*C*Cout operations a pixel at C >= 128 and as much by its
  bytes at C = 64.  An implicit GEMM on wgmma: 256 output pixels (4 rows
  of 64) x 128 output channels or 512 pixels x 64 channels a block, K = 9
  taps x chunks of 16 channels; the halo tile of each chunk is copied with
  16-byte cp.async from the reflected source pixels into a four-stage
  ring, laid out so that one staged tile is the A operand of all 9 taps (a
  descriptor shift, no im2col copy).
- ``"direct"`` (every C below 16, and bf16 with C not a multiple of 8:
  the first conv, 1 -> 64; ``csrc/reflect_conv3x3.cu``).  Bound by its
  output write.  A thread reads its 9*C reflected inputs once and writes
  4 pixels x 8 channels with 16-byte stores.
- ``"fma"`` (f32, C >= 16; ``csrc/reflect_conv3x3.cu``).  Bound by the
  CUDA cores' f32 rate (TF32 stays off, as JAX pins HIGHEST).  f32 FMAs
  from shared memory, summed per output in the order (c, kh, kw), which
  matches cuDNN's f32 result bit for bit; chunks are staged with cp.async
  into a two-buffer ring, so loads overlap the FMAs.

All read each input tile once with its halo and apply the reflect
boundary as they load, so no padded copy of x is made, and add the bias
and ReLU before the one store, so the output is written once.
"""

import ctypes

import torch
import torch.nn.functional as F

from .._device import disable_tf32

# Launches of the CUDA kernels since the last reset (one per wrapper call
# on a CUDA tensor; calls that take the plain version do not count), in
# all and by variant.
launches = 0
launches_by_variant = {"wgmma": 0, "direct": 0, "fma": 0}

_DTYPES = (torch.float32, torch.bfloat16)
# (variant, dtype) -> (source csrc/<name>.cu, C entry point)
_ENTRY = {
    ("wgmma", torch.bfloat16): ("reflect_conv3x3_wgmma",
                                "reflect_conv3x3_wgmma_bf16"),
    ("direct", torch.bfloat16): ("reflect_conv3x3",
                                 "reflect_conv3x3_direct_bf16"),
    ("direct", torch.float32): ("reflect_conv3x3",
                                "reflect_conv3x3_direct_f32"),
    ("fma", torch.float32): ("reflect_conv3x3", "reflect_conv3x3_fma_f32"),
}
SOURCES = tuple(dict.fromkeys(src for src, _ in _ENTRY.values()))


def _variant(C: int, dtype: torch.dtype) -> str:
    """The kernel that takes an input of C channels of this dtype:
    ``"wgmma"`` for bf16 with C % 8 == 0 and C >= 16, ``"fma"`` for f32
    with C >= 16, ``"direct"`` for the rest (C < 16, bf16 with C % 8)."""
    if C >= 16 and dtype == torch.bfloat16 and C % 8 == 0:
        return "wgmma"
    if C >= 16 and dtype == torch.float32:
        return "fma"
    return "direct"


def reset_launches() -> None:
    global launches
    launches = 0
    for k in launches_by_variant:
        launches_by_variant[k] = 0


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"x, w and b must share one dtype, got {x.dtype}, "
                        f"{w.dtype} and {b.dtype}")
    if x.ndim != 4 or x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError(
            f"expected x NHWC [B, H, W, C] with H, W >= 2, got "
            f"{tuple(x.shape)}")
    C = x.shape[3]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, C) or \
            tuple(b.shape) != (w.shape[3],):
        raise ValueError(
            f"expected w [3, 3, {C}, Cout] and b [Cout], got "
            f"{tuple(w.shape)} and {tuple(b.shape)}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"x, w and b lie on {x.device}, {w.device} and "
                         f"{b.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("expected contiguous NHWC x, HWIO w and b")


def conv3x3_reflect_fused_plain(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor,
                                relu: bool = False) -> torch.Tensor:
    """The plain PyTorch version of B1 (``_reference``), on any device:
    NHWC in, contiguous NHWC out."""
    if x.is_cuda and x.dtype == torch.float32:
        disable_tf32()
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    out = F.conv2d(xp, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1) + b
    if relu:
        out = F.relu(out)
    return out.contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            relu: bool) -> torch.Tensor:
    global launches
    from . import _cuda_build

    B, H, W, C = x.shape
    Cout = w.shape[3]
    variant = _variant(C, x.dtype)
    source, entry = _ENTRY[variant, x.dtype]
    libs = _cuda_build.load_all(SOURCES)
    fn = getattr(libs[source], entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 B, H, W, C, Cout, int(relu),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        lib = libs["reflect_conv3x3"]
        lib.reflect_conv3x3_error_string.restype = ctypes.c_char_p
        lib.reflect_conv3x3_error_string.argtypes = [ctypes.c_int]
        msg = lib.reflect_conv3x3_error_string(err).decode()
        raise RuntimeError(
            f"B1 {variant} launch failed: CUDA error {err} ({msg})")
    launches += 1
    launches_by_variant[variant] += 1
    return out


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             relu: bool) -> torch.Tensor:
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_reflect_fused_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"no B1 kernel for device {x.device}")
    return _launch(x, w, b, relu)


class _ReflectConv3x3(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU).  Backward: the VJP
    of the plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        ctx.relu = relu
        ctx.save_for_backward(x, w, b)
        return _forward(x, w, b, relu)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in
                      zip(saved, need)]
            out = conv3x3_reflect_fused_plain(*leaves, ctx.relu)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], g))
        return (*[next(grads) if n else None for n in need], None)


def conv3x3_reflect_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          relu: bool = False) -> torch.Tensor:
    """Reflect-padded 3x3 conv (+ b, + optional ReLU) of NHWC x with HWIO
    w: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor; differentiable in x, w and b."""
    return _ReflectConv3x3.apply(x, w, b, relu)


def conv_cost(B: int, H: int, W: int, C: int, Cout: int,
              itemsize: int) -> dict:
    """Bytes and FLOPs one call needs: x, w and b read once, out written
    once; 2*9*C*Cout operations an output pixel."""
    return {"bytes": itemsize * (B * H * W * (C + Cout) + 9 * C * Cout
                                 + Cout),
            "flops": 2 * 9 * C * Cout * B * H * W}
