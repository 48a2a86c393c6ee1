"""Reflect-padded 3x3 conv with bias and optional ReLU fused (kernel B1).

Replaces the Pallas TPU kernel ``wsunet_tpu/experiments/
pallas_reflect_conv.py::_forward`` (body ``_kernel``, public entry
``conv3x3_reflect_fused``) with the JAX package's layout:

    out = relu?(conv3x3(reflect_pad_1(x), w) + b)

x NHWC ``[B, H, W, C]`` contiguous, w HWIO ``[3, 3, C, Cout]``, b
``[Cout]``, all f32 or all bf16; the output is NHWC in x's dtype.

- ``conv3x3_reflect_fused`` is the wrapper.  A CUDA tensor goes to the
  hand-written CUDA kernel ``csrc/reflect_conv3x3.cu`` (built with nvcc at
  first use, ``_cuda_build``), a CPU tensor to the plain version; anything
  else raises.  On CUDA there is no fallback: unlike the Pallas kernel's
  ``_supported`` gate, the CUDA kernel takes every shape (C_in 1 and up,
  any H, W >= 2, any batch).
- ``conv3x3_reflect_fused_plain`` is the port of ``_reference``: reflect
  pad, VALID conv, + b, ReLU.
- The gradient is a ``torch.autograd.Function`` whose forward is the
  wrapper and whose backward is the VJP of the plain version, as the JAX
  custom VJP's ``_bwd`` is (there is no backward kernel); ``relu`` is not
  differentiable.

What bounds the kernel on an H100 and what its design does about it:
the bytes of one read of x and one write of out, and 2*9*C*Cout
operations a pixel.  The kernel reads each input tile once with its halo
and applies the reflect boundary as it loads, so no padded copy of x is
made, and adds the bias and ReLU before the one store, so the output is
written once.  Its products run on CUDA cores in f32 from shared memory;
tensor cores (wgmma) and TMA-staged tiles are what would bring the bf16
version near its bound.
"""

import ctypes

import torch
import torch.nn.functional as F

from .._device import disable_tf32

# Launches of the CUDA kernel since the last reset (one per wrapper call
# on a CUDA tensor; calls that take the plain version do not count).
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {torch.float32: "reflect_conv3x3_f32",
          torch.bfloat16: "reflect_conv3x3_bf16"}


def reset_launches() -> None:
    global launches
    launches = 0


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

    lib = _cuda_build.load("reflect_conv3x3")
    fn = getattr(lib, _ENTRY[x.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, W, C = x.shape
    Cout = w.shape[3]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 B, H, W, C, Cout, int(relu),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        lib.reflect_conv3x3_error_string.restype = ctypes.c_char_p
        lib.reflect_conv3x3_error_string.argtypes = [ctypes.c_int]
        msg = lib.reflect_conv3x3_error_string(err).decode()
        raise RuntimeError(f"B1 launch failed: CUDA error {err} ({msg})")
    launches += 1
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
