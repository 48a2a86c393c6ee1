"""Reflect-padded 3x3 conv as a zero-padded SAME conv plus exact border
corrections (port of ``wsunet_tpu/ops/reflect_conv.py``); plain PyTorch.

A reflect conv differs from a zero-padded conv only through the ghost
cells, which touch a 1-px output border:

  row -1 == row 1, row H == row H-2, col -1 == col 1, col W == col W-2
  (corners reflect both axes: (-1,-1) == (1,1), ...)

So out = conv_SAME(x) + corrections on out[0,:], out[H-1,:], out[:,0],
out[:,W-1].  Top/bottom corrections are 1-D convs of rows 1 / H-2 with
kernel rows w[0] / w[2] over the reflect-extended W axis (these also carry
the corner ghosts); left/right corrections use cols 1 / W-2 with kernel
cols w[:,0] / w[:,2] over real rows only (zero-padded row windows, so the
corners are not counted twice).  The four corrections go in as one add of
zero-padded strips.

Layout as in the JAX package: x NHWC, w HWIO, b [Cout]; the output is
NHWC.  On CUDA the f32 conv runs with TF32 off.
"""

import torch
import torch.nn.functional as F

from .._device import disable_tf32


def _win3(v: torch.Tensor) -> torch.Tensor:
    """(B, N + 2, C) -> (B, N, 3, C): the three 1-shifted windows of an
    axis already padded by one element on each side."""
    n = v.shape[1] - 2
    return torch.stack([v[:, d:d + n] for d in range(3)], dim=-2)


def conv3x3_reflect_borderfix(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor,
                              relu: bool = False) -> torch.Tensor:
    """NHWC reflect-padded 3x3 conv without materialising the pad."""
    if x.is_cuda and x.dtype == torch.float32:
        disable_tf32()
    _, H, W, _ = x.shape
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1) + b

    def row_corr(row, krow):  # row (B, W, C), krow (3, C, Cout)
        ext = torch.cat([row[:, 1:2], row, row[:, W - 2:W - 1]], dim=1)
        return torch.einsum("bwdc,dco->bwo", _win3(ext), krow)

    def col_corr(colv, kcol):  # colv (B, H, C), kcol (3, C, Cout)
        ext = F.pad(colv, (0, 0, 1, 1))
        return torch.einsum("bhdc,dco->bho", _win3(ext), kcol)

    top = row_corr(x[:, 1], w[0])
    bottom = row_corr(x[:, H - 2], w[2])
    left = col_corr(x[:, :, 1], w[:, 0])
    right = col_corr(x[:, :, W - 2], w[:, 2])
    corr = (F.pad(top[:, None], (0, 0, 0, 0, 0, H - 1)) +
            F.pad(bottom[:, None], (0, 0, 0, 0, H - 1, 0)) +
            F.pad(left[:, :, None], (0, 0, 0, W - 1)) +
            F.pad(right[:, :, None], (0, 0, W - 1, 0)))
    out = out + corr
    return F.relu(out) if relu else out
