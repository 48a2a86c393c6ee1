"""Triton kernel for the fused WS attack (B2); see ``fused_ws``.

Replaces ``wsunet_tpu/ops/pallas_ws.py::ws_attack_fused``.  The TPU
kernel holds one whole image in VMEM and reduces it in one grid step; a
512x512 image does not fit one SM's shared memory, and Hopper's blocks
run in parallel with nothing carried between them.  So:

- pass 1, grid (B, row tiles, col tiles): each program loads the nine
  shifted uint8 tiles of its BLOCK_H x BLOCK_W output block straight
  from device memory (masked to the interior, whose neighbours are all
  in bounds; L1/L2 serve the 3x reuse), computes sign, x_hat and, when
  weighted, the local variance and w, and writes two partial sums
  (sum w*contrib, and sum w when weighted) to an f32 scratch
  [B, n_tiles, 2];
- pass 2, grid (B,): one program per image sums its partials in a fixed
  order, divides, clips at 0 and writes beta_hat.  No atomics, so the
  result is the same from run to run.

What bounds it: reading B*H*W bytes once (the scratch is 8 bytes per
1,024 pixels); the arithmetic is ~20-60 f32 operations a pixel.

``triton`` is imported here, and this module is imported by the wrapper
at its first launch on a CUDA tensor, never when the package is imported.
"""

import os
import pathlib

import torch

os.environ.setdefault(
    "TRITON_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parents[2] / "build" /
        "triton_cache"))

import triton  # noqa: E402
import triton.language as tl  # noqa: E402

BLOCK_H = 8
BLOCK_W = 128
BLOCK_T = 256


@triton.jit
def _tap(acc, v, C: tl.constexpr):
    if C != 0.0:
        acc = acc + C * v
    return acc


@triton.jit
def _ws_partials_kernel(
    x_ptr, part_ptr, H, W, n_tw, n_tiles,
    K00: tl.constexpr, K01: tl.constexpr, K02: tl.constexpr,
    K10: tl.constexpr, K11: tl.constexpr, K12: tl.constexpr,
    K20: tl.constexpr, K21: tl.constexpr, K22: tl.constexpr,
    WEIGHTED: tl.constexpr, BLOCK_H: tl.constexpr, BLOCK_W: tl.constexpr,
):
    b = tl.program_id(0)
    th = tl.program_id(1)
    tw = tl.program_id(2)
    r = th * BLOCK_H + tl.arange(0, BLOCK_H)[:, None]
    c = tw * BLOCK_W + tl.arange(0, BLOCK_W)[None, :]
    inside = (r >= 1) & (r < H - 1) & (c >= 1) & (c < W - 1)
    p = x_ptr + b.to(tl.int64) * H * W + r * W + c

    xc_u8 = tl.load(p, mask=inside, other=0)
    x00 = tl.load(p - W - 1, mask=inside, other=0).to(tl.float32)
    x01 = tl.load(p - W, mask=inside, other=0).to(tl.float32)
    x02 = tl.load(p - W + 1, mask=inside, other=0).to(tl.float32)
    x10 = tl.load(p - 1, mask=inside, other=0).to(tl.float32)
    x11 = xc_u8.to(tl.float32)
    x12 = tl.load(p + 1, mask=inside, other=0).to(tl.float32)
    x20 = tl.load(p + W - 1, mask=inside, other=0).to(tl.float32)
    x21 = tl.load(p + W, mask=inside, other=0).to(tl.float32)
    x22 = tl.load(p + W + 1, mask=inside, other=0).to(tl.float32)

    # correlation in the Pallas kernel's tap order, zero taps skipped
    zero = tl.zeros([BLOCK_H, BLOCK_W], dtype=tl.float32)
    x_hat = _tap(zero, x00, K00)
    x_hat = _tap(x_hat, x01, K01)
    x_hat = _tap(x_hat, x02, K02)
    x_hat = _tap(x_hat, x10, K10)
    x_hat = _tap(x_hat, x11, K11)
    x_hat = _tap(x_hat, x12, K12)
    x_hat = _tap(x_hat, x20, K20)
    x_hat = _tap(x_hat, x21, K21)
    x_hat = _tap(x_hat, x22, K22)

    sign = ((xc_u8.to(tl.int32) & 1) * 2 - 1).to(tl.float32)
    contrib = tl.where(inside, sign * (x11 - x_hat), 0.0)
    q = part_ptr + (b * n_tiles + th * n_tw + tw) * 2
    if WEIGHTED == 0:
        tl.store(q, tl.sum(tl.sum(contrib, axis=1), axis=0))
    else:
        mu = (x00 + x01 + x02 + x10 + x12 + x20 + x21 + x22) * 0.125
        mu2 = (x00 * x00 + x01 * x01 + x02 * x02 + x10 * x10 +
               x12 * x12 + x20 * x20 + x21 * x21 + x22 * x22) * 0.125
        var = mu2 - mu * mu
        if WEIGHTED == 1:
            w = 1.0 / (5.0 + var)
        else:
            w = 5.0 + var
        w = tl.where(inside, w, 0.0)
        tl.store(q, tl.sum(tl.sum(w * contrib, axis=1), axis=0))
        tl.store(q + 1, tl.sum(tl.sum(w, axis=1), axis=0))


@triton.jit
def _ws_finish_kernel(part_ptr, out_ptr, n_tiles, inv_n,
                      WEIGHTED: tl.constexpr, BLOCK_T: tl.constexpr):
    b = tl.program_id(0)
    num = tl.zeros([BLOCK_T], dtype=tl.float32)
    den = tl.zeros([BLOCK_T], dtype=tl.float32)
    for start in range(0, n_tiles, BLOCK_T):
        t = start + tl.arange(0, BLOCK_T)
        m = t < n_tiles
        q = part_ptr + (b * n_tiles + t) * 2
        num += tl.load(q, mask=m, other=0.0)
        if WEIGHTED != 0:
            den += tl.load(q + 1, mask=m, other=0.0)
    if WEIGHTED == 0:
        beta = tl.sum(num, axis=0) * inv_n
    else:
        beta = tl.sum(num, axis=0) / tl.sum(den, axis=0)
    tl.store(out_ptr + b, tl.maximum(beta, 0.0))


def launch(x_u8: torch.Tensor, kernel, weighted: int) -> torch.Tensor:
    """Run both passes on a contiguous CUDA uint8 [B, H, W] tensor (the
    wrapper in ``fused_ws`` has checked it) -> f32 [B]."""
    B, H, W = x_u8.shape
    n_th = triton.cdiv(H, BLOCK_H)
    n_tw = triton.cdiv(W, BLOCK_W)
    n_tiles = n_th * n_tw
    part = torch.empty((B, n_tiles, 2), dtype=torch.float32,
                       device=x_u8.device)
    out = torch.empty((B,), dtype=torch.float32, device=x_u8.device)
    k = [float(v) for v in kernel.reshape(-1)]
    _ws_partials_kernel[(B, n_th, n_tw)](
        x_u8, part, H, W, n_tw, n_tiles, *k,
        WEIGHTED=weighted, BLOCK_H=BLOCK_H, BLOCK_W=BLOCK_W, num_warps=4)
    _ws_finish_kernel[(B,)](
        part, out, n_tiles, 1.0 / ((H - 2) * (W - 2)),
        WEIGHTED=weighted, BLOCK_T=BLOCK_T, num_warps=4)
    return out
